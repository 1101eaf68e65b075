"""Fleet fitting: many independent sparse models in one driver
(counterpart of ``repro.core.fleet``).

The production shape of this workload is fleets: per-user models, sparse
probes per layer and task of a language model, per-SKU demand models.
Each problem alone is far too small to fill a GPU. This module steps B
independent problems that share a shape signature ``(N, m, n, K)``
together:

* :func:`fit_many_stacked` — stacked data ``As (B, N, m, n)`` /
  ``bs (B, N, m)`` with per-problem ``kappa`` / ``gamma`` / ``rho_c``, one
  masked loop over a lane-batched step (``BiCADMM._run_while_fleet``): the
  loop runs while any lane is active and a lane that is not keeps its whole
  state, as the JAX package's vmapped ``while_loop`` keeps it. Each outer
  iteration's projections are one launch for every lane on the card
  (``kernels.bisect_proj.l1_epigraph_proj_lanes`` /
  ``skappa_support_lanes``); the nodes of every lane are the x-update
  kernels' batch, on the (B N, m, n) view of ``As`` (no copy). On the CPU
  each lane equals a solo fit of its problem in iteration count and
  support; on the card the batched products sum in other orders than solo
  ones, and a lane stays within the solo fit's band.
* :func:`bucket_problems` / :func:`fit_many` — a heterogeneous list of
  problems grouped by ``(N, n)`` signature and right-padded along the
  sample axis with zero rows to the largest ``m`` of its bucket. Zero rows
  are exact in exact arithmetic (a padded row has A-row 0 and label 0, so
  ``A^T (.)`` annihilates its loss gradient and ``A^T A`` / ``A^T b`` do
  not change); the summed ``train_loss`` picks up ``l(0, 0)`` per padded
  row, which :func:`corrected_train_losses` subtracts.

Per-problem hyperparameters follow the JAX package's rounding
(``_fleet_params``): homogeneous penalties are the config's, folded in
Python doubles as a solo fit folds them, and the squared loss keeps the
static (Cholesky) factors; per-problem ``gamma`` / ``rho_c`` are formed in
the data dtype, as a solo ``run_from`` with tensor overrides forms them,
and take the spectral (eigh) factors. Per-problem ``kappa`` is always a
tensor on the data's device: the lane kernels read it there. The
feature-split sub-solver bakes its penalties into per-block factors and is
refused in fleet mode (``ValueError``). The fleet takes float32 data.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .bicadmm import BiCADMM, BiCADMMState, SolveParams
from .path import _point_outputs
from .results import FitResult, FleetResult, mark_aborted
from ..runtime import CapabilityError


# --------------------------------------------------------------------------
# per-problem hyperparameter grids
# --------------------------------------------------------------------------
def _fleet_grids(solver: BiCADMM, B: int, kappas, gammas, rho_cs, dtype,
                 device):
    """The three (B,) per-problem hyperparameter vectors on ``device`` in
    ``dtype`` (the config fills what the caller did not vary), and whether
    the penalties vary (=> the spectral factors)."""
    cfg = solver.cfg
    dyn = gammas is not None or rho_cs is not None

    def fill(vals, default, name):
        arr = (torch.full((B,), default, dtype=dtype, device=device)
               if vals is None
               else torch.as_tensor(vals).to(device=device, dtype=dtype))
        if tuple(arr.shape) != (B,):
            raise ValueError(f"{name} must be a (B,) = ({B},) vector, got "
                             f"shape {tuple(arr.shape)}")
        return arr

    return (fill(kappas, cfg.kappa, "kappas"),
            fill(gammas, cfg.gamma, "gammas"),
            fill(rho_cs, cfg.rho_c, "rho_cs"), dyn)


def _fleet_params(solver: BiCADMM, N: int, kaps, gams, rhos,
                  dyn: bool) -> SolveParams:
    """Per-lane :class:`SolveParams`: homogeneous penalties as the config's
    Python numbers (one value for every lane), varied ones as (B,) tensors
    formed in the grid dtype (``rho_b = alpha rho_c``,
    ``sigma = 1 / (N gamma)``)."""
    cfg = solver.cfg
    if not dyn:
        return SolveParams(kappa=kaps, rho_c=cfg.rho_c, rho_b=cfg.rho_b_eff,
                           sigma=1.0 / (N * cfg.gamma))
    rho_b = (torch.full_like(rhos, cfg.rho_b) if cfg.rho_b is not None
             else cfg.alpha * rhos)
    return SolveParams(kappa=kaps, rho_c=rhos, rho_b=rho_b,
                       sigma=1.0 / (N * gams))


# --------------------------------------------------------------------------
# batched setup / state
# --------------------------------------------------------------------------
def _fleet_setup(solver: BiCADMM, As, bs, dyn: bool):
    """The x-update factors of every problem's nodes, set up once on the
    (B N, m, n) view and cached on the data tensors' identity, as
    ``BiCADMM._setup`` caches a solo fit's (warm refits factorize once)."""
    cfg = solver.cfg
    B, N, m, n = As.shape
    if cfg.use_feature_split:
        raise ValueError(
            "the fleet driver does not support the feature-split "
            "sub-solver (stacked inner-ADMM state and penalty-baked "
            "per-block factors); use n_feature_blocks=1")
    key = ("fleet", id(As), id(bs), tuple(As.shape), tuple(bs.shape),
           str(As.dtype), str(As.device), bool(dyn))
    hit = solver._setup_cache.get(key)
    if hit is not None:
        return hit[-1]
    if solver.loss.name == "squared":
        eng = solver._x_engine(m, n, dyn)
        factors = eng.setup(As.reshape(B * N, m, n), bs.reshape(B * N, m),
                            1.0 / (N * cfg.gamma), cfg.rho_c)
    else:
        factors = None
    if len(solver._setup_cache) >= solver._SETUP_CACHE_MAX:
        solver._setup_cache.pop(next(iter(solver._setup_cache)))
    solver._setup_cache[key] = (As, bs, factors)
    return factors


def init_fleet_state(solver: BiCADMM, B: int, N: int, n: int,
                     dtype=torch.float32, device="cpu") -> BiCADMMState:
    """A zero state with a leading lane axis B: every lane is
    ``BiCADMM.init_state``'s zero state."""
    d = n * solver.loss.n_classes
    kw = dict(dtype=dtype, device=device)
    inf = float("inf")
    return BiCADMMState(
        x=torch.zeros((B, N, d), **kw), u=torch.zeros((B, N, d), **kw),
        z=torch.zeros((B, d), **kw), t=torch.zeros((B,), **kw),
        s=torch.zeros((B, d), **kw), v=torch.zeros((B,), **kw),
        k=torch.zeros((B,), dtype=torch.int32, device=device),
        p_r=torch.full((B,), inf, **kw), d_r=torch.full((B,), inf, **kw),
        b_r=torch.full((B,), inf, **kw), inner=None)


def zero_lane_state(solver: BiCADMM, N: int, n: int, dtype=torch.float32,
                    device="cpu") -> BiCADMMState:
    """A solo-shaped zero state: the cold lane of a mixed warm / cold stack
    (:func:`stack_states`)."""
    st = init_fleet_state(solver, 1, N, n, dtype, device)
    return BiCADMMState(*(None if f is None else f[0] for f in st))


def stack_states(states) -> BiCADMMState:
    """B solo-shaped states stacked into one fleet state (lane axis 0) —
    the inverse of ``FleetResult[i].state``."""
    states = list(states)
    return BiCADMMState(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*states)))


def reset_fleet_for_resume(st: BiCADMMState) -> BiCADMMState:
    """Every lane's counter to 0 and residuals to inf (fresh tensors); the
    iterates are kept for the warm refit."""
    B = st.z.shape[0]
    kw = dict(dtype=st.z.dtype, device=st.z.device)
    inf = float("inf")
    return st._replace(k=torch.zeros((B,), dtype=torch.int32,
                                     device=st.z.device),
                       p_r=torch.full((B,), inf, **kw),
                       d_r=torch.full((B,), inf, **kw),
                       b_r=torch.full((B,), inf, **kw))


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------
def fit_many_stacked(solver: BiCADMM, As, bs, *, kappas=None, gammas=None,
                     rho_cs=None, states: BiCADMMState | None = None,
                     iter_caps=None) -> FleetResult:
    """Fit B stacked problems ``As (B, N, m, n)`` / ``bs (B, N, m)`` (float32
    tensors; the fit runs where they lie) with per-problem
    hyperparameters and per-problem convergence.

    ``kappas`` / ``gammas`` / ``rho_cs`` are optional (B,) vectors; the
    config fills the rest. ``states`` warm-starts every lane from a
    previous :class:`FleetResult`'s ``.state`` (counters and residuals
    reset, iterates kept). ``iter_caps`` is an optional (B,) int vector of
    per-lane iteration budgets below ``max_iter``: a capped-out lane ends
    ``ABORTED`` with its iterate so far, and a cap of 0 is an inert padding
    lane that never steps.
    """
    As, bs = torch.as_tensor(As), torch.as_tensor(bs)
    if As.ndim != 4:
        raise ValueError(f"As must be (B, N, m, n); got shape "
                         f"{tuple(As.shape)}")
    if As.dtype != torch.float32:
        raise CapabilityError(f"the fleet takes float32 data, got "
                              f"{As.dtype}")
    B, N, m, n = As.shape
    bs = bs.reshape(B, N, m).to(As.device, As.dtype)
    kaps, gams, rhos, dyn = _fleet_grids(solver, B, kappas, gammas, rho_cs,
                                         As.dtype, As.device)
    if iter_caps is not None:
        iter_caps = torch.as_tensor(iter_caps).to(As.device, torch.int32)
        if tuple(iter_caps.shape) != (B,):
            raise ValueError(f"iter_caps must be a (B,) = ({B},) vector, "
                             f"got shape {tuple(iter_caps.shape)}")
    factors = _fleet_setup(solver, As, bs, dyn)
    params = _fleet_params(solver, N, kaps, gams, rhos, dyn)
    d = n * solver.loss.n_classes
    if states is None:
        st0 = init_fleet_state(solver, B, N, n, As.dtype, As.device)
    else:
        if tuple(states.x.shape) != (B, N, d):
            raise ValueError(f"states hold x of shape "
                             f"{tuple(states.x.shape)}, expected "
                             f"{(B, N, d)}")
        st0 = reset_fleet_for_resume(states)
    st = solver._run_while_fleet(factors, As, bs, params, st0, iter_caps)
    outs = _point_outputs(solver, As, bs, st, params)
    coef = outs["x"].reshape(B, n, solver.loss.n_classes)
    status = outs["status"]
    if iter_caps is not None:
        # lanes that the caller's per-lane budget stopped exhausted a budget
        # the caller set, not the config's: MAX_ITER becomes ABORTED
        status = mark_aborted(status, outs["iters"], iter_caps,
                              solver.cfg.max_iter)
    return FleetResult(coef, outs["z"], outs["support"], outs["iters"],
                       outs["p_r"], outs["d_r"], outs["b_r"],
                       outs["cardinality"], kaps, gams, rhos,
                       train_loss=outs["train_loss"], state=st,
                       strategy="fleet-vmap", status=status)


# --------------------------------------------------------------------------
# bucketing by shape: heterogeneous fleets
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetBucket:
    """One shape signature of a heterogeneous fleet: the member problems'
    indices in the caller's order, their stacked zero-padded data, and
    each member's true row count (for the train-loss correction)."""
    signature: tuple          # (N, m_padded, n)
    indices: tuple[int, ...]
    As: torch.Tensor          # (b, N, m_padded, n)
    bs: torch.Tensor          # (b, N, m_padded)
    m_orig: tuple[int, ...]


def _normalize(X, y):
    """One problem's data in the stacked (N, m, n) layout."""
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    if X.ndim == 2:
        X, y = X[None], y.reshape(1, -1)
    if X.ndim != 3:
        raise ValueError(f"each problem must be (samples, n) or (N, m, n); "
                         f"got shape {tuple(X.shape)}")
    return X, y.reshape(X.shape[0], X.shape[1])


def bucket_problems(problems) -> list[FleetBucket]:
    """Group ``(X, y)`` problems by ``(N, n)`` signature, zero-padding the
    sample axis to the largest ``m`` of each bucket."""
    norm = [_normalize(X, y) for X, y in problems]
    groups: dict[tuple, list[int]] = {}
    for i, (X, _) in enumerate(norm):
        N, _, n = X.shape
        groups.setdefault((N, n), []).append(i)
    buckets = []
    for (N, n), idxs in groups.items():
        m_pad = max(norm[i][0].shape[1] for i in idxs)
        As, bs, ms = [], [], []
        for i in idxs:
            X, y = norm[i]
            m = X.shape[1]
            ms.append(m)
            As.append(F.pad(X, (0, 0, 0, m_pad - m)))
            bs.append(F.pad(y, (0, m_pad - m)))
        buckets.append(FleetBucket((N, m_pad, n), tuple(idxs),
                                   torch.stack(As), torch.stack(bs),
                                   tuple(ms)))
    return buckets


def _pad_loss_unit(solver: BiCADMM) -> float:
    """``l(0, 0)``: what one zero-padded row adds to a problem's summed
    train loss (0 for squared, log 2 for logistic, log K for softmax)."""
    loss = solver.loss
    K = loss.n_classes
    pred = torch.zeros((1, K) if K > 1 else (1,), dtype=torch.float32)
    b = torch.zeros((1,), dtype=torch.int32 if K > 1 else torch.float32)
    return float(loss.value(pred, b))


def _subset(vals, idxs):
    return None if vals is None else [vals[i] for i in idxs]


def fit_many(solver: BiCADMM, problems, *, kappas=None, gammas=None,
             rho_cs=None, on_bucket=None) -> list[FitResult]:
    """Fit a heterogeneous list of ``(X, y)`` problems: bucket by shape
    signature, solve each bucket with :func:`fit_many_stacked`, and return
    the per-problem :class:`FitResult` views in the caller's order.
    ``kappas`` / ``gammas`` / ``rho_cs`` are optional per-problem
    sequences; ``on_bucket(bucket)`` is called as each bucket closes,
    before it is solved."""
    problems = list(problems)
    for name, vals in (("kappas", kappas), ("gammas", gammas),
                       ("rho_cs", rho_cs)):
        if vals is not None and len(vals) != len(problems):
            raise ValueError(f"{name} must have one entry per problem "
                             f"({len(problems)}), got {len(vals)}")
    results: list[FitResult | None] = [None] * len(problems)
    for bucket in bucket_problems(problems):
        if on_bucket is not None:
            on_bucket(bucket)
        sub = fit_many_stacked(
            solver, bucket.As, bucket.bs,
            kappas=_subset(kappas, bucket.indices),
            gammas=_subset(gammas, bucket.indices),
            rho_cs=_subset(rho_cs, bucket.indices))
        for j, idx in enumerate(bucket.indices):
            results[idx] = sub[j]
    return results


def corrected_train_losses(solver: BiCADMM, fleet: FleetResult,
                           bucket: FleetBucket) -> torch.Tensor:
    """A padded bucket's per-problem train losses less the padded rows'
    ``l(0, 0)`` each: a padded row's prediction is exactly 0, so each of
    a member's ``N (m_pad - m)`` padded rows adds exactly ``l(0, 0)``."""
    N, m_pad, _ = bucket.signature
    pad_rows = torch.as_tensor([N * (m_pad - m) for m in bucket.m_orig],
                               dtype=fleet.train_loss.dtype,
                               device=fleet.train_loss.device)
    return fleet.train_loss - pad_rows * _pad_loss_unit(solver)

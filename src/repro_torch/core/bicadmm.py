"""Bi-cADMM — Algorithm 1 of the paper, reference engine (counterpart of
``repro.core.bicadmm``).

Solves   min_x sum_i l(A_i x, b_i) + 1/(2 gamma) ||x||^2
         s.t.  ||x||_0 <= kappa

via the bi-linear consensus reformulation and the ADMM splitting (7):

  (7a) x_i  <- prox of the local loss        [per node: see below]
  (7b) (z,t)<- QP over the l1-epigraph cone  [FISTA + exact cone projection]
  (7c) s    <- closed form over S^kappa      [bilinear.s_update]
  (7d) u_i  <- u_i + x_i - z
  (7e) v    <- v + g(z, s, t)

The JAX ``while_loop``/``fori_loop`` drivers are Python loops here; the
outer loop reads its stopping test from the device once per iteration.
Data is the node-stacked (N, m, n) / (N, m) layout, and the iterates keep
the JAX state's (N, d) / (d,) layout, d = n K for a K-class loss, so states
carry across packages (:mod:`repro_torch.convert`).

The x-update (7a) takes one of three routes, as in the JAX package: the
feature-split sub-solver (Algorithm 2, :mod:`.subsolver`) when
``n_feature_blocks > 1`` or ``force_feature_split``; else the squared
loss's factorized engines (:class:`.prox.NodeProxEngine`); else
:func:`.prox.newton_cg_prox`. ``run_from(kappa=, gamma=, rho_c=)``
overrides the configured hyperparameters for one solve (the primitive the
path engine, :mod:`.path`, loops over); a gamma or rho_c override takes the
spectral factors of the dense and Woodbury engines, which the feature split
cannot offer (it bakes the penalties into its per-block factors and raises
``ValueError``). ``fit_with_history`` runs a fixed number of steps and
records the residual traces on the device. A fault-injection hook
(:mod:`repro_torch.faults`), captured when the solver is built, runs after
every solo and lane step, where the JAX package applies it.

Precision: ``"fp32"``, ``"bf16"``, ``"fp16"`` and ``"fp64_polish"``. Under
the reduced presets the data is cast once (cached on the tensors' identity,
as the JAX package's ``_cast``), the kernels read it in place, and the
iterates, factors and residuals stay in f32 (the policy's state dtype).
``"fp64_polish"`` runs the (7b) projection's polish in f64 (the policy's
``kkt_polish``), solo and on lanes. The feature split under a reduced
preset raises :class:`~repro_torch.runtime.CapabilityError` (the JAX
package's own feature split fails under bf16 / fp16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import bilinear, prox
from .losses import Loss, get_loss
from .prox import NodeProxEngine, newton_cg_prox, x_solve
from .results import FitResult, classify_status, divergence_probe
from .subsolver import (SubsolverState, node_prox_feature_split,
                        subsolver_setup)
from .. import faults, runtime
from ..kernels.ops import (gram_auto, matvec_auto, normal_matvec_auto,
                           rmatvec_auto)


# the presets this port certifies
CERTIFIED_PRECISIONS = ("fp32", "bf16", "fp16", "fp64_polish")


@dataclasses.dataclass(frozen=True)
class BiCADMMConfig:
    kappa: int
    gamma: float = 1.0
    rho_c: float = 1.0
    alpha: float = 0.5              # rho_b = alpha * rho_c unless rho_b set
    rho_b: float | None = None
    max_iter: int = 300
    tol: float = 1e-4               # applied to p_r / d_r / b_r
    divergence_tol: float = 1e12
    zt_iters: int = 120             # FISTA iterations for step (7b)
    n_feature_blocks: int = 1       # M (Algorithm 2); 1 => direct prox
    inner_iters: int = 15           # inner ADMM iterations per x-update
    rho_l: float = 1.0              # inner ADMM penalty
    newton_iters: int = 12          # direct Newton-CG prox iterations
    polish: bool = True             # debias on the recovered support
    over_relax: float = 1.0
    force_feature_split: bool = False  # Algorithm 2 even when M == 1
    projection: str = "ladder"      # "ladder" (sort-free exact) | "sort"
    x_solver: str = "auto"          # "auto" | "dense" | "woodbury" | "pcg"
    cg_iters: int = 200
    cg_tol: float = 1e-6
    precision: Any = "fp32"

    def __post_init__(self):
        object.__setattr__(self, "precision",
                           runtime.resolve_precision(self.precision))
        name = runtime.precision_name(self.precision)
        if name not in CERTIFIED_PRECISIONS:
            raise runtime.CapabilityError(
                f"precision {name!r} is not ported to repro_torch yet; "
                f"certified presets: {CERTIFIED_PRECISIONS}")
        if self.precision.data is not None and self.use_feature_split:
            raise runtime.CapabilityError(
                f"the feature split under precision {name!r} is not ported: "
                "the JAX package's own sub-solver fails on bf16 / fp16 data "
                "(ROADMAP Queue 3); use precision='fp32' with "
                "n_feature_blocks > 1, or the sharded engine "
                "(engine='sharded'), whose sub-solver factors in f32")
        if self.divergence_tol <= 0:
            raise ValueError("divergence_tol must be positive")
        if self.x_solver not in prox.XSOLVERS:
            raise ValueError(f"unknown x_solver {self.x_solver!r}; expected "
                             f"one of {prox.XSOLVERS}")

    @property
    def rho_b_eff(self) -> float:
        return self.rho_b if self.rho_b is not None else self.alpha * self.rho_c

    @property
    def use_feature_split(self) -> bool:
        return self.n_feature_blocks > 1 or self.force_feature_split


class SolveParams(NamedTuple):
    """Per-solve hyperparameters: Python scalars for one solve (read on the
    host: the solo projection kernels take kappa as a number). For lanes
    (the fleet, a grid) ``kappa`` is a (B,) tensor on the device and each
    penalty a Python scalar shared by every lane or a (B,) tensor."""
    kappa: Any
    rho_c: Any
    rho_b: Any
    sigma: Any        # 1 / (N * gamma)


class BiCADMMState(NamedTuple):
    x: torch.Tensor   # (N, d) local estimates, d = n K
    u: torch.Tensor   # (N, d) scaled consensus duals
    z: torch.Tensor   # (d,)
    t: torch.Tensor   # ()
    s: torch.Tensor   # (d,)
    v: torch.Tensor   # () scaled bi-linear dual
    k: torch.Tensor   # () int32 iteration counter
    p_r: torch.Tensor
    d_r: torch.Tensor
    b_r: torch.Tensor
    inner: Any = None  # SubsolverState of the feature split, else None


def _number(v):
    """A hyperparameter as a Python number (0-d tensors read once)."""
    return v.item() if torch.is_tensor(v) else v


def reset_for_resume(st: BiCADMMState) -> BiCADMMState:
    """Zero the iteration counter and set the residuals to inf so a state
    re-enters the loop; the iterates are kept."""
    inf = torch.full((), float("inf"), dtype=st.z.dtype, device=st.z.device)
    return st._replace(k=torch.zeros((), dtype=torch.int32,
                                     device=st.z.device),
                       p_r=inf, d_r=inf.clone(), b_r=inf.clone())


def _fista_betas(iters: int) -> list[float]:
    """FISTA momentum weights (tk - 1) / tk_new, computed in float32 as the
    JAX package computes them in the state dtype."""
    one, half, four = np.float32(1.0), np.float32(0.5), np.float32(4.0)
    tk, out = one, []
    for _ in range(iters):
        tk_new = half * (one + np.sqrt(one + four * tk * tk))
        out.append(float((tk - one) / tk_new))
        tk = tk_new
    return out


def _col(v):
    """A per-lane (B,) tensor as a (B, 1) column; a Python scalar as is."""
    return v[:, None] if torch.is_tensor(v) else v


def _zt_update(z0, t0, w, s, v, N: float, rho_c, rho_b, iters: int, *,
               projection: str = "ladder", polish_dtype=None, ops=None):
    """Step (7b): min over {(z,t): ||z||_1 <= t} of
    (N rho_c / 2) ||z - w||^2 + (rho_b / 2) (s^T z - t + v)^2
    by FISTA with the exact sort-free cone projection (``projection=
    "sort"``: the sort oracle; ``polish_dtype``: the projection's polish
    dtype, the policy's ``kkt_polish``). With a lane axis (z0 (B, d), t0
    (B,), rho_c and rho_b scalars or (B,) tensors) every lane takes the same
    steps, each FISTA step's projection one call for all lanes. ``ops``
    (solo only): every reduction injected (:class:`bilinear.LadderOps`:
    the sharded engine's reductions over its feature blocks), the default
    ones when None."""
    ops = bilinear.DEFAULT_OPS if ops is None else ops
    if projection == "sort":
        project = bilinear.project_l1_epigraph_sort
    else:
        def project(z, t):
            return bilinear.project_l1_epigraph(z, t, ops=ops,
                                                polish_dtype=polish_dtype)
    a = N * rho_c
    lanes = z0.ndim == 2
    if lanes:
        L = a + rho_b * (torch.sum(s * s, dim=-1) + 1.0)

        def grads(z, t):
            r = torch.sum(s * z, dim=-1) - t + v
            return _col(a) * (z - w) + _col(rho_b * r) * s, -rho_b * r
    else:
        L = a + rho_b * (ops.sum_fn(s * s) + 1.0)  # ||Hessian||_2 bound

        def grads(z, t):
            r = ops.sum_fn(s * z) - t + v
            return a * (z - w) + rho_b * r * s, -rho_b * r
    step = 1.0 / L
    step_z = _col(step) if lanes else step

    z, t = project(z0, t0)
    zy, ty = z, t
    for beta in _fista_betas(iters):
        gz, gt = grads(zy, ty)
        z_new, t_new = project(zy - step_z * gz, ty - step * gt)
        zy = z_new + beta * (z_new - z)
        ty = t_new + beta * (t_new - t)
        z, t = z_new, t_new
    return z, t


class BiCADMM:
    """Reference Bi-cADMM solver. Data: stacked (N, m, n) features and
    (N, m) targets on one device; the solve runs where the data lies."""

    _SETUP_CACHE_MAX = 4

    def __init__(self, loss: Loss | str, cfg: BiCADMMConfig, *,
                 n_classes: int = 1):
        self.loss = (get_loss(loss, n_classes) if isinstance(loss, str)
                     else loss)
        if cfg.projection not in ("ladder", "sort"):
            raise ValueError(f"unknown projection mode {cfg.projection!r}")
        self.cfg = cfg
        # fault-injection hook (repro_torch.faults): None outside an
        # inject() context; captured once, so it stays with this solver
        self._fault_hook = faults.active_hook(self)
        # the precision policy's cast of the data and the setup factors,
        # both keyed on the data tensors' identity, so warm-started run_from
        # calls cast and factorize once. Entries hold strong references to
        # the keyed tensors, which keeps their ids valid while cached.
        self._cast_cache: dict = {}
        self._setup_cache: dict = {}

    def _cast(self, As, bs):
        """The policy's data cast (``As``, ``bs`` themselves under fp32 or
        when they already have the data dtype); the same cast tensors for
        the same inputs, so the setup cache hits on refits."""
        pol = self.cfg.precision
        if pol.data is None:
            return As, bs
        key = (id(As), id(bs))
        hit = self._cast_cache.get(key)
        if hit is None:
            if len(self._cast_cache) >= self._SETUP_CACHE_MAX:
                self._cast_cache.pop(next(iter(self._cast_cache)))
            hit = (As, bs, pol.cast_data(As), pol.cast_data(bs))
            self._cast_cache[key] = hit
        return hit[2], hit[3]

    def _x_engine(self, m: int, n: int,
                  dynamic: bool = False) -> NodeProxEngine:
        cfg = self.cfg
        return NodeProxEngine.choose(m, n, x_solver=cfg.x_solver,
                                     dynamic=dynamic, cg_iters=cfg.cg_iters,
                                     cg_tol=cfg.cg_tol)

    # -- setup ---------------------------------------------------------------
    def _setup(self, As, bs, *, dynamic_penalties: bool = False):
        """(factors, N, n), cached on the data tensors and on whether the
        penalties change between solves (spectral factors) or not."""
        cfg = self.cfg
        N, m, n = As.shape
        key = self._setup_key(As, bs, dynamic_penalties)
        hit = self._setup_cache.get(key)
        if hit is not None:
            return hit[-1]
        sigma = 1.0 / (N * cfg.gamma)
        if cfg.use_feature_split:
            if dynamic_penalties:
                raise ValueError(
                    "dynamic gamma/rho_c are not supported with the "
                    "feature-split sub-solver (penalties are baked into its "
                    "cached per-block factors); sweep kappa only, or use "
                    "n_feature_blocks=1")
            factors = subsolver_setup(As, sigma, cfg.rho_c, cfg.rho_l,
                                      cfg.n_feature_blocks)
        elif self.loss.name == "squared":
            factors = self._x_engine(m, n, dynamic_penalties).setup(
                As, bs, sigma, cfg.rho_c)
        else:
            factors = None
        out = (factors, N, n)
        if len(self._setup_cache) >= self._SETUP_CACHE_MAX:
            self._setup_cache.pop(next(iter(self._setup_cache)))
        self._setup_cache[key] = (As, bs, out)
        return out

    def seed_setup(self, As, bs, factors, *, dynamic_penalties: bool
                   ) -> None:
        """Pre-fill the setup cache with ``factors`` for the data
        (``As``, ``bs``): a later ``run_from`` on the same tensors skips its
        own factorization (the streaming engine's maintained factors)."""
        key = self._setup_key(As, bs, dynamic_penalties)
        if key in self._setup_cache:
            return
        if len(self._setup_cache) >= self._SETUP_CACHE_MAX:
            self._setup_cache.pop(next(iter(self._setup_cache)))
        self._setup_cache[key] = (As, bs, (factors, As.shape[0],
                                           As.shape[2]))

    @staticmethod
    def _setup_key(As, bs, dynamic_penalties: bool) -> tuple:
        return (id(As), id(bs), tuple(As.shape), tuple(bs.shape),
                str(As.dtype), str(As.device), bool(dynamic_penalties))

    def _make_params(self, N: int, *, kappa=None, gamma=None,
                     rho_c=None) -> SolveParams:
        """The config's hyperparameters with any override. Overrides may be
        0-d host tensors (the path engine's grids, in the data dtype): sigma
        and rho_b are then formed in that dtype, as the JAX package forms
        them from its grid arrays, and read back as numbers."""
        cfg = self.cfg
        kappa = cfg.kappa if kappa is None else kappa
        gamma = cfg.gamma if gamma is None else gamma
        rho_c = cfg.rho_c if rho_c is None else rho_c
        rho_b = cfg.rho_b if cfg.rho_b is not None else cfg.alpha * rho_c
        return SolveParams(kappa=_number(kappa), rho_c=_number(rho_c),
                           rho_b=_number(rho_b),
                           sigma=_number(1.0 / (N * gamma)))

    def _x_update(self, factors, params: SolveParams, As, bs, q, x_prev,
                  inner):
        """q: (N, d) prox centers, x_prev: (N, d) previous outer iterates
        (PCG warm start) -> (N, d), new inner state."""
        cfg, loss = self.cfg, self.loss
        N, m, n = As.shape
        K = loss.n_classes
        if cfg.use_feature_split:
            x, inner = node_prox_feature_split(
                loss, factors, bs, q.reshape(N, n, K), cfg.inner_iters, inner)
            return x.reshape(N, -1), inner
        if loss.name == "squared":
            return x_solve(factors, q, params.rho_c, params.sigma,
                           x0=x_prev), inner
        qx = q.reshape(N, n, K) if K > 1 else q
        x = newton_cg_prox(loss, As, bs, qx, params.sigma, params.rho_c,
                           newton_iters=cfg.newton_iters)
        return x.reshape(N, -1), inner

    # -- one iteration ---------------------------------------------------------
    def _step(self, factors, As, bs, params: SolveParams,
              st: BiCADMMState) -> BiCADMMState:
        cfg = self.cfg
        N = As.shape[0]
        rho_c, rho_b = params.rho_c, params.rho_b

        q = st.z[None] - st.u                              # (N, d)
        x_new, inner = self._x_update(factors, params, As, bs, q, st.x,
                                      st.inner)
        if cfg.over_relax != 1.0:
            x_eff = cfg.over_relax * x_new + (1.0 - cfg.over_relax) * st.z[None]
        else:
            x_eff = x_new

        w = torch.mean(x_eff + st.u, dim=0)                # consensus center
        z_new, t_new = _zt_update(st.z, st.t, w, st.s, st.v, float(N),
                                  rho_c, rho_b, cfg.zt_iters,
                                  projection=cfg.projection,
                                  polish_dtype=cfg.precision.kkt_polish)
        s_new = bilinear.s_update(z_new, t_new, st.v, params.kappa,
                                  method=self._s_method)
        u_new = st.u + x_eff - z_new[None]
        gval = bilinear.g(z_new, s_new, t_new)
        v_new = st.v + gval

        p_r = torch.sum(torch.linalg.vector_norm(x_new - z_new[None], dim=1))
        # sqrt(N) * rho_c rounded to float32 as the JAX package forms it
        scale = float(np.float32(np.sqrt(np.float32(N))) * np.float32(rho_c))
        d_r = scale * torch.linalg.vector_norm(z_new - st.z)
        b_r = torch.abs(gval)
        return BiCADMMState(x_new, u_new, z_new, t_new, s_new, v_new,
                            st.k + 1, p_r, d_r, b_r, inner)

    def _init_state(self, As, n: int, K: int) -> BiCADMMState:
        cfg = self.cfg
        N, m, _ = As.shape
        d = n * K
        # the iterates stay in the policy's state dtype (f32 under the
        # reduced presets): only the A-products touch the narrow data
        kw = dict(dtype=cfg.precision.state_dtype(As.dtype),
                  device=As.device)
        inner = None
        if cfg.use_feature_split:
            M = cfg.n_feature_blocks
            nb = -(-n // M)
            inner = SubsolverState(
                x_blocks=torch.zeros((N, M, nb, K), **kw),
                nu=torch.zeros((N, m, K), **kw),
                omega_bar=torch.zeros((N, m, K), **kw))
        inf = float("inf")
        return BiCADMMState(
            x=torch.zeros((N, d), **kw), u=torch.zeros((N, d), **kw),
            z=torch.zeros((d,), **kw), t=torch.zeros((), **kw),
            s=torch.zeros((d,), **kw), v=torch.zeros((), **kw),
            k=torch.zeros((), dtype=torch.int32, device=As.device),
            p_r=torch.full((), inf, **kw), d_r=torch.full((), inf, **kw),
            b_r=torch.full((), inf, **kw), inner=inner)

    # -- drivers ---------------------------------------------------------------
    def init_state(self, As, bs) -> BiCADMMState:
        """A fresh zero state."""
        As, bs = self._cast(As, bs)
        return self._init_state(As, As.shape[2], self.loss.n_classes)

    @property
    def _s_method(self) -> str:
        return "sort" if self.cfg.projection == "sort" else "ladder"

    # -- lanes: B solves stepped together (the fleet driver, a grid) ---------
    def _lane_step(self, x_update, params: SolveParams,
                   st: BiCADMMState) -> BiCADMMState:
        """One iteration of B independent solves, the state's fields with a
        leading lane axis (x, u (B, N, d); z, s (B, d); t, v, k and the
        residuals (B,)). ``x_update(q, x_prev)`` is the (7a) step of every
        lane's nodes, (B, N, d) -> (B, N, d); the rest is :meth:`_step`'s
        arithmetic lane by lane, the projections one call for all lanes."""
        cfg = self.cfg
        N = st.x.shape[1]
        rho_c, rho_b = params.rho_c, params.rho_b
        q = st.z[:, None] - st.u
        x_new = x_update(q, st.x)
        if cfg.over_relax != 1.0:
            x_eff = (cfg.over_relax * x_new
                     + (1.0 - cfg.over_relax) * st.z[:, None])
        else:
            x_eff = x_new
        w = torch.mean(x_eff + st.u, dim=1)
        z_new, t_new = _zt_update(st.z, st.t, w, st.s, st.v, float(N),
                                  rho_c, rho_b, cfg.zt_iters,
                                  projection=cfg.projection,
                                  polish_dtype=cfg.precision.kkt_polish)
        s_new = bilinear.s_update(z_new, t_new, st.v, params.kappa,
                                  method=self._s_method)
        u_new = st.u + x_eff - z_new[:, None]
        gval = bilinear.g(z_new, s_new, t_new)
        v_new = st.v + gval
        p_r = torch.sum(torch.linalg.vector_norm(x_new - z_new[:, None],
                                                 dim=2), dim=1)
        sqrt_n = np.float32(np.sqrt(np.float32(N)))
        scale = (float(sqrt_n) * rho_c if torch.is_tensor(rho_c)
                 else float(sqrt_n * np.float32(rho_c)))
        d_r = scale * torch.linalg.vector_norm(z_new - st.z, dim=-1)
        b_r = torch.abs(gval)
        return BiCADMMState(x_new, u_new, z_new, t_new, s_new, v_new,
                            st.k + 1, p_r, d_r, b_r, None)

    def _fleet_active(self, st: BiCADMMState, iter_caps=None) -> torch.Tensor:
        """(B,) mask of the lanes still iterating: the solo loop's test per
        lane, with ``iter_caps`` (a (B,) int tensor) tightening each lane's
        budget below ``max_iter`` (a cap of 0: an inert padding lane)."""
        cfg = self.cfg
        converged = ((st.p_r < cfg.tol) & (st.d_r < cfg.tol)
                     & (st.b_r < cfg.tol))
        diverged = divergence_probe(st, cfg.divergence_tol)
        budget = (cfg.max_iter if iter_caps is None
                  else torch.clamp_max(iter_caps, cfg.max_iter))
        return (~converged) & (~diverged) & (st.k < budget)

    def _run_while_lanes(self, step, st: BiCADMMState,
                         iter_caps=None) -> BiCADMMState:
        """Step every lane while any is active; a lane that is not keeps
        its whole state (``torch.where``), as the JAX package's vmapped
        ``while_loop`` keeps it. The host reads the mask once an outer
        iteration, as :meth:`_run_while` reads its test."""
        hook = self._fault_hook
        while True:
            active = self._fleet_active(st, iter_caps)
            if not bool(active.any()):
                return st
            new = step(st)
            if hook is not None:
                new = hook(new)
            st = BiCADMMState(*(
                None if o is None else torch.where(
                    active.reshape(active.shape + (1,) * (o.ndim - 1)), n, o)
                for n, o in zip(new, st)))

    def _fleet_x_update(self, factors, params: SolveParams, As, bs):
        """The (7a) step of B problems' nodes, ``As`` (B, N, m, n): the
        squared loss's factors (set up on the (B N, m, n) view) or
        Newton-CG, each node a system of the kernels' batch, per-lane
        penalties repeated over the lane's N nodes."""
        cfg, loss = self.cfg, self.loss
        B, N, m, n = As.shape
        K = loss.n_classes
        A_nodes, b_nodes = As.reshape(B * N, m, n), bs.reshape(B * N, m)

        def per_node(v, ndim):
            if not torch.is_tensor(v):
                return v
            return v.repeat_interleave(N).reshape((B * N,) + (1,) * ndim)

        if loss.name == "squared":
            rho_c, sigma = per_node(params.rho_c, 1), per_node(params.sigma, 1)

            def update(q, x_prev):
                x = x_solve(factors, q.reshape(B * N, -1), rho_c, sigma,
                            x0=x_prev.reshape(B * N, -1))
                return x.reshape(B, N, -1)
            return update
        xdims = 2 if K > 1 else 1
        rho_c = per_node(params.rho_c, xdims)
        sigma = per_node(params.sigma, xdims)

        def update(q, x_prev):
            qn = q.reshape((B * N, n, K) if K > 1 else (B * N, n))
            x = newton_cg_prox(loss, A_nodes, b_nodes, qn, sigma, rho_c,
                               newton_iters=cfg.newton_iters)
            return x.reshape(B, N, -1)
        return update

    def _run_while_fleet(self, factors, As, bs, params: SolveParams,
                         st0: BiCADMMState, iter_caps=None) -> BiCADMMState:
        """The fleet's masked loop: B problems ``As`` (B, N, m, n), ``bs``
        (B, N, m) with per-problem ``params`` from ``st0`` until no lane is
        active (``repro.core.bicadmm.BiCADMM._run_while_fleet``)."""
        update = self._fleet_x_update(factors, params, As, bs)
        return self._run_while_lanes(
            lambda st: self._lane_step(update, params, st), st0, iter_caps)

    def _finalize_lanes(self, As, bs, st: BiCADMMState,
                        params: SolveParams):
        """Threshold, polish and classify every lane of a final lane state
        over per-lane data ``As`` (B, N, m, n): (x (B, d), support (B, d),
        status (B,)), each lane as :meth:`_finalize` finalizes a path
        point (``compiled``)."""
        cfg = self.cfg
        z_sparse = bilinear.hard_threshold_lanes(st.z, params.kappa)
        support = torch.abs(z_sparse) > 0
        x = (self._polish_lanes(As, bs, support, z_sparse, params)
             if cfg.polish else z_sparse)
        status = classify_status(st.k, st.p_r, st.d_r, st.b_r, tol=cfg.tol,
                                 divergence_tol=cfg.divergence_tol)
        return x, support, status

    def _polish_lanes(self, As, bs, support, z0, params: SolveParams):
        """:meth:`_polish` of every lane: the dense solve, the PCG polish or
        Newton-CG, each with a lane axis (per-lane data, support and
        sigma)."""
        cfg, loss = self.cfg, self.loss
        B, N, m, n = As.shape
        K = loss.n_classes
        sigma = N * params.sigma         # 1 / gamma, per lane or shared
        pen = torch.where(support, 0.0, 1e8).to(z0.dtype)
        A_all, b_all = As.reshape(B, N * m, n), bs.reshape(B, N * m)
        if loss.name == "squared":
            shift = pen + _col(sigma)
            if n <= prox.DENSE_MAX_N and cfg.x_solver in ("auto", "dense"):
                acc = cfg.precision.accum_dtype(A_all.dtype)
                H = (gram_auto(A_all, out_dtype=acc)
                     + torch.diag_embed(shift.to(acc)))
                x = torch.linalg.solve(H, rmatvec_auto(A_all, b_all,
                                                       out_dtype=acc))
                return torch.where(support, x, 0.0)
            inv = 1.0 / (prox.col_sumsq(A_all) + shift)
            rhs = rmatvec_auto(A_all, b_all, out_dtype=z0.dtype)
            x = prox.pcg(lambda p: normal_matvec_auto(A_all, p, shift),
                         rhs, z0, lambda r: inv * r,
                         max(200, 2 * cfg.cg_iters), cfg.cg_tol)
            return torch.where(support, x, 0.0)
        xshape = (B, n, K) if K > 1 else (B, n)
        sig_x = (sigma.reshape((B,) + (1,) * (len(xshape) - 1))
                 if torch.is_tensor(sigma) else sigma)
        xf = z0
        for _ in range(cfg.newton_iters):
            x = xf.reshape(xshape)
            pred = matvec_auto(A_all, x)
            g = rmatvec_auto(A_all, loss.grad(pred, b_all))
            g = (g + sig_x * x).reshape(B, -1) + pen * xf
            dgrad = prox.grad_tangent(loss, pred, b_all)

            def hvp(p, dgrad=dgrad):
                pv = p.reshape(xshape)
                dlg = dgrad(matvec_auto(A_all, pv))
                out = (rmatvec_auto(A_all, dlg) + sig_x * pv).reshape(B, -1)
                return out + pen * p

            xf = xf - prox._cg(hvp, g, 60)
        return torch.where(support, xf, 0.0)

    def _run_while(self, factors, As, bs, params: SolveParams,
                   st: BiCADMMState) -> BiCADMMState:
        cfg = self.cfg
        while True:
            converged = ((st.p_r < cfg.tol) & (st.d_r < cfg.tol)
                         & (st.b_r < cfg.tol))
            diverged = divergence_probe(st, cfg.divergence_tol)
            go = (~converged) & (~diverged) & (st.k < cfg.max_iter)
            if not bool(go):
                return st
            st = self._step(factors, As, bs, params, st)
            if self._fault_hook is not None:
                st = self._fault_hook(st)

    def run_from(self, As, bs, state: BiCADMMState, *, kappa=None,
                 gamma=None, rho_c=None) -> FitResult:
        """Run until the residual tolerances or max_iter, warm-starting
        from ``state`` (counter and residuals reset, iterates kept).
        ``kappa`` / ``gamma`` / ``rho_c`` override the config for this
        solve; a ``gamma`` or ``rho_c`` override takes the spectral factors
        (set up once and cached like the others)."""
        dyn = gamma is not None or rho_c is not None
        As, bs = self._cast(As, bs)
        factors, N, n = self._setup(As, bs, dynamic_penalties=dyn)
        params = self._make_params(N, kappa=kappa, gamma=gamma, rho_c=rho_c)
        st = self._run_while(factors, As, bs, params,
                             reset_for_resume(state))
        return self._finalize(As, bs, st, params)

    def fit(self, As, bs) -> FitResult:
        """``run_from`` a fresh zero state."""
        return self.run_from(As, bs, self.init_state(As, bs))

    def fit_with_history(self, As, bs, iters: int | None = None
                         ) -> FitResult:
        """``iters`` steps (``max_iter`` by default) with no stopping test,
        recording the residuals and the cardinality of z after each step
        (Fig. 1). The traces stay on the device, stacked once at the end:
        no host read per step. ``history`` holds ``p_r``, ``d_r``, ``b_r``
        and ``card`` (int32), each of shape (iters,)."""
        As, bs = self._cast(As, bs)
        factors, N, n = self._setup(As, bs)
        params = self._make_params(N)
        iters = iters or self.cfg.max_iter
        st = self._init_state(As, n, self.loss.n_classes)
        rows = []
        for _ in range(iters):
            st = self._step(factors, As, bs, params, st)
            if self._fault_hook is not None:
                st = self._fault_hook(st)
            rows.append((st.p_r, st.d_r, st.b_r,
                         torch.sum(torch.abs(st.z) > 1e-6,
                                   dtype=torch.int32)))
        history = {name: torch.stack(col) for name, col in
                   zip(("p_r", "d_r", "b_r", "card"), zip(*rows))}
        return self._finalize(As, bs, st, params, history=history)

    def _finalize(self, As, bs, st: BiCADMMState, params: SolveParams,
                  history=None, *, compiled: bool = False) -> FitResult:
        """Threshold, polish and classify a final state. ``compiled``: the
        JAX package finalizes this solve inside one compiled program (a
        path point), where XLA keeps the PCG polish's A^T b of bf16 / fp16
        data in f32 instead of rounding it to the data dtype as its eager
        finalize of a fit does; the port follows each."""
        cfg = self.cfg
        z_sparse = bilinear.hard_threshold(st.z, params.kappa)
        support = torch.abs(z_sparse) > 0
        if cfg.polish:
            x_final = self._polish(As, bs, support, z_sparse, params,
                                   compiled)
        else:
            x_final = z_sparse
        coef = x_final.reshape(As.shape[2], self.loss.n_classes)
        status = classify_status(st.k, st.p_r, st.d_r, st.b_r, tol=cfg.tol,
                                 divergence_tol=cfg.divergence_tol)
        return FitResult(coef, st.z, support, st.k, st.p_r, st.d_r, st.b_r,
                         history, st, status=status)

    def _polish(self, As, bs, support, z0, params: SolveParams,
                compiled: bool = False):
        """Debias: re-fit restricted to the recovered support, as the full
        regularized problem plus a large quadratic penalty off-support. For
        the squared loss a dense solve while the n x n Gram is small,
        matrix-free Jacobi-PCG on (A^T A + diag(pen + sigma)) beyond; for the
        other losses Newton-CG on the stacked data."""
        cfg, loss = self.cfg, self.loss
        N, m, n = As.shape
        K = loss.n_classes
        sigma = N * params.sigma         # full-problem l2 weight = 1 / gamma
        # in the state dtype (f32): 1e8 + sigma is not rounded to the data's
        pen = torch.where(support, 0.0, 1e8).to(z0.dtype)
        A_all = As.reshape(N * m, n)
        b_all = bs.reshape(-1)
        if loss.name == "squared":
            if n <= prox.DENSE_MAX_N and cfg.x_solver in ("auto", "dense"):
                acc = cfg.precision.accum_dtype(A_all.dtype)
                H = (gram_auto(A_all, out_dtype=acc)
                     + torch.diag((pen + sigma).to(acc)))
                x = torch.linalg.solve(H, rmatvec_auto(A_all, b_all,
                                                       out_dtype=acc))
                return torch.where(support, x, 0.0)
            # the right-hand side takes no out_dtype, as in the JAX package:
            # bf16 / fp16 data rounds A^T b to the data dtype (but for the
            # compiled finalize, see _finalize)
            shift = pen + sigma
            inv = 1.0 / (prox.col_sumsq(A_all) + shift)
            rhs = rmatvec_auto(A_all, b_all,
                               out_dtype=z0.dtype if compiled else None)
            x = prox.pcg(lambda p: normal_matvec_auto(A_all, p, shift),
                         rhs, z0, lambda r: inv * r,
                         max(200, 2 * cfg.cg_iters), cfg.cg_tol)
            return torch.where(support, x, 0.0)

        # Newton-CG on the masked problem (the penalty keeps off-support ~ 0)
        xshape = (n, K) if K > 1 else (n,)
        xf = z0
        for _ in range(cfg.newton_iters):
            x = xf.reshape(xshape)
            pred = matvec_auto(A_all, x)
            g = rmatvec_auto(A_all, loss.grad(pred, b_all))
            g = (g + sigma * x).reshape(-1) + pen * xf
            dgrad = prox.grad_tangent(loss, pred, b_all)

            def hvp(p, dgrad=dgrad):
                pv = p[0].reshape(xshape)
                dlg = dgrad(matvec_auto(A_all, pv))
                out = (rmatvec_auto(A_all, dlg) + sigma * pv).reshape(-1)
                return (out + pen * p[0])[None]

            xf = xf - prox._cg(hvp, g[None], 60)[0]
        return torch.where(support, xf, 0.0)

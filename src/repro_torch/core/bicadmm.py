"""Bi-cADMM — Algorithm 1 of the paper, reference engine (counterpart of
``repro.core.bicadmm``).

Solves   min_x sum_i 1/2||A_i x - b_i||^2 + 1/(2 gamma) ||x||^2
         s.t.  ||x||_0 <= kappa

via the bi-linear consensus reformulation and the ADMM splitting (7):

  (7a) x_i  <- prox of the local loss        [prox.NodeProxEngine, per node]
  (7b) (z,t)<- QP over the l1-epigraph cone  [FISTA + exact cone projection]
  (7c) s    <- closed form over S^kappa      [bilinear.s_update]
  (7d) u_i  <- u_i + x_i - z
  (7e) v    <- v + g(z, s, t)

The JAX ``while_loop``/``fori_loop`` drivers are Python loops here; the
outer loop reads its stopping test from the device once per iteration.
Data is the node-stacked (N, m, n) / (N, m) layout, and the iterates keep
the JAX state's (N, n) / (n,) layout so states carry across packages
(:mod:`repro_torch.convert`).

This slice runs the squared loss at float32. The feature-split sub-solver,
the fleet driver, ``fit_with_history`` and fault injection wait for later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import bilinear, prox
from .losses import Loss, get_loss
from .prox import NodeProxEngine, x_solve
from .results import FitResult, classify_status, divergence_probe
from .. import runtime
from ..kernels.ops import gram_auto, normal_matvec_auto, rmatvec_auto


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
    polish: bool = True             # debias on the recovered support
    over_relax: float = 1.0
    x_solver: str = "auto"          # "auto" | "dense" | "woodbury" | "pcg"
    cg_iters: int = 200
    cg_tol: float = 1e-6
    precision: Any = "fp32"

    def __post_init__(self):
        object.__setattr__(self, "precision",
                           runtime.resolve_precision(self.precision))
        if self.precision != runtime.PRECISION_PRESETS["fp32"]:
            raise runtime.CapabilityError(
                f"precision {runtime.precision_name(self.precision)!r} is "
                "not ported to repro_torch yet; this slice certifies 'fp32'")
        if self.divergence_tol <= 0:
            raise ValueError("divergence_tol must be positive")
        if self.x_solver not in prox.XSOLVERS:
            raise ValueError(f"unknown x_solver {self.x_solver!r}; expected "
                             f"one of {prox.XSOLVERS}")

    @property
    def rho_b_eff(self) -> float:
        return self.rho_b if self.rho_b is not None else self.alpha * self.rho_c


class SolveParams(NamedTuple):
    """Per-solve hyperparameters (Python scalars in this slice)."""
    kappa: float
    rho_c: float
    rho_b: float
    sigma: float      # 1 / (N * gamma)


class BiCADMMState(NamedTuple):
    x: torch.Tensor   # (N, n) local estimates
    u: torch.Tensor   # (N, n) scaled consensus duals
    z: torch.Tensor   # (n,)
    t: torch.Tensor   # ()
    s: torch.Tensor   # (n,)
    v: torch.Tensor   # () scaled bi-linear dual
    k: torch.Tensor   # () int32 iteration counter
    p_r: torch.Tensor
    d_r: torch.Tensor
    b_r: torch.Tensor
    inner: Any = None  # feature-split sub-solver state (not ported: None)


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


def _zt_update(z0, t0, w, s, v, N: float, rho_c: float, rho_b: float,
               iters: int):
    """Step (7b): min over {(z,t): ||z||_1 <= t} of
    (N rho_c / 2) ||z - w||^2 + (rho_b / 2) (s^T z - t + v)^2
    by FISTA with the exact sort-free cone projection."""
    a = N * rho_c
    L = a + rho_b * (torch.sum(s * s) + 1.0)   # ||Hessian||_2 upper bound
    step = 1.0 / L

    def grads(z, t):
        r = torch.sum(s * z) - t + v
        return a * (z - w) + rho_b * r * s, -rho_b * r

    z, t = bilinear.project_l1_epigraph(z0, t0)
    zy, ty = z, t
    for beta in _fista_betas(iters):
        gz, gt = grads(zy, ty)
        z_new, t_new = bilinear.project_l1_epigraph(zy - step * gz,
                                                    ty - step * gt)
        zy = z_new + beta * (z_new - z)
        ty = t_new + beta * (t_new - t)
        z, t = z_new, t_new
    return z, t


class BiCADMM:
    """Reference Bi-cADMM solver. Data: stacked (N, m, n) features and
    (N, m) targets on one device; the solve runs where the data lies."""

    _SETUP_CACHE_MAX = 4

    def __init__(self, loss: Loss | str, cfg: BiCADMMConfig):
        self.loss = get_loss(loss) if isinstance(loss, str) else loss
        if self.loss.name != "squared":
            get_loss(self.loss.name, self.loss.n_classes)   # raises
        self.cfg = cfg
        # setup factors keyed on the data tensors' identity, so warm-started
        # run_from calls factorize once. Entries hold strong references to
        # the keyed tensors, which keeps their ids valid while cached.
        self._setup_cache: dict = {}

    def _x_engine(self, m: int, n: int) -> NodeProxEngine:
        cfg = self.cfg
        return NodeProxEngine.choose(m, n, x_solver=cfg.x_solver,
                                     cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)

    # -- setup ---------------------------------------------------------------
    def _setup(self, As, bs):
        cfg = self.cfg
        N, m, n = As.shape
        key = (id(As), id(bs), tuple(As.shape), tuple(bs.shape),
               str(As.dtype), str(As.device))
        hit = self._setup_cache.get(key)
        if hit is not None:
            return hit[-1]
        sigma = 1.0 / (N * cfg.gamma)
        eng = self._x_engine(m, n)
        out = (eng.setup(As, bs, sigma, cfg.rho_c), N, n)
        if len(self._setup_cache) >= self._SETUP_CACHE_MAX:
            self._setup_cache.pop(next(iter(self._setup_cache)))
        self._setup_cache[key] = (As, bs, out)
        return out

    def _make_params(self, N: int, *, kappa=None) -> SolveParams:
        cfg = self.cfg
        kappa = cfg.kappa if kappa is None else kappa
        return SolveParams(kappa=kappa, rho_c=cfg.rho_c, rho_b=cfg.rho_b_eff,
                           sigma=1.0 / (N * cfg.gamma))

    # -- one iteration ---------------------------------------------------------
    def _step(self, factors, As, params: SolveParams,
              st: BiCADMMState) -> BiCADMMState:
        cfg = self.cfg
        N = As.shape[0]
        rho_c, rho_b = params.rho_c, params.rho_b

        q = st.z[None] - st.u                              # (N, n)
        x_new = x_solve(factors, q, rho_c, params.sigma, x0=st.x)
        if cfg.over_relax != 1.0:
            x_eff = cfg.over_relax * x_new + (1.0 - cfg.over_relax) * st.z[None]
        else:
            x_eff = x_new

        w = torch.mean(x_eff + st.u, dim=0)                # consensus center
        z_new, t_new = _zt_update(st.z, st.t, w, st.s, st.v, float(N),
                                  rho_c, rho_b, cfg.zt_iters)
        s_new = bilinear.s_update(z_new, t_new, st.v, params.kappa)
        u_new = st.u + x_eff - z_new[None]
        gval = bilinear.g(z_new, s_new, t_new)
        v_new = st.v + gval

        p_r = torch.sum(torch.linalg.vector_norm(x_new - z_new[None], dim=1))
        # sqrt(N) * rho_c rounded to float32 as the JAX package forms it
        scale = float(np.float32(np.sqrt(np.float32(N))) * np.float32(rho_c))
        d_r = scale * torch.linalg.vector_norm(z_new - st.z)
        b_r = torch.abs(gval)
        return BiCADMMState(x_new, u_new, z_new, t_new, s_new, v_new,
                            st.k + 1, p_r, d_r, b_r, None)

    def _init_state(self, As, n: int) -> BiCADMMState:
        N = As.shape[0]
        kw = dict(dtype=As.dtype, device=As.device)
        inf = float("inf")
        return BiCADMMState(
            x=torch.zeros((N, n), **kw), u=torch.zeros((N, n), **kw),
            z=torch.zeros((n,), **kw), t=torch.zeros((), **kw),
            s=torch.zeros((n,), **kw), v=torch.zeros((), **kw),
            k=torch.zeros((), dtype=torch.int32, device=As.device),
            p_r=torch.full((), inf, **kw), d_r=torch.full((), inf, **kw),
            b_r=torch.full((), inf, **kw), inner=None)

    # -- drivers ---------------------------------------------------------------
    def init_state(self, As, bs) -> BiCADMMState:
        """A fresh zero state."""
        return self._init_state(As, As.shape[2])

    def _run_while(self, factors, As, params: SolveParams,
                   st: BiCADMMState) -> BiCADMMState:
        cfg = self.cfg
        while True:
            converged = ((st.p_r < cfg.tol) & (st.d_r < cfg.tol)
                         & (st.b_r < cfg.tol))
            diverged = divergence_probe(st, cfg.divergence_tol)
            go = (~converged) & (~diverged) & (st.k < cfg.max_iter)
            if not bool(go):
                return st
            st = self._step(factors, As, params, st)

    def run_from(self, As, bs, state: BiCADMMState, *,
                 kappa=None) -> FitResult:
        """Run until the residual tolerances or max_iter, warm-starting
        from ``state`` (counter and residuals reset, iterates kept).
        ``kappa`` overrides the configured budget for this solve."""
        factors, N, n = self._setup(As, bs)
        params = self._make_params(N, kappa=kappa)
        st = self._run_while(factors, As, params, reset_for_resume(state))
        return self._finalize(As, bs, st, params)

    def fit(self, As, bs) -> FitResult:
        """``run_from`` a fresh zero state."""
        return self.run_from(As, bs, self.init_state(As, bs))

    def _finalize(self, As, bs, st: BiCADMMState,
                  params: SolveParams) -> FitResult:
        cfg = self.cfg
        z_sparse = bilinear.hard_threshold(st.z, params.kappa)
        support = torch.abs(z_sparse) > 0
        if cfg.polish:
            x_final = self._polish(As, bs, support, z_sparse, params)
        else:
            x_final = z_sparse
        coef = x_final.reshape(As.shape[2], 1)
        status = classify_status(st.k, st.p_r, st.d_r, st.b_r, tol=cfg.tol,
                                 divergence_tol=cfg.divergence_tol)
        return FitResult(coef, st.z, support, st.k, st.p_r, st.d_r, st.b_r,
                         None, st, status=status)

    def _polish(self, As, bs, support, z0, params: SolveParams):
        """Debias: the masked-ridge re-fit on the recovered support — a
        dense solve while the n x n Gram is small, matrix-free Jacobi-PCG
        on (A^T A + diag(pen + sigma)) beyond."""
        cfg = self.cfg
        N, m, n = As.shape
        sigma = N * params.sigma         # full-problem l2 weight = 1 / gamma
        pen = torch.where(support, 0.0, 1e8).to(As.dtype)
        A_all = As.reshape(N * m, n)
        b_all = bs.reshape(-1)
        if n <= prox.DENSE_MAX_N and cfg.x_solver in ("auto", "dense"):
            H = gram_auto(A_all) + torch.diag(pen + sigma)
            x = torch.linalg.solve(H, rmatvec_auto(A_all, b_all))
            return torch.where(support, x, 0.0)
        shift = pen + sigma
        inv = 1.0 / (prox.col_sumsq(A_all) + shift)
        x = prox.pcg(lambda p: normal_matvec_auto(A_all, p, shift),
                     rmatvec_auto(A_all, b_all), z0, lambda r: inv * r,
                     max(200, 2 * cfg.cg_iters), cfg.cg_tol)
        return torch.where(support, x, 0.0)

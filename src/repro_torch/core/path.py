"""Hyperparameter paths for Bi-cADMM (counterpart of ``repro.core.path``).

Deployments do not solve one ``(kappa, gamma, rho_c)`` instance: they sweep
the sparsity budget kappa, and often the ridge weight gamma, to pick a
model.

* :func:`fit_path` solves the grid points in order, each warm-started from
  the previous point's full ADMM state ``(x, u, z, t, s, v)``
  (``warm_start=False`` starts every point from the zero state: the
  sequential cold baseline, with the same numerics).
* :func:`fit_grid` solves every point from the zero state, all points at
  once on a lane axis (``strategy="vmap"``, the JAX package's ``vmap``):
  one masked loop over ``BiCADMM._lane_step`` until every point has
  stopped, each outer iteration's projections one launch for all points.
  The points share the dataset and its factors; the x-update takes every
  point's prox center as a column of one K = P product
  (``prox.x_solve_columns``), so A is never copied per point. Under the
  feature split (whose inner state and factors are per point) the grid
  runs as the sequential cold scan (``strategy="cold-scan"``).

The JAX package scans the points in one compiled ``lax.scan``; here the
scan is a Python loop over ``BiCADMM._run_while``. The grids stay on the
host, as tensors of the data dtype, and each point's kappa, gamma and rho_c
are read from there: the solo projection kernels take kappa as a number
(the grid's lanes read theirs on the device).

``gammas`` / ``rho_cs`` grids switch the squared loss's x-update to its
spectral factors (``NodeProxEngine(dynamic=True)``), set up once for the
whole sweep; the feature-split sub-solver bakes the penalties into its
factors and takes kappa grids only (``ValueError``). Under a penalty grid
sigma = 1/(N gamma) and rho_b = alpha rho_c are formed in the data dtype
from the grids, as the JAX package forms them; a kappa-only path keeps the
config's Python floats. Like the JAX package, the path runs on the data
as given: it applies no precision cast.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from fractions import Fraction

import numpy as np
import torch

from .bicadmm import BiCADMM, BiCADMMState, SolveParams, reset_for_resume
from .prox import newton_cg_prox_columns, x_solve_columns
from .results import SparsePath
from ..kernels.ops import matvec_auto


def _grids(solver: BiCADMM, kappas, gammas, rho_cs, dtype):
    """The three per-point grids as host tensors of ``dtype`` (config values
    fill the axes the caller did not sweep), and whether the penalties are
    swept."""
    cfg = solver.cfg

    def host(vals):
        return torch.as_tensor(vals).to("cpu", dtype)

    kaps = host(kappas)
    if kaps.ndim != 1 or kaps.shape[0] == 0:
        raise ValueError("kappas must be a non-empty 1-D grid")
    P = kaps.shape[0]
    dyn = gammas is not None or rho_cs is not None

    def fill(vals, default):
        arr = (torch.full((P,), default, dtype=dtype) if vals is None
               else host(vals))
        if tuple(arr.shape) != (P,):
            raise ValueError("gammas/rho_cs must match kappas' length")
        return arr

    return kaps, fill(gammas, cfg.gamma), fill(rho_cs, cfg.rho_c), dyn


def _point_outputs(solver: BiCADMM, As, bs, st, params) -> dict:
    """Finalize one grid point (threshold, polish, status) as the JAX
    package's compiled scan does, and its training loss; the predictions go
    through the matvec kernel, which reads bf16 / fp16 data in place. A
    lane state over per-lane data ``As`` (B, N, m, n) (the fleet) is
    finalized lane by lane in one pass: the outputs then carry the lane
    axis."""
    if st.z.ndim == 2:
        return _lane_outputs(solver, As, bs, st, params)
    res = solver._finalize(As, bs, st, params, compiled=True)
    n = As.shape[2]
    pred = matvec_auto(As.reshape(-1, n), res.coef)
    pred = pred[:, 0] if solver.loss.n_classes == 1 else pred
    return dict(x=res.x, z=res.z, support=res.support, iters=st.k,
                p_r=st.p_r, d_r=st.d_r, b_r=st.b_r,
                cardinality=torch.sum(res.support, dtype=torch.int32),
                status=res.status,
                train_loss=solver.loss.value(pred, bs.reshape(-1)))


def _lane_outputs(solver: BiCADMM, As, bs, st, params) -> dict:
    B, N, m, n = As.shape
    K = solver.loss.n_classes
    x, support, status = solver._finalize_lanes(As, bs, st, params)
    A_all = As.reshape(B, N * m, n)
    pred = matvec_auto(A_all, x.reshape(B, n, K))
    pred = pred[..., 0] if K == 1 else pred
    return dict(x=x, z=st.z, support=support, iters=st.k, p_r=st.p_r,
                d_r=st.d_r, b_r=st.b_r,
                cardinality=torch.sum(support, dim=1, dtype=torch.int32),
                status=status,
                train_loss=solver.loss.value_many(pred,
                                                  bs.reshape(B, N * m)))


def _pack(solver: BiCADMM, outs: list, kaps, gams, rhos, *, state=None,
          strategy: str) -> SparsePath:
    col = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    coef = col["x"].reshape(len(outs), -1, solver.loss.n_classes)
    return SparsePath(coef, col["z"], col["support"], col["iters"],
                      col["p_r"], col["d_r"], col["b_r"], col["cardinality"],
                      kaps, gams, rhos, train_loss=col["train_loss"],
                      state=state, strategy=strategy, status=col["status"])


def _scan(solver: BiCADMM, As, bs, kappas, gammas, rho_cs, *,
          warm_start: bool):
    kaps, gams, rhos, dyn = _grids(solver, kappas, gammas, rho_cs, As.dtype)
    factors, N, n = solver._setup(As, bs, dynamic_penalties=dyn)
    st0 = solver._init_state(As, n, solver.loss.n_classes)
    carry, outs = st0, []
    for i in range(kaps.shape[0]):
        kappa = kaps[i].item()
        kappa = int(kappa) if float(kappa).is_integer() else kappa
        # penalties as 0-d tensors only when swept: a kappa-only path uses
        # the same constants as a plain fit
        pen = dict(gamma=gams[i], rho_c=rhos[i]) if dyn else {}
        params = solver._make_params(N, kappa=kappa, **pen)
        st = solver._run_while(factors, As, bs, params,
                               reset_for_resume(carry))
        outs.append(_point_outputs(solver, As, bs, st, params))
        carry = st if warm_start else st0
    return outs, (kaps, gams, rhos), carry


def fit_path(solver: BiCADMM, As, bs, kappas, *, gammas=None, rho_cs=None,
             warm_start: bool = True) -> SparsePath:
    """Fit the whole hyperparameter path, point by point.

    Each point's loop starts from the previous point's final ADMM state
    (primal and dual), so later points typically need a fraction of a cold
    solve's iterations. Order the grid so that neighbours are alike: for
    kappa paths, descending kappa (dense -> sparse)."""
    outs, grids, last = _scan(solver, As, bs, kappas, gammas, rho_cs,
                              warm_start=warm_start)
    return _pack(solver, outs, *grids, state=last,
                 strategy="warm-scan" if warm_start else "cold-scan")


def fit_grid(solver: BiCADMM, As, bs, kappas, *, gammas=None,
             rho_cs=None) -> SparsePath:
    """Independent cold fits of every grid point, all points on a lane
    axis (``strategy="vmap"``; the sequential cold scan under the feature
    split). No state is returned."""
    if solver.cfg.use_feature_split:
        outs, grids, _ = _scan(solver, As, bs, kappas, gammas, rho_cs,
                               warm_start=False)
        return _pack(solver, outs, *grids, strategy="cold-scan")
    kaps, gams, rhos, dyn = _grids(solver, kappas, gammas, rho_cs, As.dtype)
    factors, N, n = solver._setup(As, bs, dynamic_penalties=dyn)
    P = kaps.shape[0]
    st0 = solver._init_state(As, n, solver.loss.n_classes)
    lanes = BiCADMMState(*(None if f is None else
                           f.expand((P,) + f.shape).clone() for f in st0))
    dt, dev = st0.z.dtype, As.device
    if dyn:   # formed in the grid dtype, as the scan's _make_params forms them
        cfg = solver.cfg
        rho_b = (torch.full_like(rhos, cfg.rho_b) if cfg.rho_b is not None
                 else cfg.alpha * rhos)
        params = SolveParams(kappa=kaps.to(dev, dt), rho_c=rhos.to(dev, dt),
                             rho_b=rho_b.to(dev, dt),
                             sigma=(1.0 / (N * gams)).to(dev, dt))
    else:
        params = solver._make_params(N)._replace(kappa=kaps.to(dev, dt))
    update = _grid_x_update(solver, factors, As, bs, params, P)
    st = solver._run_while_lanes(
        lambda s: solver._lane_step(update, params, s), lanes)
    outs = []
    for i in range(P):
        kappa = kaps[i].item()
        kappa = int(kappa) if float(kappa).is_integer() else kappa
        pen = dict(gamma=gams[i], rho_c=rhos[i]) if dyn else {}
        outs.append(_point_outputs(
            solver, As, bs, BiCADMMState(*(None if f is None else f[i]
                                           for f in st)),
            solver._make_params(N, kappa=kappa, **pen)))
    return _pack(solver, outs, kaps, gams, rhos, strategy="vmap")


def _grid_x_update(solver: BiCADMM, factors, As, bs, params, P: int):
    """The (7a) step of P grid points over one dataset ``As`` (N, m, n):
    the prox centers (P, N, d) as the columns of the shared factors'
    solves (squared loss) or of Newton-CG's products."""
    loss = solver.loss
    N, m, n = As.shape
    K = loss.n_classes

    def to_columns(v):            # (P, N, n K) -> (N, n, K P)
        return v.reshape(P, N, n, K).permute(1, 2, 3, 0).reshape(N, n, -1)

    def from_columns(v):          # (N, n, K P) -> (P, N, n K)
        return v.reshape(N, n, K, P).permute(3, 0, 1, 2).reshape(P, N, -1)

    if loss.name == "squared":
        def update(q, x_prev):
            return from_columns(x_solve_columns(
                factors, to_columns(q), params.rho_c, params.sigma,
                to_columns(x_prev)))
        return update

    def update(q, x_prev):
        return from_columns(newton_cg_prox_columns(
            loss, As, bs, to_columns(q), params.sigma, params.rho_c,
            newton_iters=solver.cfg.newton_iters))
    return update


# ------------------------------------------------------------ kappa_ladder --
# The JAX package rounds ``jnp.geomspace(lo, hi, num)``, which XLA computes
# in float32 on the CPU. Its integers are reproduced by replaying the same
# float32 operations: XLA's log (the Cephes polynomial it substitutes for
# logf), log10 as log(x) * f32(1/ln 10), the linspace as XLA's simplifier
# rewrites it (the division by num - 1 becomes a product with its f32
# reciprocal, stop * step is reassociated to iota * (log(stop) * f32(c/div)))
# with the fused multiply-adds of its code for the host, and the C library's
# powf. That code depends on div = num - 1. Up to 17 steps it is unrolled
# with constant lanes. Up to 79 the vector part is unrolled too: 8 lanes a
# vector, and below 56 steps one more vector of 4, so the compiler folds
# each lane's 1 - i * r into a constant (two roundings); the scalar tail
# after it computes that term with a fused multiply-add. From 80 steps on
# the vector part is a loop of 16 lanes a trip, which computes the term at
# run time with a fused multiply-add in every lane.
_F = np.float32
_LOG10_E = _F(0.4342944819032518)
_CEPHES_LOG = tuple(_F(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_UNROLLED = 17
# the folded vector lanes: div - div % 4 below this many steps, div - div %
# 8 from it, none from _VECTOR_LOOP on
_FOLD_BY_8 = 56
_VECTOR_LOOP = 80


def _f32_bits(x) -> int:
    return int(np.array([x], _F).view(np.uint32)[0])


def _fma(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    best = _F(float(exact))
    for cand in (np.nextafter(best, _F(-np.inf)),
                 np.nextafter(best, _F(np.inf))):
        d_c = abs(Fraction(float(cand)) - exact)
        d_b = abs(Fraction(float(best)) - exact)
        if d_c < d_b or (d_c == d_b and _f32_bits(cand) % 2 == 0):
            best = cand
    return _F(best)


def _xla_log(v) -> np.float32:
    """XLA's float32 log of a positive normal number (Cephes)."""
    f, (p0, p1, p2, p3, p4, p5, p6, p7, p8) = _F, _CEPHES_LOG
    bits = _f32_bits(f(v))
    x = np.array([(bits & 0x807FFFFF) | 0x3F000000], np.uint32).view(f)[0]
    e = f(f(1) + f((bits >> 23) - 0x7F))
    small = x < f(0.707106781186547524)
    x0 = x
    x = f(x - f(1))
    if small:
        e = f(e - f(1))
        x = f(x + x0)
    x2 = f(x * x)
    x3 = f(x2 * x)
    y = f(f(x * p0) + p1)
    y1 = f(f(x * p3) + p4)
    y2 = f(f(x * p6) + p7)
    y = f(f(y * x) + p2)
    y1 = f(f(y1 * x) + p5)
    y2 = f(f(y2 * x) + p8)
    y = f(f(y * x3) + y1)
    y = f(f(y * x3) + y2)
    y = f(f(y * x3) + f(_F(-2.12194440e-4) * e))
    x = f(f(x - f(f(0.5) * x2)) + y)
    return f(x + f(_F(0.693359375) * e))


def _powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib.powf


def _geomspace_f32(lo: int, hi: int, num: int) -> list:
    """``jnp.geomspace(lo, hi, num)``'s float32 values on the CPU."""
    log_lo, log_hi = _xla_log(lo), _xla_log(hi)
    a = _F(log_lo * _LOG10_E)
    lin = [a]
    if num > 1:
        div = num - 1
        r = _F(_F(1) / _F(div))
        xs = _F(log_hi * _F(_LOG10_E * r))
        if div <= _UNROLLED:
            folded = div
        elif div < _FOLD_BY_8:
            folded = div - div % 4
        elif div < _VECTOR_LOOP:
            folded = div - div % 8
        else:
            folded = 0
        lin = []
        for i in range(div):
            it = _F(i)
            if i >= folded:            # computed at run time
                lin.append(_fma(it, xs, _F(a * _fma(-it, r, _F(1)))))
                continue
            sub = _F(_F(1) - _F(it * r))
            lin.append(_fma(a, sub, xs) if div <= _UNROLLED and i == 1
                       else _fma(it, xs, _F(a * sub)))
        lin.append(_F(log_hi * _LOG10_E))
    powf = _powf()
    return [_F(powf(_F(10), v)) for v in lin]


def kappa_ladder(n_features: int, num: int = 8, *, lo_frac: float = 0.05,
                 hi_frac: float = 0.5, descending: bool = True) -> list[int]:
    """``num`` distinct integer budgets geometrically spaced in
    [lo_frac, hi_frac] * n_features: the JAX package's grid, integer for
    integer."""
    lo = max(1, round(lo_frac * n_features))
    hi = max(lo + 1, round(hi_frac * n_features))
    ks = sorted({max(1, int(round(float(k))))
                 for k in _geomspace_f32(lo, hi, num)})
    return ks[::-1] if descending else ks

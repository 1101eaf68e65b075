"""Hyperparameter paths for Bi-cADMM (counterpart of ``repro.core.path``).

Deployments do not solve one ``(kappa, gamma, rho_c)`` instance: they sweep
the sparsity budget kappa, and often the ridge weight gamma, to pick a
model.

* :func:`fit_path` solves the grid points in order, each warm-started from
  the previous point's full ADMM state ``(x, u, z, t, s, v)``
  (``warm_start=False`` starts every point from the zero state: the
  sequential cold baseline, with the same numerics).
* :func:`fit_grid` solves every point from the zero state. The JAX package
  batches these fits on a ``vmap`` lane axis; the port has no lane axis
  yet, so it runs them as the sequential cold scan, as the JAX package's
  sharded engine does, and the result says so (``strategy="cold-scan"``).

The JAX package scans the points in one compiled ``lax.scan``; here the
scan is a Python loop over ``BiCADMM._run_while``. The grids stay on the
host, as tensors of the data dtype, and each point's kappa, gamma and rho_c
are read from there: the projection kernels take kappa as a number.

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

from .bicadmm import BiCADMM, reset_for_resume
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
    through the matvec kernel, which reads bf16 / fp16 data in place."""
    res = solver._finalize(As, bs, st, params, compiled=True)
    n = As.shape[2]
    pred = matvec_auto(As.reshape(-1, n), res.coef)
    pred = pred[:, 0] if solver.loss.n_classes == 1 else pred
    return dict(x=res.x, z=res.z, support=res.support, iters=st.k,
                p_r=st.p_r, d_r=st.d_r, b_r=st.b_r,
                cardinality=torch.sum(res.support, dtype=torch.int32),
                status=res.status,
                train_loss=solver.loss.value(pred, bs.reshape(-1)))


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
    """Independent cold fits of every grid point, run as the sequential
    cold scan (no lane axis in the port yet): the same numerics as
    ``fit_path(..., warm_start=False)``, no state returned."""
    outs, grids, _ = _scan(solver, As, bs, kappas, gammas, rho_cs,
                           warm_start=False)
    return _pack(solver, outs, *grids, strategy="cold-scan")


# ------------------------------------------------------------ kappa_ladder --
# The JAX package rounds ``jnp.geomspace(lo, hi, num)``, which XLA computes
# in float32 on the CPU. Its integers are reproduced by replaying the same
# float32 operations: XLA's log (the Cephes polynomial it substitutes for
# logf), log10 as log(x) * f32(1/ln 10), the linspace as XLA's simplifier
# rewrites it (the division by num - 1 becomes a product with its f32
# reciprocal, stop * step is reassociated to iota * (log(stop) * f32(c/div)))
# with the fused multiply-adds of its code for the host (the grid up to 17
# steps unrolled with constant lanes; past that a vector loop and a scalar
# tail of (num - 1) % 4 steps), and the C library's powf.
_F = np.float32
_LOG10_E = _F(0.4342944819032518)
_CEPHES_LOG = tuple(_F(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_UNROLLED = 17


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
        vector = div - div % 4 if div > _UNROLLED else div
        lin = []
        for i in range(div):
            it = _F(i)
            if i >= vector:            # the scalar tail
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

"""Prox engines for the Bi-cADMM x-update (counterpart of
``repro.core.prox``).

x_i^{k+1} = argmin_x 1/2||A_i x - b_i||^2 + sigma/2 ||x||^2
            + rho_c/2 ||x - q_i||^2,   q = z^k - u_i^k, sigma = 1/(N gamma),

i.e. the linear solve ``(A^T A + c I) x = A^T b + rho_c q`` with
c = sigma + rho_c. Every function here takes the nodes stacked on a leading
axis — ``A`` (N, m, n), ``b`` (N, m), ``q`` (N, n) — where the JAX package
``vmap``s a per-node function; the kernels take that axis in their grid and
``torch.linalg`` batches over it.

================  =============  ==========  ===========  =================
backend           setup          per-solve   memory       regime
================  =============  ==========  ===========  =================
``dense``         O(m n^2+n^3)   O(n^2)      O(n^2)       n <= DENSE_MAX_N
``woodbury``      O(m^2 n+m^3)   O(m n)      O(m n+m^2)   m < n
``pcg``           O(m n)         O(k m n)    O(m n)       both large
================  =============  ==========  ===========  =================

The other losses take :func:`newton_cg_prox`, a matrix-free Newton-CG on
the ``matvec`` / ``rmatvec`` kernels.

Cholesky factorizations, eigendecompositions and triangular solves go to
``torch.linalg``, as the JAX package leaves them to XLA outside any Pallas
kernel. ``NodeProxEngine(dynamic=True)`` takes the spectral (eigh) factors
of A^T A or A A^T in place of the Cholesky ones, so that sigma and rho_c
may change from solve to solve (the path engine's gamma / rho_c grids)
without a new factorization; their n x n or m x m products with V or U are
``torch.matmul`` calls, the A-products the kernels.

Reduced-precision data (bf16 / fp16 ``A``, the ``"bf16"`` / ``"fp16"``
presets) is read in place by the kernels; every factor, Gram, A^T b and the
Jacobi diagonal is built in f32 (:func:`_accum`, as the JAX package's
``_accum``), and the f32 iterates promote every other product to f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .bilinear import CHUNK
from .. import runtime
from ..kernels.ops import (chol_rank_update_auto, gram_auto, matvec_auto,
                           normal_matvec_auto, rmatvec_auto)

DENSE_MAX_N = 2048
WOODBURY_MAX_M = 8192
XSOLVERS = ("auto", "dense", "woodbury", "pcg")


def _accum(dtype: torch.dtype) -> torch.dtype:
    """Factor / accumulation dtype for ``dtype`` data: f32 for bf16 / fp16,
    ``dtype`` itself otherwise (so the f32 set-ups are unchanged)."""
    return torch.float32 if dtype in runtime.REDUCED else dtype


def _eye(k: int, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=dtype, device=like.device)


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (N, k, l) @ (N, l) -> (N, k)."""
    return (M @ v[..., None])[..., 0]


def _eigh(G: torch.Tensor):
    """(evals, V) of a batch of symmetric Grams, computed in f64 and
    returned in G's dtype. The JAX package takes an f32 eigh; torch's
    batched f32 eigh on the card (cuSOLVER's Jacobi routine) leaves ~5e-6
    relative error in the Woodbury solves where the CPU's LAPACK leaves
    ~2e-7, and moved a card-against-CPU parity fit by 9 iterations; the f64
    eigh leaves 1.2e-7, the static Cholesky solve's error."""
    evals, V = torch.linalg.eigh(G.to(torch.float64))
    return evals.to(G.dtype), V.to(G.dtype)


def _tri_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs for a batch of lower factors and (N, k) rhs."""
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]


# ---------------------------------------------------------------- dense ----
@dataclasses.dataclass(frozen=True)
class RidgeFactors:
    """Cached Cholesky factors of the squared-loss prox, per node."""
    chol: torch.Tensor   # (N, n, n) lower factor of A^T A + c I
    Atb: torch.Tensor    # (N, n)
    c: float             # sigma + rho_c


def ridge_setup(A, b, sigma: float, rho_c: float) -> RidgeFactors:
    """Factor once per dataset; the Gram matrix runs through the gram
    kernel on the card."""
    c = sigma + rho_c
    acc = _accum(A.dtype)
    G = gram_auto(A, out_dtype=acc) + c * _eye(A.shape[-1], acc, A)
    return RidgeFactors(torch.linalg.cholesky(G),
                        rmatvec_auto(A, b, out_dtype=acc), c)


def ridge_prox_factorized(f: RidgeFactors, q, rho_c) -> torch.Tensor:
    """(A^T A + (sigma+rho_c) I)^{-1} (A^T b + rho_c q)."""
    return _tri_solve(f.chol, f.Atb + rho_c * q)


@dataclasses.dataclass(frozen=True)
class EighRidgeFactors:
    """Spectral factors of A^T A per node: (A^T A + c I)^{-1} rhs for any
    shift c given at solve time."""
    V: torch.Tensor      # (N, n, n) orthonormal eigenvectors of A^T A
    evals: torch.Tensor  # (N, n) eigenvalues (>= 0)
    Atb: torch.Tensor    # (N, n)


def ridge_setup_eigh(A, b) -> EighRidgeFactors:
    """eigh of the gram kernel's A^T A (f32 for bf16 / fp16 data)."""
    acc = _accum(A.dtype)
    evals, V = _eigh(gram_auto(A, out_dtype=acc))
    return EighRidgeFactors(V, evals, rmatvec_auto(A, b, out_dtype=acc))


def ridge_prox_eigh(f: EighRidgeFactors, q, rho_c, sigma) -> torch.Tensor:
    """:func:`ridge_prox_factorized` with the shift sigma + rho_c given at
    solve time: x = V diag(1/(evals + c)) V^T (A^T b + rho_c q)."""
    rhs = f.Atb + rho_c * q
    return _bmv(f.V, _bmv(f.V.mT, rhs) / (f.evals + sigma + rho_c))


# ------------------------------------------------------------ woodbury ----
@dataclasses.dataclass(frozen=True)
class WoodburyFactors:
    """Dual (m x m) factors: exact squared-loss prox in O(m n) per solve
    without forming the n x n Gram."""
    A: torch.Tensor      # (N, m, n) data, by reference
    chol: torch.Tensor   # (N, m, m) lower factor of A A^T + c I
    Atb: torch.Tensor    # (N, n)
    c: float


def woodbury_setup(A, b, sigma: float, rho_c: float) -> WoodburyFactors:
    """Factor (A A^T + c I) once; A A^T is the gram kernel on the
    transposed view of A (no copy)."""
    c = sigma + rho_c
    acc = _accum(A.dtype)
    G = gram_auto(A.mT, out_dtype=acc) + c * _eye(A.shape[-2], acc, A)
    return WoodburyFactors(A, torch.linalg.cholesky(G),
                           rmatvec_auto(A, b, out_dtype=acc), c)


def woodbury_prox(f: WoodburyFactors, q, rho_c) -> torch.Tensor:
    """x = (rhs - A^T (A A^T + c I)^{-1} A rhs) / c, rhs = A^T b + rho_c q."""
    rhs = f.Atb + rho_c * q
    y = _tri_solve(f.chol, matvec_auto(f.A, rhs))
    return (rhs - rmatvec_auto(f.A, y)) / f.c


@dataclasses.dataclass(frozen=True)
class WoodburyEighFactors:
    """Spectral dual factors of A A^T per node: the Woodbury counterpart of
    :class:`EighRidgeFactors`, any shift c at solve time."""
    A: torch.Tensor      # (N, m, n) data, by reference
    U: torch.Tensor      # (N, m, m) orthonormal eigenvectors of A A^T
    evals: torch.Tensor  # (N, m) eigenvalues (>= 0)
    Atb: torch.Tensor    # (N, n)


def woodbury_setup_eigh(A, b) -> WoodburyEighFactors:
    """eigh of A A^T, the gram kernel on the transposed view of A."""
    acc = _accum(A.dtype)
    evals, U = _eigh(gram_auto(A.mT, out_dtype=acc))
    return WoodburyEighFactors(A, U, evals,
                               rmatvec_auto(A, b, out_dtype=acc))


def _woodbury_eigh_solve(f: WoodburyEighFactors, rhs, c) -> torch.Tensor:
    y = _bmv(f.U, _bmv(f.U.mT, matvec_auto(f.A, rhs)) / (f.evals + c))
    return (rhs - rmatvec_auto(f.A, y)) / c


def woodbury_prox_eigh(f: WoodburyEighFactors, q, rho_c,
                       sigma) -> torch.Tensor:
    """Spectral dual solve with one refinement pass, as the JAX package's:
    solve, form the residual of (A^T A + c I) x = rhs, solve for the
    correction. The residual's A^T (A x0) + c x0 is one ``normal_matvec``
    (one pass over A on the card; on the CPU the same sums as the
    ``matvec`` and ``rmatvec`` composition)."""
    c = sigma + rho_c
    rhs = f.Atb + rho_c * q
    x0 = _woodbury_eigh_solve(f, rhs, c)
    r = rhs - normal_matvec_auto(f.A, x0, c)
    return x0 + _woodbury_eigh_solve(f, r, c)


# ----------------------------------------------------------------- pcg ----
def col_sumsq(A: torch.Tensor) -> torch.Tensor:
    """Per-column sum of squares — diag(A^T A), the Jacobi preconditioner.
    Summed over chunks of about 2^24 elements of A, so no temporary of A's
    size is made (A may fill a good part of the card). bf16 / fp16 data is
    summed and emitted in f32 (each chunk widened on its own)."""
    acc = _accum(A.dtype)
    row_size = math.prod(A.shape[:-2]) * A.shape[-1]
    rows = max(1, 2 ** 24 // max(1, row_size))
    out = torch.zeros(A.shape[:-2] + A.shape[-1:], dtype=acc,
                      device=A.device)
    for i in range(0, A.shape[-2], rows):
        chunk = A[..., i:i + rows, :].to(acc)
        out += torch.einsum("...mn,...mn->...n", chunk, chunk)
    return out


@dataclasses.dataclass(frozen=True)
class CGFactors:
    """Matrix-free backend state: no factorization, O(m n) setup."""
    A: torch.Tensor      # (N, m, n) data, by reference
    Atb: torch.Tensor    # (N, n)
    diag: torch.Tensor   # (N, n) diag(A^T A)
    iters: int
    tol: float


def cg_setup(A, b, iters: int = 200, tol: float = 1e-6) -> CGFactors:
    return CGFactors(A, rmatvec_auto(A, b, out_dtype=_accum(A.dtype)),
                     col_sumsq(A), iters, tol)


def _dot(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * w, dim=-1)


def pcg(matvec: Callable, rhs: torch.Tensor, x0: torch.Tensor,
        precond: Callable, iters: int, tol: float,
        dot_fn: Callable | None = None) -> torch.Tensor:
    """Preconditioned conjugate gradients with a relative-residual stop,
    warm-started at ``x0``. A leading axis holds independent systems (the
    nodes): each stops on its own — a finished system's iterates are
    frozen, which is how the JAX package's vmapped ``while_loop`` behaves.
    The host reads the stopping test once per CG iteration. ``dot_fn``
    replaces every inner product (the sharded engine's dot over its feature
    blocks; ``repro.core.prox.pcg``)."""
    dot = _dot if dot_fn is None else dot_fn
    r0 = rhs - matvec(x0)
    z0 = precond(r0)
    rz = dot(r0, z0)
    tol2 = tol * tol * torch.clamp_min(dot(rhs, rhs), 1e-30)
    x, r, p, rr = x0, r0, z0, dot(r0, r0)
    for _ in range(iters):
        active = rr > tol2
        if not bool(active.any()):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(dot(p, Ap), 1e-30)
        x_n = x + alpha[..., None] * p
        r_n = r - alpha[..., None] * Ap
        z = precond(r_n)
        rz_n = dot(r_n, z)
        p_n = z + (rz_n / torch.clamp_min(rz, 1e-30))[..., None] * p
        keep = active[..., None]
        x = torch.where(keep, x_n, x)
        r = torch.where(keep, r_n, r)
        p = torch.where(keep, p_n, p)
        rz = torch.where(active, rz_n, rz)
        rr = torch.where(active, dot(r_n, r_n), rr)
    return x


def pcg_prox(f: CGFactors, q, rho_c, sigma, x0=None) -> torch.Tensor:
    """Matrix-free exact prox by Jacobi-PCG, warm-started at ``x0``."""
    c = sigma + rho_c
    rhs = f.Atb + rho_c * q
    inv = 1.0 / (f.diag + c)
    x0 = q if x0 is None else x0
    return pcg(lambda p: normal_matvec_auto(f.A, p, c), rhs, x0,
               lambda r: inv * r, f.iters, f.tol)


# ------------------------------------------- incremental factor updates ----
# The streaming engine (core/streaming.py) keeps the squared-loss factors
# exact under row arrival without refactorizing: k new rows are a rank-k
# UPDATE of the n x n ridge factor chol(A^T A + c I), rows evicted from a
# sliding window a rank-k DOWNDATE, and the m x m Woodbury dual factor
# chol(A A^T + c I) grows by a bordered APPEND (repro.core.prox :360-462).
# The rotations run on the chol_rank_update kernel (csrc/chol_update.cu);
# the append is a triangular solve and a small Cholesky, as in JAX.


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``M``; NaN where ``M`` is not numerically
    positive definite (as ``jnp.linalg.cholesky`` returns it), never an
    exception, and no host read."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, math.nan)


def chol_update(L: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Rank-k update: the lower factor of ``L L^T + V V^T`` for V (n, k) or
    (n,) (``repro.core.prox.chol_update``). An update cannot fail."""
    return chol_rank_update_auto(L, V, 1.0)[0]


def chol_downdate(L: torch.Tensor, V: torch.Tensor):
    """Rank-k downdate: ``(L', ok)`` with L' L'^T = L L^T - V V^T; ``ok``
    (a 0-d bool tensor) is False when a pivot lost definiteness and L' is
    then garbage (``repro.core.prox.chol_downdate``)."""
    return chol_rank_update_auto(L, V, -1.0)


def chol_append(L: torch.Tensor, M12: torch.Tensor,
                M22: torch.Tensor) -> torch.Tensor:
    """The (p+q, p+q) lower factor of ``[[M11, M12], [M12^T, M22]]`` given
    ``L = chol(M11)``: one triangular solve and a q x q factorization
    (``repro.core.prox.chol_append``)."""
    L21 = torch.linalg.solve_triangular(L, M12, upper=False).mT
    L22 = cholesky(M22 - L21 @ L21.mT)
    p, q = L.shape[0], M22.shape[0]
    top = torch.cat([L, torch.zeros((p, q), dtype=L.dtype,
                                    device=L.device)], dim=1)
    return torch.cat([top, torch.cat([L21, L22], dim=1)], dim=0)


# ------------------------------------------------------------ newton-cg ----
def _bdot(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-system inner products over every axis but the leading one."""
    return torch.sum((u * w).flatten(1), dim=1)


def _cg(matvec: Callable, rhs: torch.Tensor, iters: int,
        tol: float = 1e-10) -> torch.Tensor:
    """Plain conjugate gradients from 0 with at most ``iters`` steps, each
    system stopping once its squared residual is at most ``tol``.

    ``rhs`` holds independent systems along its leading axis (the nodes):
    a finished system's iterates are frozen, as the JAX package's vmapped
    ``while_loop`` leaves them. The host reads the stopping test once per
    ``CHUNK[device]`` steps.
    """
    def col(v):                      # (B,) -> broadcastable against rhs
        return v.reshape((-1,) + (1,) * (rhs.ndim - 1))

    x, r, p = torch.zeros_like(rhs), rhs, rhs
    rs = _bdot(rhs, rhs)
    chunk = CHUNK[rhs.device.type]
    k = 0
    while k < iters:
        for _ in range(min(chunk, iters - k)):
            active = rs > tol
            Ap = matvec(p)
            alpha = rs / torch.clamp_min(_bdot(p, Ap), 1e-30)
            x_n = x + col(alpha) * p
            r_n = r - col(alpha) * Ap
            rs_n = _bdot(r_n, r_n)
            p_n = r_n + col(rs_n / torch.clamp_min(rs, 1e-30)) * p
            keep = col(active)
            x = torch.where(keep, x_n, x)
            r = torch.where(keep, r_n, r)
            p = torch.where(keep, p_n, p)
            rs = torch.where(active, rs_n, rs)
            k += 1
        if not bool((rs > tol).any()):
            break
    return x


# the losses whose gradient is elementwise in pred: the directional
# derivative of that gradient is the same expression by reverse mode as by
# forward mode, op for op (each op's reverse formula is its forward formula,
# a product by a constant commutes), so the two agree bit for bit
# (tests/test_torch_leftovers.py); reverse mode runs in C++, where
# torch.func.jvp takes Python decompositions of each op (~20 times slower a
# product, most of a Newton-CG fit's host time)
_ELEMENTWISE_GRADS = ("squared", "logistic", "hinge", "smoothed_hinge")


def grad_tangent(loss, pred: torch.Tensor, b: torch.Tensor) -> Callable:
    """``t -> (d loss.grad / d pred)[t]`` at ``pred``: the second
    derivative in a Gauss-Newton Hessian-vector product, as the JAX package
    takes it by ``jax.jvp``. For the elementwise registry losses one
    recorded graph of the gradient serves every product (reverse mode, the
    same bits as forward mode); else ``torch.func.jvp`` a product."""
    if loss.name not in _ELEMENTWISE_GRADS:
        return lambda t: torch.func.jvp(lambda pr: loss.grad(pr, b),
                                        (pred,), (t,))[1]
    leaf = pred.detach().requires_grad_(True)
    with torch.enable_grad():
        g = loss.grad(leaf, b)
    if not g.requires_grad:          # a piecewise-constant gradient
        return torch.zeros_like
    return lambda t: torch.autograd.grad(g, leaf, grad_outputs=t,
                                         retain_graph=True)[0]


def newton_cg_prox(loss, A, b, q, sigma: float, rho_c: float,
                   newton_iters: int = 15, cg_iters: int = 50
                   ) -> torch.Tensor:
    """Matrix-free Newton-CG for
    argmin_x l(A x, b) + sigma/2 ||x||^2 + rho_c/2 ||x - q||^2, per node.

    ``A`` (N, m, n), ``b`` (N, m), ``q`` (N, n) or (N, n, C) for a C-class
    loss. The Hessian-vector product is the Gauss form
    A^T (d grad / d pred)[A p] + (sigma + rho_c) p, with the loss's second
    derivative taken by :func:`grad_tangent`, as the JAX package takes
    ``jax.jvp``. Every A-product runs through the ``matvec`` / ``rmatvec``
    kernels.
    """
    x = q
    for _ in range(newton_iters):
        pred = matvec_auto(A, x)
        g = rmatvec_auto(A, loss.grad(pred, b)) + sigma * x + rho_c * (x - q)
        dgrad = grad_tangent(loss, pred, b)

        def hvp(p, dgrad=dgrad):
            return rmatvec_auto(A, dgrad(matvec_auto(A, p))) + (
                sigma + rho_c) * p

        x = x - _cg(hvp, g, cg_iters)
    return x


def direct_prox(loss, A, b, q, sigma: float, rho_c: float,
                ridge: RidgeFactors | None = None) -> torch.Tensor:
    """Closed form for the squared loss (from ``ridge_setup`` factors),
    Newton-CG otherwise."""
    if loss.name == "squared":
        if ridge is None:
            raise ValueError("the squared loss needs ridge_setup factors")
        return ridge_prox_factorized(ridge, q, rho_c)
    return newton_cg_prox(loss, A, b, q, sigma, rho_c)


# ------------------------------------------ shared factors, many points ----
def _columns(v):
    """A per-point (P,) tensor as a (1, 1, P) row over column-form
    operands (N, k, P); a Python scalar as is."""
    return v.reshape(1, 1, -1) if torch.is_tensor(v) else v


def x_solve_columns(factors, Q, rho_c, sigma, X0=None) -> torch.Tensor:
    """:func:`x_solve` of P problems that share one dataset (a grid's
    points): the prox centers in column form ``Q`` (N, n, P), each point's
    ``rho_c`` / ``sigma`` a Python scalar shared by all or a (P,) tensor.
    The factors are the dataset's own, set up once; every A-product takes
    the P columns at once (the ``matvec`` / ``rmatvec`` kernels' K > 1
    form), so the data is never copied per point. Returns (N, n, P)."""
    rc, sg = _columns(rho_c), _columns(sigma)
    if isinstance(factors, (RidgeFactors, EighRidgeFactors,
                            WoodburyFactors, WoodburyEighFactors,
                            CGFactors)):
        rhs = factors.Atb[..., None] + rc * Q
    if isinstance(factors, RidgeFactors):
        y = torch.linalg.solve_triangular(factors.chol, rhs, upper=False)
        return torch.linalg.solve_triangular(factors.chol.mT, y, upper=True)
    if isinstance(factors, EighRidgeFactors):
        V = factors.V
        return V @ ((V.mT @ rhs) / (factors.evals[..., None] + sg + rc))
    if isinstance(factors, WoodburyFactors):
        t = matvec_auto(factors.A, rhs)
        y = torch.linalg.solve_triangular(factors.chol, t, upper=False)
        y = torch.linalg.solve_triangular(factors.chol.mT, y, upper=True)
        return (rhs - rmatvec_auto(factors.A, y)) / factors.c
    if isinstance(factors, WoodburyEighFactors):
        c = sg + rc
        U, A = factors.U, factors.A

        def solve(r):
            y = U @ ((U.mT @ matvec_auto(A, r)) / (factors.evals[..., None]
                                                   + c))
            return (r - rmatvec_auto(A, y)) / c

        x0 = solve(rhs)
        return x0 + solve(rhs - normal_matvec_auto(A, x0, c))
    if isinstance(factors, CGFactors):
        c = sg + rc
        c_sys = c.reshape(1, -1, 1) if torch.is_tensor(c) else c
        inv = 1.0 / (factors.diag[:, None, :] + c_sys)     # (N, P, n)
        x0 = (Q if X0 is None else X0).mT
        x = pcg(lambda p: normal_matvec_auto(factors.A, p.mT, c).mT,
                rhs.mT, x0, lambda r: inv * r, factors.iters, factors.tol)
        return x.mT
    raise TypeError(f"unknown x-update factor type {type(factors)!r}")


def newton_cg_prox_columns(loss, A, b, Q, sigma, rho_c,
                           newton_iters: int = 15, cg_iters: int = 50
                           ) -> torch.Tensor:
    """:func:`newton_cg_prox` of P points that share one dataset: ``Q``
    (N, n, C P) in column form (point p of class c in column c P + p; C = 1
    for the margin losses), per-point ``sigma`` / ``rho_c`` scalars or
    (P,) tensors. Every A-product is one K = C P product; each (node,
    point) is its own CG system, as the JAX package's vmapped loops leave
    it."""
    N, n, CP = Q.shape
    C = loss.n_classes
    P = CP // C

    def per_col(v):
        return v.repeat(C).reshape(1, 1, CP) if torch.is_tensor(v) else v

    sg, rc = per_col(sigma), per_col(rho_c)
    bb = b[:, :, None]

    def classes_last(cols):       # (N, m, C P) -> (N, m, P[, C])
        v = cols.reshape(N, -1, C, P).permute(0, 1, 3, 2)
        return v[..., 0] if C == 1 else v

    def columns(v):               # (N, m, P[, C]) -> (N, m, C P)
        v = v[..., None] if C == 1 else v
        return v.permute(0, 1, 3, 2).reshape(N, -1, CP)

    def grad(pred_cols):
        return columns(loss.grad(classes_last(pred_cols), bb))

    def systems(X):               # (N, n, C P) -> (N P, n C)
        return X.reshape(N, n, C, P).permute(0, 3, 1, 2).reshape(N * P, -1)

    def unsystems(S):
        return S.reshape(N, P, n, C).permute(0, 2, 3, 1).reshape(N, n, CP)

    x = Q
    for _ in range(newton_iters):
        pred = matvec_auto(A, x)
        g = rmatvec_auto(A, grad(pred)) + sg * x + rc * (x - Q)
        dgrad = grad_tangent(loss, classes_last(pred), bb)

        def hvp(p, dgrad=dgrad):
            pc = unsystems(p)
            dlg = columns(dgrad(classes_last(matvec_auto(A, pc))))
            return systems(rmatvec_auto(A, dlg) + (sg + rc) * pc)

        x = x - unsystems(_cg(hvp, systems(g), cg_iters))
    return x


# ------------------------------------------------- the unified engine ----
@dataclasses.dataclass(frozen=True)
class NodeProxEngine:
    """Squared-loss x-update engine: resolves the ``x_solver`` policy,
    builds the stacked per-node factors once and solves every iteration.
    ``dynamic`` takes the spectral factors of the dense and Woodbury
    backends, so sigma and rho_c may change between solves."""
    kind: str                 # "dense" | "woodbury" | "pcg"
    dynamic: bool = False
    cg_iters: int = 200
    cg_tol: float = 1e-6

    @staticmethod
    def choose(m: int, n: int, *, x_solver: str = "auto",
               dynamic: bool = False, cg_iters: int = 200,
               cg_tol: float = 1e-6) -> "NodeProxEngine":
        """Dense factors while the n x n Gram is cheap, the m x m Woodbury
        dual when samples are the short axis, matrix-free PCG otherwise."""
        if x_solver not in XSOLVERS:
            raise ValueError(f"unknown x_solver {x_solver!r}; "
                             f"expected one of {XSOLVERS}")
        kind = x_solver
        if kind == "auto":
            if n <= DENSE_MAX_N:
                kind = "dense"
            elif m <= WOODBURY_MAX_M and m < n:
                kind = "woodbury"
            else:
                kind = "pcg"
        return NodeProxEngine(kind, bool(dynamic), cg_iters, cg_tol)

    def setup(self, A, b, sigma: float, rho_c: float):
        """Stacked per-node factors for A (N, m, n), b (N, m)."""
        if self.kind == "dense":
            return (ridge_setup_eigh(A, b) if self.dynamic
                    else ridge_setup(A, b, sigma, rho_c))
        if self.kind == "woodbury":
            return (woodbury_setup_eigh(A, b) if self.dynamic
                    else woodbury_setup(A, b, sigma, rho_c))
        return cg_setup(A, b, self.cg_iters, self.cg_tol)

    def solve(self, factors, q, rho_c, sigma, x0=None) -> torch.Tensor:
        return x_solve(factors, q, rho_c, sigma, x0)


def x_solve(factors, q, rho_c, sigma, x0=None) -> torch.Tensor:
    """Backend dispatch on the factor type; ``x0`` warm-starts PCG only."""
    if isinstance(factors, RidgeFactors):
        return ridge_prox_factorized(factors, q, rho_c)
    if isinstance(factors, EighRidgeFactors):
        return ridge_prox_eigh(factors, q, rho_c, sigma)
    if isinstance(factors, WoodburyFactors):
        return woodbury_prox(factors, q, rho_c)
    if isinstance(factors, WoodburyEighFactors):
        return woodbury_prox_eigh(factors, q, rho_c, sigma)
    if isinstance(factors, CGFactors):
        return pcg_prox(factors, q, rho_c, sigma, x0)
    raise TypeError(f"unknown x-update factor type {type(factors)!r}")

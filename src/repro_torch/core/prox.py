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

Cholesky factorizations and triangular solves go to ``torch.linalg``, as the
JAX package leaves them to XLA outside any Pallas kernel. The spectral
(eigh) variants for traced penalties wait for the path-engine slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..kernels.ops import (gram_auto, matvec_auto, normal_matvec_auto,
                           rmatvec_auto)

DENSE_MAX_N = 2048
WOODBURY_MAX_M = 8192
XSOLVERS = ("auto", "dense", "woodbury", "pcg")


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


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
    G = gram_auto(A) + c * _eye(A.shape[-1], A)
    return RidgeFactors(torch.linalg.cholesky(G), rmatvec_auto(A, b), c)


def ridge_prox_factorized(f: RidgeFactors, q, rho_c) -> torch.Tensor:
    """(A^T A + (sigma+rho_c) I)^{-1} (A^T b + rho_c q)."""
    return _tri_solve(f.chol, f.Atb + rho_c * q)


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
    G = gram_auto(A.mT) + c * _eye(A.shape[-2], A)
    return WoodburyFactors(A, torch.linalg.cholesky(G), rmatvec_auto(A, b), c)


def woodbury_prox(f: WoodburyFactors, q, rho_c) -> torch.Tensor:
    """x = (rhs - A^T (A A^T + c I)^{-1} A rhs) / c, rhs = A^T b + rho_c q."""
    rhs = f.Atb + rho_c * q
    y = _tri_solve(f.chol, matvec_auto(f.A, rhs))
    return (rhs - rmatvec_auto(f.A, y)) / f.c


# ----------------------------------------------------------------- pcg ----
def col_sumsq(A: torch.Tensor) -> torch.Tensor:
    """Per-column sum of squares — diag(A^T A), the Jacobi preconditioner."""
    return torch.einsum("...mn,...mn->...n", A, A)


@dataclasses.dataclass(frozen=True)
class CGFactors:
    """Matrix-free backend state: no factorization, O(m n) setup."""
    A: torch.Tensor      # (N, m, n) data, by reference
    Atb: torch.Tensor    # (N, n)
    diag: torch.Tensor   # (N, n) diag(A^T A)
    iters: int
    tol: float


def cg_setup(A, b, iters: int = 200, tol: float = 1e-6) -> CGFactors:
    return CGFactors(A, rmatvec_auto(A, b), col_sumsq(A), iters, tol)


def _dot(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * w, dim=-1)


def pcg(matvec: Callable, rhs: torch.Tensor, x0: torch.Tensor,
        precond: Callable, iters: int, tol: float) -> torch.Tensor:
    """Preconditioned conjugate gradients with a relative-residual stop,
    warm-started at ``x0``. A leading axis holds independent systems (the
    nodes): each stops on its own — a finished system's iterates are
    frozen, which is how the JAX package's vmapped ``while_loop`` behaves.
    The host reads the stopping test once per CG iteration."""
    r0 = rhs - matvec(x0)
    z0 = precond(r0)
    rz = _dot(r0, z0)
    tol2 = tol * tol * torch.clamp_min(_dot(rhs, rhs), 1e-30)
    x, r, p, rr = x0, r0, z0, _dot(r0, r0)
    for _ in range(iters):
        active = rr > tol2
        if not bool(active.any()):
            break
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(_dot(p, Ap), 1e-30)
        x_n = x + alpha[..., None] * p
        r_n = r - alpha[..., None] * Ap
        z = precond(r_n)
        rz_n = _dot(r_n, z)
        p_n = z + (rz_n / torch.clamp_min(rz, 1e-30))[..., None] * p
        keep = active[..., None]
        x = torch.where(keep, x_n, x)
        r = torch.where(keep, r_n, r)
        p = torch.where(keep, p_n, p)
        rz = torch.where(active, rz_n, rz)
        rr = torch.where(active, _dot(r_n, r_n), rr)
    return x


def pcg_prox(f: CGFactors, q, rho_c, sigma, x0=None) -> torch.Tensor:
    """Matrix-free exact prox by Jacobi-PCG, warm-started at ``x0``."""
    c = sigma + rho_c
    rhs = f.Atb + rho_c * q
    inv = 1.0 / (f.diag + c)
    x0 = q if x0 is None else x0
    return pcg(lambda p: normal_matvec_auto(f.A, p, c), rhs, x0,
               lambda r: inv * r, f.iters, f.tol)


# ------------------------------------------------- the unified engine ----
@dataclasses.dataclass(frozen=True)
class NodeProxEngine:
    """Squared-loss x-update engine: resolves the ``x_solver`` policy,
    builds the stacked per-node factors once and solves every iteration."""
    kind: str                 # "dense" | "woodbury" | "pcg"
    cg_iters: int = 200
    cg_tol: float = 1e-6

    @staticmethod
    def choose(m: int, n: int, *, x_solver: str = "auto",
               cg_iters: int = 200, cg_tol: float = 1e-6) -> "NodeProxEngine":
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
        return NodeProxEngine(kind, cg_iters, cg_tol)

    def setup(self, A, b, sigma: float, rho_c: float):
        """Stacked per-node factors for A (N, m, n), b (N, m)."""
        if self.kind == "dense":
            return ridge_setup(A, b, sigma, rho_c)
        if self.kind == "woodbury":
            return woodbury_setup(A, b, sigma, rho_c)
        return cg_setup(A, b, self.cg_iters, self.cg_tol)

    def solve(self, factors, q, rho_c, sigma, x0=None) -> torch.Tensor:
        return x_solve(factors, q, rho_c, sigma, x0)


def x_solve(factors, q, rho_c, sigma, x0=None) -> torch.Tensor:
    """Backend dispatch on the factor type; ``x0`` warm-starts PCG only."""
    if isinstance(factors, RidgeFactors):
        return ridge_prox_factorized(factors, q, rho_c)
    if isinstance(factors, WoodburyFactors):
        return woodbury_prox(factors, q, rho_c)
    if isinstance(factors, CGFactors):
        return pcg_prox(factors, q, rho_c, sigma, x0)
    raise TypeError(f"unknown x-update factor type {type(factors)!r}")

"""Feature-split inner ADMM — the paper's sub-solver (Algorithm 2, eqs
(20)-(23)); counterpart of ``repro.core.subsolver``.

Evaluates the node prox
    argmin_x  l(A x, b) + sigma/2 ||x||^2 + rho_c/2 ||x - q||^2
by splitting x and the columns of A into M feature blocks. Per inner
iteration:

  x_j-update (23):  ridge LS per block with the cached Cholesky factor of
                    rho_l A_j^T A_j + (sigma + rho_c) I
  AllReduce:        mean of the partial predictions w_j = A_j x_j
  omega-bar (21):   separable per-sample prox of the loss
  nu-update (22):   scalar-vector dual ascent

Every node is handled at once along a leading axis, where the JAX package
vmaps over nodes: A (N, m, n), b (N, m), q (N, n, K), x_blocks
(N, M, nb, K) with nb = ceil(n / M). Block j is the columns
[j nb, min(n, (j+1) nb)) of A. The JAX package pads A to M nb columns and
moves the block axis to the front, a full copy of the data; here A stays in
its own layout and the ``block_matvec`` / ``block_rmatvec`` kernels index
the blocks inside it. Only the small operands (x, q) are padded: the padded
rows of the factors are sqrt(c) I, so the padded entries of x stay 0, as
the JAX zero padding makes them.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .losses import Loss
from ..kernels.ops import block_matvec_auto, block_rmatvec_auto, gram_auto
from ..kernels.ref import block_widths


def pad_features(A: torch.Tensor, M: int) -> tuple[torch.Tensor, int]:
    """A (m, n) with zero columns appended so that M divides its width,
    and the block width nb = ceil(n / M) (``repro.core.subsolver
    .pad_features``). The solver itself never pads A (see above): this is
    the JAX package's helper, for callers that want the padded layout."""
    n = A.shape[-1]
    nb = -(-n // M)
    pad = M * nb - n
    return (F.pad(A, (0, pad)) if pad else A), nb


def split_blocks(x: torch.Tensor, M: int, nb: int) -> torch.Tensor:
    """(N, n, K) -> (N, M, nb, K), zero-padding the feature axis."""
    N, n, K = x.shape
    return F.pad(x, (0, 0, 0, M * nb - n)).reshape(N, M, nb, K)


def merge_blocks(xb: torch.Tensor, n: int) -> torch.Tensor:
    """(N, M, nb, K) -> (N, n, K)."""
    N, M, nb, K = xb.shape
    return xb.reshape(N, M * nb, K)[:, :n]


@dataclasses.dataclass(frozen=True)
class SubsolverState:
    """Warm-startable inner-ADMM state, per node."""
    x_blocks: torch.Tensor   # (N, M, nb, K)
    nu: torch.Tensor         # (N, m, K) scaled dual
    omega_bar: torch.Tensor  # (N, m, K)


@dataclasses.dataclass(frozen=True)
class SubsolverFactors:
    """Set-up computed once per dataset."""
    A: torch.Tensor          # (N, m, n) data, by reference (never blocked)
    chol: torch.Tensor       # (N, M, nb, nb) lower factor of rho_l G_j + c I
    rho_l: float
    sigma: float
    rho_c: float
    M: int
    n: int

    @property
    def nb(self) -> int:
        return self.chol.shape[-1]


def _block_grams(A: torch.Tensor, M: int, nb: int,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """G_j = A_j^T A_j per node and block, (N, M, nb, nb), zero in the
    padded rows and columns, in ``dtype`` (A's by default). The full-width
    blocks of every node reach the ``gram`` kernel as one strided
    (N, full, m, nb) view of A (no copy, one launch); a ragged last block
    takes a second call on its own column slice of every node."""
    N, m, n = A.shape
    dtype = A.dtype if dtype is None else dtype
    full, rest = block_widths(n, nb, M)
    G = torch.zeros((N, M, nb, nb), dtype=dtype, device=A.device)
    if full:
        view = A[:, :, :full * nb].unflatten(-1, (full, nb))
        G[:, :full] = gram_auto(view.permute(0, 2, 1, 3), out_dtype=dtype)
    if rest:
        G[:, full, :rest, :rest] = gram_auto(A[:, :, full * nb:],
                                             out_dtype=dtype)
    return G


def subsolver_setup(A: torch.Tensor, sigma: float, rho_c: float,
                    rho_l: float, M: int,
                    dtype: torch.dtype | None = None) -> SubsolverFactors:
    """Per-block Gram matrices through the ``gram`` kernel, then the
    Cholesky factors of rho_l G_j + (sigma + rho_c) I, in ``dtype`` (A's by
    default; the sharded engine factors bf16 / fp16 data in f32, its
    precision policy's accumulation dtype)."""
    N, m, n = A.shape
    nb = -(-n // M)
    c = sigma + rho_c
    H = rho_l * _block_grams(A, M, nb, dtype)
    H.diagonal(dim1=-2, dim2=-1).add_(c)
    return SubsolverFactors(A, torch.linalg.cholesky(H), rho_l, sigma, rho_c,
                            M, n)


def subsolver_init(f: SubsolverFactors, K: int, m: int) -> SubsolverState:
    """A zero inner state."""
    N = f.A.shape[0]
    kw = dict(dtype=f.A.dtype, device=f.A.device)
    return SubsolverState(x_blocks=torch.zeros((N, f.M, f.nb, K), **kw),
                          nu=torch.zeros((N, m, K), **kw),
                          omega_bar=torch.zeros((N, m, K), **kw))


def _block_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs for every node and block."""
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def subsolver_run(loss: Loss, f: SubsolverFactors, b: torch.Tensor,
                  q: torch.Tensor, state: SubsolverState, iters: int
                  ) -> tuple[torch.Tensor, SubsolverState]:
    """Run ``iters`` inner-ADMM iterations from ``state``; returns
    (x (N, n, K), new state). ``q`` (N, n, K) is the prox center, ``b``
    (N, m) the targets or labels."""
    M, n, nb = f.M, f.n, f.nb
    qb = split_blocks(q, M, nb)                            # (N, M, nb, K)
    Mf = float(M)
    x_blocks, nu, omega_bar = state.x_blocks, state.nu, state.omega_bar
    for _ in range(iters):
        # x_j-update (23): the target for A_j x_j is
        #   A_j x_j^k + omega_bar^k - mean_j(A_j x_j^k) - nu^k
        w = block_matvec_auto(f.A, x_blocks, M)            # (N, M, m, K)
        w_bar = torch.mean(w, dim=1)                       # AllReduce
        c_j = w + (omega_bar - w_bar - nu)[:, None]
        rhs = f.rho_l * block_rmatvec_auto(f.A, c_j, M) + f.rho_c * qb
        x_blocks = _block_solve(f.chol, rhs)               # (N, M, nb, K)

        # aggregate the partial predictions (the paper's AllReduce of w)
        w_bar_new = torch.mean(block_matvec_auto(f.A, x_blocks, M), dim=1)

        # omega-bar update (21): per-sample prox in pred = M omega coords
        pred_q = Mf * (w_bar_new + nu)
        if loss.n_classes == 1:
            pred = loss.prox_omega(pred_q[..., 0], b, f.rho_l / Mf)[..., None]
        else:
            pred = loss.prox_omega(pred_q, b, f.rho_l / Mf)
        omega_bar = pred / Mf

        # nu-update (22)
        nu = nu + w_bar_new - omega_bar
    return merge_blocks(x_blocks, n), SubsolverState(x_blocks, nu, omega_bar)


def node_prox_feature_split(loss: Loss, f: SubsolverFactors, b: torch.Tensor,
                            q: torch.Tensor, iters: int,
                            state: SubsolverState | None = None
                            ) -> tuple[torch.Tensor, SubsolverState]:
    """The node prox of every node by Algorithm 2; ``q`` is (N, n) or
    (N, n, K) and x comes back in the same shape."""
    q3 = q if q.ndim == 3 else q[..., None]
    if state is None:
        state = subsolver_init(f, q3.shape[2], b.shape[1])
    x, state = subsolver_run(loss, f, b, q3, state, iters)
    return (x if q.ndim == 3 else x[..., 0]), state

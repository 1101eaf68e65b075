"""Per-feature-block products of the feature-split sub-solver (counterpart
of the ``block_matvec`` / ``block_rmatvec`` rows of ``repro.kernels.ops``).

``a`` is the node data (N, m, n) in its own row-major layout; feature block
j is its columns [j nb, min(n, (j+1) nb)) with nb = ceil(n / M):

* ``block_matvec(a, x_blocks, M)``: x_blocks (N, M, nb, K) -> (N, M, m, K),
  block j of node z is A_zj @ x_zj;
* ``block_rmatvec(a, y_blocks, M)``: y_blocks (N, M, m, K) -> (N, M, nb, K),
  block j of node z is A_zj^T @ y_zj, with the padded rows 0.

On CUDA tensors they launch ``csrc/block_matvec.cu``, which indexes the
blocks inside ``a`` — no padded or blocked copy of the data is made, where
the JAX package pads A and moves the block axis to the front. On CPU
tensors they are the plain versions of :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import block_matvec_ref, block_rmatvec_ref

_SIGNATURES = {
    "block_matvec_f32": [build.P, build.P, build.P, build.I, build.I,
                         build.I, build.I, build.I, build.I, build.P],
    "block_rmatvec_f32": [build.P, build.P, build.P, build.P, build.I,
                          build.I, build.I, build.I, build.I, build.I,
                          build.P],
    "block_rmatvec_slices": [build.I, build.I, build.I, build.I],
}


def block_matvec(a: torch.Tensor, x_blocks: torch.Tensor,
                 M: int) -> torch.Tensor:
    """A_j @ x_j per node and feature block, in f32 (module docstring)."""
    if a.device.type == "cpu":
        return block_matvec_ref(a, x_blocks, M)
    if a.device.type != "cuda":
        raise ValueError(f"block_matvec: no kernel for device {a.device}")
    return _launch(a, x_blocks, M, adjoint=False)


def block_rmatvec(a: torch.Tensor, y_blocks: torch.Tensor,
                  M: int) -> torch.Tensor:
    """A_j^T @ y_j per node and feature block, in f32 (module docstring)."""
    if a.device.type == "cpu":
        return block_rmatvec_ref(a, y_blocks, M)
    if a.device.type != "cuda":
        raise ValueError(f"block_rmatvec: no kernel for device {a.device}")
    return _launch(a, y_blocks, M, adjoint=True)


def _launch(a: torch.Tensor, v: torch.Tensor, M: int, *,
            adjoint: bool) -> torch.Tensor:
    name = "block_rmatvec" if adjoint else "block_matvec"
    build.require_cuda(name, a, v)
    if a.ndim != 3 or v.ndim != 4:
        raise ValueError(f"{name}: a must be (N, m, n) and the blocks "
                         f"(N, M, ., K), got {tuple(a.shape)}, "
                         f"{tuple(v.shape)}")
    if a.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 operands, got "
                         f"{a.dtype}, {v.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: a must be contiguous (row-major); the "
                         "wrapper does not copy the data matrix")
    if M < 1:
        raise ValueError(f"{name}: M must be positive, got {M}")
    N, m, n = a.shape
    nb = -(-n // M)
    K = v.shape[3]
    want = (N, M, m if adjoint else nb, K)
    if tuple(v.shape) != want:
        raise ValueError(f"{name}: blocks of shape {tuple(v.shape)} do not "
                         f"fit a of shape {tuple(a.shape)} split into M={M} "
                         f"blocks (expected {want})")
    if max(m, n, K) >= 2 ** 31 or max(N, M) >= 2 ** 16:
        raise ValueError(f"{name}: m, n, K must fit int32 and N, M the "
                         "grid's 65,535")
    v = v.contiguous()             # the small operand only, never a
    out = torch.empty((N, M, nb if adjoint else m, K), dtype=torch.float32,
                      device=a.device)
    if not out.numel():
        return out
    if m == 0:                     # an empty sum
        return out.zero_()
    lib = build.library("block_matvec", _SIGNATURES)
    if adjoint:
        slices = lib.block_rmatvec_slices(N, M, m, nb)
        part = torch.empty((slices, N, M, nb, K) if slices > 1 else (0,),
                           dtype=torch.float32, device=a.device)
        rc = lib.block_rmatvec_f32(a.data_ptr(), v.data_ptr(),
                                   part.data_ptr(), out.data_ptr(), N, M, m,
                                   n, nb, K, build.stream(a))
        launches = 1 + (slices > 1)   # block_rmatvec_kernel (+ sum_slices)
    else:
        rc = lib.block_matvec_f32(a.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  N, M, m, n, nb, K, build.stream(a))
        launches = 1
    build.check(rc, name)
    build.LAUNCHES[name] += launches
    return out

"""Per-feature-block products of the feature-split sub-solver (counterpart
of the ``block_matvec`` / ``block_rmatvec`` rows of ``repro.kernels.ops``).

``a`` is the node data (N, m, n) in its own row-major layout; feature block
j is its columns [j nb, min(n, (j+1) nb)) with nb = ceil(n / M):

* ``block_matvec(a, x_blocks, M)``: x_blocks (N, M, nb, K) -> (N, M, m, K),
  block j of node z is A_zj @ x_zj;
* ``block_rmatvec(a, y_blocks, M)``: y_blocks (N, M, m, K) -> (N, M, nb, K),
  block j of node z is A_zj^T @ y_zj, with the padded rows 0.

``a`` is float32, bfloat16 or float16 (the sharded engine's sub-solver
runs the bf16 one under ``precision="bf16"``); the blocks and the output
are float32 whatever ``a`` holds: each element of ``a`` is widened to f32
exactly and every sum runs in f32, the natural promotion the JAX package's
CPU row gives. On CUDA tensors they launch ``csrc/block_matvec.cu`` (the
``block_*_f32`` / ``_bf16`` / ``_f16`` instantiations, counted by type in
``ops.launch_counts_by_type``), which indexes the blocks inside ``a`` — no
padded or blocked copy of the data is made, where the JAX package pads A
and moves the block axis to the front. On CPU tensors they are the plain
versions of :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import block_matvec_ref, block_rmatvec_ref

# the C entries' suffix for each element type of A
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}
HALF_COLUMNS = 8    # block_rmatvec's columns a thread on 2-byte A (one
                    # 16-byte load a row)
_SIGNATURES = {"block_rmatvec_slices": [build.I] * 5}
for _sfx in SUFFIX.values():
    _SIGNATURES[f"block_matvec_{_sfx}"] = [build.P, build.P, build.P,
                                           *[build.I] * 6, build.P]
    _SIGNATURES[f"block_rmatvec_{_sfx}"] = [build.P, build.P, build.P,
                                            build.P, *[build.I] * 7,
                                            build.P]


def rmatvec_columns(esize: int, n: int, nb: int, aligned16: bool) -> int:
    """block_rmatvec's columns a thread: 8 for 2-byte A whose every block's
    rows start 16-byte aligned (n and nb multiples of 8, A 16-byte
    aligned), one load of 8 columns a row; 1 otherwise (f32 A always: its
    kernel is the one-column design)."""
    if esize == 2 and n % HALF_COLUMNS == 0 and nb % HALF_COLUMNS == 0 \
            and aligned16:
        return HALF_COLUMNS
    return 1


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
    if a.dtype not in SUFFIX or v.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32, bfloat16 or "
                         f"float16 data and float32 blocks, got {a.dtype}, "
                         f"{v.dtype}")
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
    sfx = SUFFIX[a.dtype]
    if adjoint:
        cols = rmatvec_columns(a.element_size(), n, nb,
                               a.data_ptr() % 16 == 0)
        slices = lib.block_rmatvec_slices(N, M, m, nb, cols)
        part = torch.empty((slices, N, M, nb, K) if slices > 1 else (0,),
                           dtype=torch.float32, device=a.device)
        rc = getattr(lib, f"block_rmatvec_{sfx}")(
            a.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(), N,
            M, m, n, nb, K, cols, build.stream(a))
        launches = 1 + (slices > 1)   # block_rmatvec_kernel (+ sum_slices)
    else:
        rc = getattr(lib, f"block_matvec_{sfx}")(
            a.data_ptr(), v.data_ptr(), out.data_ptr(), N, M, m, n, nb, K,
            build.stream(a))
        launches = 1
    build.check(rc, name)
    build.count_launches(name, sfx, launches)
    return out

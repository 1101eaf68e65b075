"""Matrix-vector products for the matrix-free x-update engines
(counterpart of ``repro.kernels.matvec``).

``matvec(a, x)`` is ``a @ x`` and ``rmatvec(a, y)`` is ``a^T @ y``, in f32:

* ``a`` (m, n) with ``x`` (n,) / (n, K) and ``y`` (m,) / (m, K), or
* ``a`` (N, m, n) with ``x`` (N, n) / (N, n, K) and ``y`` (N, m) / (N, m, K)
  — one product per node, in one launch.

On CUDA tensors they launch ``csrc/matvec.cu``; on CPU tensors they are the
plain versions. What the kernels are given — the load path, one launch or
row slices summed by a second, the grid — is decided by :func:`plan`, a
pure function of the operands' shapes and alignment and the card's SM
count. ``normal_matvec`` is the composition of the two, with the
intermediate cast of ``w`` to ``a.dtype`` that the JAX package makes
(``repro/kernels/matvec.py:186``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build
from .ref import matvec_ref, rmatvec_ref

# Mirrors of csrc/matvec.cu's constants (tests/test_torch_matvec.py reads
# them from the source).
ROWS_PER_SLICE = 128   # kRows: rows an rmatvec slice sums in order
TEAM_SLICES = 8        # kTeam: most slices one rmatvec block adds itself
MAX_K = 8              # kMaxK: right-hand sides per pass over A
WARPS = 8              # kWarps: warps per block (matvec, sliced rmatvec)
MIN_BLOCKS = 2         # kMinBlocks: resident blocks an SM (one wave)
# kRowsPerWarp1 / kRowsPerWarpK: matvec rows a warp owns at K = 1 / above
ROWS_PER_WARP_K1, ROWS_PER_WARP = 4, 2
MATVEC_PATHS = ("vec1", "veck", "scalar")   # the C entry's path numbers

_SIGNATURES = {
    "matvec_f32": [build.P, build.P, build.P, build.I, build.I, build.I,
                   build.I, build.I, build.I, build.P],
    "rmatvec_f32": [build.P, build.P, build.P, build.P, build.I, build.I,
                    build.I, build.I, build.I, build.I, build.I, build.P],
}


class Plan(NamedTuple):
    """How one product is launched.

    ``path``: matvec ``"vec1"`` (16-byte loads at K = 1), ``"veck"``
    (16-byte loads of A at K > 1) or ``"scalar"``; rmatvec ``"vec"`` (a lane
    owns 4 columns, one float4) or ``"scalar"``. ``slices``: rmatvec's
    128-row slices (0 for matvec). ``grid``: blocks of the first launch
    (matvec: one warp per ROWS_PER_WARP_K1 rows at K = 1, ROWS_PER_WARP
    above). ``launches``:
    device kernel launches (rmatvec: 1 for one slice, and up to
    TEAM_SLICES slices when the (node, column chunk) blocks that add them
    fill the card; otherwise 2, the slices' partials summed in order by a
    second kernel; 0 when the product is all zeros).
    ``align_x``: the wrapper copies X to a 16-byte-aligned buffer first
    (matvec at 1 < K <= MAX_K: X is read as float4s)."""
    path: str
    slices: int
    grid: int
    launches: int
    align_x: bool = False


def plan(adjoint: bool, N: int, m: int, n: int, K: int, a_aligned: bool,
         v_aligned: bool, sm_count: int) -> Plan:
    """The launch of ``a^T v`` (``adjoint``) or ``a v`` for a of shape
    (N, m, n) and K right-hand sides; ``a_aligned`` / ``v_aligned``: whether
    the operands start 16-byte aligned. At K = 1 the choice keeps each
    output's summation order that of the first kernels (csrc/matvec.cu)."""
    vec = n % 4 == 0 and a_aligned
    if adjoint:
        if m == 0:
            return Plan("vec" if vec else "scalar", 0, 0, 0)
        slices = -(-m // ROWS_PER_SLICE)
        chunks = -(-n // (32 * (4 if vec else 1)))
        if slices == 1 or (slices <= TEAM_SLICES and N * chunks >= sm_count):
            return Plan("vec" if vec else "scalar", slices, N * chunks, 1)
        # (node, slice, chunk) items: at K = 1 one a warp, the block
        # scheduler balancing the SMs; above, one wave of MIN_BLOCKS blocks
        # an SM, every warp the same number (each measured the faster there)
        items = N * slices * chunks
        per_warp = 1 if K == 1 else -(-items // (WARPS * MIN_BLOCKS
                                                 * sm_count))
        return Plan("vec" if vec else "scalar", slices,
                    -(-items // (WARPS * per_warp)), 2)
    if n == 0:
        return Plan("scalar", 0, 0, 0)
    if K == 1:
        path = "vec1" if vec and v_aligned else "scalar"
    else:
        path = "veck" if vec else "scalar"
    # one warp per row group; the block scheduler balances the SMs
    rows = ROWS_PER_WARP_K1 if K == 1 else ROWS_PER_WARP
    grid = -(-N * -(-m // rows) // WARPS)
    return Plan(path, 0, grid, 1,
                path == "veck" and K <= MAX_K and not v_aligned)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w = a @ x in f32 (shapes in the module docstring)."""
    if a.device.type == "cpu":
        return matvec_ref(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"matvec: no kernel for device {a.device}")
    return _launch(a, x, adjoint=False)


def rmatvec(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """g = a^T @ y in f32 (shapes in the module docstring)."""
    if a.device.type == "cpu":
        return rmatvec_ref(a, y)
    if a.device.type != "cuda":
        raise ValueError(f"rmatvec: no kernel for device {a.device}")
    return _launch(a, y, adjoint=True)


def normal_matvec(a: torch.Tensor, p: torch.Tensor, shift) -> torch.Tensor:
    """(A^T A + diag(shift)) p: w = A p, cast to a.dtype, then A^T w plus
    the shifted axpy, cast to a.dtype. ``shift`` is a scalar or an (n,)
    vector (broadcast over a leading node axis)."""
    w = matvec(a, p)
    g = rmatvec(a, w.to(a.dtype))
    return (g + shift * p.to(torch.float32)).to(a.dtype)


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(a: torch.Tensor, v: torch.Tensor, *, adjoint: bool) -> torch.Tensor:
    name = "rmatvec" if adjoint else "matvec"
    build.require_cuda(name, a, v)
    if a.ndim not in (2, 3):
        raise ValueError(f"{name}: a must be (m, n) or (N, m, n), got "
                         f"{tuple(a.shape)}")
    if a.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 operands, got "
                         f"{a.dtype}, {v.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: a must be contiguous (row-major); the "
                         "wrapper does not copy the data matrix")
    one = v.ndim == a.ndim - 1
    if not one and v.ndim != a.ndim:
        raise ValueError(f"{name}: operand of shape {tuple(v.shape)} does "
                         f"not fit a of shape {tuple(a.shape)}")
    ab = a if a.ndim == 3 else a[None]
    vb = v[..., None] if one else v
    vb = vb if a.ndim == 3 else vb[None]
    N, m, n = ab.shape
    inner = m if adjoint else n
    if vb.shape[0] != N or vb.shape[1] != inner:
        raise ValueError(f"{name}: operand of shape {tuple(v.shape)} does "
                         f"not fit a of shape {tuple(a.shape)}")
    K = vb.shape[2]
    if max(m, n, K) >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit int32")
    vb = vb.contiguous()           # the small operand only, never a
    outer = n if adjoint else m
    out = torch.empty((N, outer, K), dtype=torch.float32, device=a.device)
    if out.numel():
        p = plan(adjoint, N, m, n, K, ab.data_ptr() % 16 == 0,
                 vb.data_ptr() % 16 == 0, sm_count(a.device))
        if p.launches == 0:
            out.zero_()
        else:
            if p.align_x:
                vb = vb.clone()    # a fresh allocation is 16-byte aligned
            lib = build.library("matvec", _SIGNATURES)
            if adjoint:
                part = torch.empty(
                    (p.slices, N, n, K) if p.launches == 2 else (0,),
                    dtype=torch.float32, device=a.device)
                rc = lib.rmatvec_f32(ab.data_ptr(), vb.data_ptr(),
                                     part.data_ptr(), out.data_ptr(), N, m,
                                     n, K, int(p.path == "vec"),
                                     int(p.launches == 1), p.grid,
                                     build.stream(a))
            else:
                rc = lib.matvec_f32(ab.data_ptr(), vb.data_ptr(),
                                    out.data_ptr(), N, m, n, K,
                                    MATVEC_PATHS.index(p.path), p.grid,
                                    build.stream(a))
            build.check(rc, name)
            build.LAUNCHES[name] += p.launches
    if a.ndim == 2:
        out = out[0]
    return out[..., 0] if one else out

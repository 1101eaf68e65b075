"""Matrix-vector products for the matrix-free x-update engines
(counterpart of ``repro.kernels.matvec``).

``matvec(a, x)`` is ``a @ x`` and ``rmatvec(a, y)`` is ``a^T @ y``, in f32:

* ``a`` (m, n) with ``x`` (n,) / (n, K) and ``y`` (m,) / (m, K), or
* ``a`` (N, m, n) with ``x`` (N, n) / (N, n, K) and ``y`` (N, m) / (N, m, K)
  — one product per node, in one launch.

``a`` is float32, bfloat16 or float16 (the reduced-precision presets' data),
read in place and widened to f32 exactly inside the kernel; the small
operand reaches the kernel in f32 (the wrapper widens a bf16 / fp16 one,
which is exact). The output is f32; the registry rows
(:mod:`repro_torch.kernels.ops`) round it to the caller's dtype.

On CUDA tensors they launch ``csrc/matvec.cu``; on CPU tensors they are the
plain versions. What the kernels are given — the load path, one launch or
row slices summed by a second, the grid — is decided by :func:`plan`, a
pure function of the operands' shapes, alignment and element size and the
card's SM count.

``normal_matvec(a, p, shift)`` is (a^T a + diag(shift)) p for an f32 ``p``,
with ``w = a p`` kept in f32 as the JAX package's CPU row keeps it
(``repro/kernels/ops.py:109-113``; its Pallas rows round w to ``a.dtype``,
``repro/kernels/matvec.py:186``, which for f32 ``a`` is the same). On CUDA
tensors it launches ``csrc/normal_matvec.cu``, which reads ``a`` once;
:func:`normal_plan` picks its tiles, ring, CTAs per node and launches (one,
or two with the CTAs' partials added in order by a second kernel). A ``p``
with a right-hand-side axis, ``n`` past ``NM_MAX_N``, or a bf16 / fp16
``a`` whose rows the kernel cannot copy in 4-byte words (odd ``n``, or a
start off a 4-byte boundary) takes the composition of the ``matvec`` and
``rmatvec`` kernels instead (the plan says so).
"""
from __future__ import annotations

import functools
import numbers
from typing import NamedTuple

import torch

from . import build
from .ref import matvec_ref, normal_matvec_ref, rmatvec_ref

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

# Mirrors of csrc/normal_matvec.cu's constants (read from the source by
# tests/test_torch_normal_matvec.py).
NM_THREADS = 512        # kThreads: threads of a stream CTA
NM_MAX_VPT = 8          # kMaxVpt: 16-byte column chunks a thread owns
NM_MAX_ROWS = 4         # kMaxRows: rows of a tile
NM_MAX_TILE_VECS = 8    # kMaxTileVecs: most rows x vpt (no spills)
NM_MAX_STAGES = 8       # kMaxStages: stages of the ring
NM_RING_BYTES = 204_800  # kRingBytes: shared memory of the ring
NM_MAX_N = 4 * NM_THREADS * NM_MAX_VPT   # widest row the kernel takes
                                         # (kMaxCols columns a thread)
# the plan's own choices: about 40 KB a stage (rows of 1, 2 or 4), and at
# least 8 tiles a CTA, so the CTAs' partials stay small beside A
NM_STAGE_BYTES = 40_960
NM_MIN_TILES = 8
NM_PATHS = ("scalar", "bulk")   # the C entry's bulk flag

# the C entries' suffix for each element type of A
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}
_SIGNATURES = {}
for _sfx in SUFFIX.values():
    _SIGNATURES[f"matvec_{_sfx}"] = [build.P, build.P, build.P, build.I,
                                     build.I, build.I, build.I, build.I,
                                     build.I, build.P]
    _SIGNATURES[f"rmatvec_{_sfx}"] = [build.P, build.P, build.P, build.P,
                                      build.I, build.I, build.I, build.I,
                                      build.I, build.I, build.I, build.P]
_NM_SIGNATURES = {
    f"normal_matvec_{_sfx}": [build.P, build.P, build.P, build.F, build.I,
                              build.P, build.P, build.I, build.I, build.I,
                              build.I, build.I, build.I, build.I, build.I,
                              build.P]
    for _sfx in SUFFIX.values()}


class Plan(NamedTuple):
    """How one product is launched.

    ``path``: matvec ``"vec1"`` (16-byte loads at K = 1), ``"veck"``
    (16-byte loads of A at K > 1) or ``"scalar"``; rmatvec ``"vec"`` (a lane
    owns 4 columns, one load: a float4, or 8 bytes of bf16 / fp16) or
    ``"scalar"``. ``slices``: rmatvec's
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
         v_aligned: bool, sm_count: int, esize: int = 4) -> Plan:
    """The launch of ``a^T v`` (``adjoint``) or ``a v`` for a of shape
    (N, m, n) and K right-hand sides; ``a_aligned`` / ``v_aligned``: whether
    the operands start 16-byte aligned; ``esize``: bytes of an element of a
    (4, or 2 for bf16 / fp16). At K = 1 the f32 choice keeps each output's
    summation order that of the first kernels (csrc/matvec.cu). matvec's
    16-byte loads hold 16 / esize elements, so its rows are aligned when n
    is a multiple of that; rmatvec's lane loads 4 columns at any esize."""
    if adjoint:
        vec = n % 4 == 0 and a_aligned
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
    vec = n % (16 // esize) == 0 and a_aligned
    if K == 1:
        path = "vec1" if vec and v_aligned else "scalar"
    else:
        path = "veck" if vec else "scalar"
    # one warp per row group; the block scheduler balances the SMs
    rows = ROWS_PER_WARP_K1 if K == 1 else ROWS_PER_WARP
    grid = -(-N * -(-m // rows) // WARPS)
    return Plan(path, 0, grid, 1,
                path == "veck" and K <= MAX_K and not v_aligned)


class NormalPlan(NamedTuple):
    """How one ``normal_matvec`` is launched.

    ``route``: ``"fused"`` (csrc/normal_matvec.cu, A read once) or
    ``"composed"`` (the matvec and rmatvec kernels, then the shifted axpy
    in PyTorch: a ``p`` with a right-hand-side axis, n past NM_MAX_N, or
    bf16 / fp16 rows that 4-byte copies cannot move: odd n, or A off a
    4-byte boundary). ``path``: ``"bulk"`` (one cp.async.bulk a tile: n a
    multiple of the 16 / esize elements in 16 bytes, A 16-byte aligned) or
    ``"scalar"`` (4-byte cp.asyncs). ``vpt``: 16-byte column chunks a
    thread owns; ``rows``: rows of a tile; ``stages``: of
    the ring; ``ctas``: CTAs a node (0 when m == 0). ``launches``: device
    kernels of ``normal_matvec`` a call — 2 (the stream kernel writes the
    CTAs' partials, a second kernel adds them in CTA order and applies the
    shift), 1 (one CTA a node, which finishes the output itself; or m == 0:
    the second kernel alone, A unread), 0 (an empty output, or the
    composition, whose launches count as ``matvec`` and ``rmatvec``)."""
    route: str
    path: str
    vpt: int
    rows: int
    stages: int
    ctas: int
    launches: int


def normal_plan(N: int, m: int, n: int, K: int | None, a_aligned: bool,
                sm_count: int, esize: int = 4,
                a_aligned4: bool = True) -> NormalPlan:
    """The launch of (a^T a + diag(shift)) p for a of shape (N, m, n) and
    p of shape (N, n) (``K`` None) or (N, n, K); ``a_aligned`` /
    ``a_aligned4``: whether a starts 16-byte / 4-byte aligned; ``esize``:
    bytes of an element of a (4, or 2 for bf16 / fp16). The column partials
    and p stay in f32 at any esize, so the widest row is NM_MAX_N columns
    for every type. Each node's rows are split into at most
    ``sm_count // N`` CTAs (one a multiprocessor: the ring fills its shared
    memory), each with at least NM_MIN_TILES tiles."""
    per = 16 // esize                  # elements of a 16-byte chunk
    bulk = n % per == 0 and a_aligned
    path = "bulk" if bulk else "scalar"
    words = bulk or (n * esize % 4 == 0 and a_aligned4)
    if K is not None or n > NM_MAX_N or not words:
        return NormalPlan("composed", path, 0, 0, 0, 0, 0)
    if N == 0 or n == 0:
        return NormalPlan("fused", path, 0, 0, 0, 0, 0)
    nv = -(-n // per)
    vpt = -(-nv // NM_THREADS)
    row_bytes = 16 * nv
    rows = next(r for r in (4, 2, 1)
                if r == 1 or r * row_bytes <= NM_STAGE_BYTES)
    stages = min(NM_MAX_STAGES, NM_RING_BYTES // (rows * row_bytes))
    if m == 0:
        return NormalPlan("fused", path, vpt, rows, stages, 0, 1)
    tiles = -(-m // rows)
    ctas = max(1, min(sm_count // N, tiles // NM_MIN_TILES))
    return NormalPlan("fused", path, vpt, rows, stages, ctas,
                      1 if ctas == 1 else 2)


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w = a @ x in f32 (shapes and types in the module docstring)."""
    if a.device.type == "cpu":
        return matvec_ref(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"matvec: no kernel for device {a.device}")
    return _launch(a, x, adjoint=False)


def rmatvec(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """g = a^T @ y in f32 (shapes and types in the module docstring)."""
    if a.device.type == "cpu":
        return rmatvec_ref(a, y)
    if a.device.type != "cuda":
        raise ValueError(f"rmatvec: no kernel for device {a.device}")
    return _launch(a, y, adjoint=True)


def normal_matvec(a: torch.Tensor, p: torch.Tensor, shift) -> torch.Tensor:
    """(A^T A + diag(shift)) p: w = A p and A^T w plus the shifted axpy, all
    in f32. ``a`` (m, n) with ``p`` (n,), or (N, m, n) with ``p`` (N, n);
    ``shift`` a Python scalar, a 0-d tensor or an (n,) vector (broadcast
    over the nodes). A shift with one value per system (a tensor of two or
    more axes that broadcasts against ``p``: (N, 1) a node, (N, n) a node
    and entry; the fleet's per-lane penalties, a grid's per-point columns)
    takes the composed matvec + rmatvec kernels."""
    if a.device.type == "cpu":
        return normal_matvec_ref(a, p, shift)
    if a.device.type != "cuda":
        raise ValueError(f"normal_matvec: no kernel for device {a.device}")
    if per_system_shift(shift):
        build.require_cuda("normal_matvec", a, p, shift)
        try:
            torch.broadcast_shapes(shift.shape, p.shape)
        except RuntimeError:
            raise ValueError(f"normal_matvec: shift of shape "
                             f"{tuple(shift.shape)} does not fit p of shape "
                             f"{tuple(p.shape)}") from None
        return rmatvec(a, matvec(a, p)) + shift * p
    return _launch_normal(a, p, shift)


def per_system_shift(shift) -> bool:
    """Whether ``shift`` is a tensor of two or more axes: one value per
    system, which the one-pass kernel does not take."""
    return torch.is_tensor(shift) and shift.ndim >= 2


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
    if a.dtype not in SUFFIX or v.dtype not in SUFFIX:
        raise ValueError(f"{name}: the kernel takes {list(SUFFIX)} "
                         f"operands, got {a.dtype}, {v.dtype}")
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
    # the small operand only, never a: widened to f32 (exact) and contiguous
    vb = vb.to(torch.float32).contiguous()
    outer = n if adjoint else m
    out = torch.empty((N, outer, K), dtype=torch.float32, device=a.device)
    if out.numel():
        p = plan(adjoint, N, m, n, K, ab.data_ptr() % 16 == 0,
                 vb.data_ptr() % 16 == 0, sm_count(a.device),
                 a.element_size())
        if p.launches == 0:
            out.zero_()
        else:
            if p.align_x:
                vb = vb.clone()    # a fresh allocation is 16-byte aligned
            lib = build.library("matvec", _SIGNATURES)
            sfx = SUFFIX[a.dtype]
            if adjoint:
                part = torch.empty(
                    (p.slices, N, n, K) if p.launches == 2 else (0,),
                    dtype=torch.float32, device=a.device)
                rc = getattr(lib, f"rmatvec_{sfx}")(
                    ab.data_ptr(), vb.data_ptr(), part.data_ptr(),
                    out.data_ptr(), N, m, n, K, int(p.path == "vec"),
                    int(p.launches == 1), p.grid, build.stream(a))
            else:
                rc = getattr(lib, f"matvec_{sfx}")(
                    ab.data_ptr(), vb.data_ptr(), out.data_ptr(), N, m, n,
                    K, MATVEC_PATHS.index(p.path), p.grid, build.stream(a))
            build.check(rc, name)
            build.count_launches(name, sfx, p.launches)
    if a.ndim == 2:
        out = out[0]
    return out[..., 0] if one else out


class NormalArgs(NamedTuple):
    """What ``normal_matvec`` hands its C entry besides the pointers of a,
    p and the outputs: the (N, m, n) view of a, p's right-hand-side width
    (None for a vector a node) and the shift as (pointer, value, kind) —
    kind 0 a value (a Python scalar or a 0-d CPU tensor), 1 a 0-d tensor
    on a's device (read there: no host sync), 2 an (n,) vector on a's
    device."""
    N: int
    m: int
    n: int
    K: int | None
    shift_ptr: int
    shift_val: float
    shift_kind: int


def normal_args(a: torch.Tensor, p: torch.Tensor, shift) -> NormalArgs:
    """Check what the kernel takes — a contiguous (m, n) or (N, m, n) a
    (never copied) of float32, bfloat16 or float16, a float32 p (n,) /
    (N, n) or with a right-hand-side axis, a float32 shift that is a scalar,
    0-d or (n,) — and raise ValueError on anything else. Reads metadata
    only."""
    name = "normal_matvec"
    if a.ndim not in (2, 3):
        raise ValueError(f"{name}: a must be (m, n) or (N, m, n), got "
                         f"{tuple(a.shape)}")
    if a.dtype not in SUFFIX or p.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes an a of {list(SUFFIX)} "
                         f"and a float32 p, got {a.dtype}, {p.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: a must be contiguous (row-major); the "
                         "wrapper does not copy the data matrix")
    lead = a.shape[:-2]
    N, m, n = (lead[0] if lead else 1), a.shape[-2], a.shape[-1]
    if (p.ndim not in (a.ndim - 1, a.ndim)
            or tuple(p.shape[:a.ndim - 1]) != (*lead, n)):
        raise ValueError(f"{name}: p of shape {tuple(p.shape)} does not fit "
                         f"a of shape {tuple(a.shape)}")
    if max(m, n) >= 2 ** 31 or N * n >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit int32")
    K = p.shape[-1] if p.ndim == a.ndim else None
    if isinstance(shift, numbers.Real) and not isinstance(shift, bool):
        return NormalArgs(N, m, n, K, 0, float(shift), 0)
    if not isinstance(shift, torch.Tensor):
        raise ValueError(f"{name}: shift must be a scalar or a tensor, got "
                         f"{type(shift).__name__}")
    if shift.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes a float32 shift, got "
                         f"{shift.dtype}")
    if shift.ndim == 0 and shift.device.type == "cpu":
        return NormalArgs(N, m, n, K, 0, float(shift), 0)
    if shift.device != a.device:
        raise ValueError(f"{name}: shift on {shift.device}, a on "
                         f"{a.device}")
    if shift.ndim == 0:
        return NormalArgs(N, m, n, K, shift.data_ptr(), 0.0, 1)
    if tuple(shift.shape) != (n,) or not shift.is_contiguous():
        raise ValueError(f"{name}: shift of shape {tuple(shift.shape)} is "
                         f"neither 0-d nor a contiguous ({n},) vector")
    return NormalArgs(N, m, n, K, shift.data_ptr(), 0.0, 2)


def _launch_normal(a: torch.Tensor, p: torch.Tensor, shift) -> torch.Tensor:
    name = "normal_matvec"
    args = normal_args(a, p, shift)
    build.require_cuda(name, a, p)
    N, m, n = args.N, args.m, args.n
    pl = normal_plan(N, m, n, args.K, a.data_ptr() % 16 == 0,
                     sm_count(a.device), a.element_size(),
                     a.data_ptr() % 4 == 0)
    if pl.route == "composed":
        return rmatvec(a, matvec(a, p)) + shift * p
    out = torch.empty((N, n), dtype=torch.float32, device=a.device)
    if pl.launches:
        pc = p.contiguous()        # the small operand only, never a
        part = torch.empty((N, pl.ctas, n) if pl.launches == 2 else (0,),
                           dtype=torch.float32, device=a.device)
        lib = build.library(name, _NM_SIGNATURES)
        rc = getattr(lib, f"normal_matvec_{SUFFIX[a.dtype]}")(
            a.data_ptr(), pc.data_ptr(), args.shift_ptr, args.shift_val,
            args.shift_kind, part.data_ptr(), out.data_ptr(), N, m, n,
            NM_PATHS.index(pl.path), pl.vpt, pl.rows, pl.stages, pl.ctas,
            build.stream(a))
        build.check(rc, name)
        build.count_launches(name, SUFFIX[a.dtype], pl.launches)
    return out if a.ndim == 3 else out[0]

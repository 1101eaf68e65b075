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
and moves the block axis to the front. How, is decided by
:func:`block_plan`, a pure function of the shapes, the element size, the
alignment of ``a`` and the SM count. On CPU tensors they are the plain
versions of :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .matvec import sm_count
from .ref import block_matvec_ref, block_rmatvec_ref

# Mirrors of csrc/block_matvec.cu's constants (tests/test_torch_block_plan.py
# reads them from the source). The scalar route:
SCALAR_WARPS = 8        # kWarps: (row, block) segments of a matvec CTA
SCALAR_COLS = 256       # kCols: columns (threads) of an rmatvec CTA
SLICE_ROWS = 128        # kRows: rows of Y an rmatvec slice stages at a time
TARGET_CTAS = 2048      # kTargetCtas: rmatvec CTAs the slices aim for
# the stream route:
STREAM_WARPS = 16       # kStreamWarps: consumer warps of a CTA (most)
MAX_VPT = 4             # kMaxVpt: rmatvec's 16-byte chunks a lane
MAX_KC = 4              # kMaxKc: right-hand sides a pass over A
MAX_CHUNK_RHS = 4       # kMaxChunkRhs: rmatvec's most vpt x kc (registers)
MAX_GROUP_ROWS = 4      # kMaxGroupRows: rmatvec's rows a group takes a tile
MAX_X_BYTES = 65_536    # kMaxXBytes: matvec's X of a pass in shared memory
MAX_STAGES = 16         # kMaxStages: stages of the ring
RING_BYTES = 204_800    # kRingBytes: shared memory of the ring (and X)
# the plan's own choices (the fastest of tools/block_matvec_probe.py
# --variants' rings at the path shapes, PERF.md): block_matvec about
# MV_TILE_BYTES of A a tile and a ring of the tiles its warps work on at
# once and MV_SPARE more; block_rmatvec about RMV_TILE_BYTES a tile and
# RMV_FLIGHT_BYTES in flight beyond the tile it works on (deeper rings
# measured slower); at least MIN_TILES tiles a CTA, so block_rmatvec's CTA
# partials stay small beside A
MV_TILE_BYTES = 16_384
MV_SPARE = 2
RMV_TILE_BYTES = 32_768
RMV_FLIGHT_BYTES = 65_536
MIN_TILES = 4

# the C entries' suffix for each element type of A
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
          torch.float16: "f16"}
_SIGNATURES = {}
for _sfx in SUFFIX.values():
    _SIGNATURES[f"block_matvec_{_sfx}"] = [build.P, build.P, build.P,
                                           *[build.I] * 6, build.P]
    _SIGNATURES[f"block_rmatvec_{_sfx}"] = [build.P, build.P, build.P,
                                            build.P, *[build.I] * 7,
                                            build.P]
for _sfx in ("bf16", "f16"):
    _SIGNATURES[f"block_stream_{_sfx}"] = [build.P, build.P, build.P,
                                           build.P, *[build.I] * 14,
                                           build.P]


class BlockPlan(NamedTuple):
    """How one ``block_matvec`` / ``block_rmatvec`` call is launched.

    ``route``: ``"stream"`` (``block_stream_kernel``: bf16 / fp16 ``a``
    whose every 16-byte chunk lies in one block — n and nb multiples of 8,
    ``a`` 16-byte aligned — with at most STREAM_WARPS non-empty blocks, a
    row no wider than MAX_VPT chunks a lane of 16 warps a block and two
    stages of a tile in the ring) or ``"scalar"`` (the first
    ``block_matvec_kernel`` / ``block_rmatvec_kernel``: every f32 call, and
    the bf16 / fp16 calls the stream route does not take).

    Stream: ``rows`` of a tile, ``stages`` of the ring, ``threads`` of a
    CTA (consumer warps and one producer warp that copies the tiles in),
    ``ctas`` a node, ``kc`` right-hand sides a pass. block_matvec: 16
    consumer warps, each the whole dot product of an item (row, block) at a
    time, items dealt round-robin (``groups`` = ``wb`` = 1; ``vpt`` the
    chunks a lane whose X it keeps in registers, or 0: X in shared
    memory). block_rmatvec: ``groups`` row groups
    (at most MAX_GROUP_ROWS rows each a tile) of ``wb`` warps a non-empty
    block, a lane owning ``vpt`` 16-byte chunks of its block.
    Scalar: ``rows`` of an rmatvec row slice (0 for matvec), ``threads`` of
    a CTA, ``ctas`` the grid's CTAs a node.

    ``launches``: device kernels a call — the stream kernel once a pass of
    ``kc`` right-hand sides, plus ``block_sum_kernel`` for block_rmatvec
    over more than one CTA a node; scalar matvec 1, scalar rmatvec 1, or 2
    over more than one row slice (``sum_slices``); 0 when m == 0 (the
    output is zeros, nothing launches)."""
    route: str
    rows: int
    stages: int
    threads: int
    ctas: int
    launches: int
    groups: int = 0
    wb: int = 0
    vpt: int = 0
    kc: int = 0


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def block_plan(adjoint: bool, N: int, M: int, m: int, n: int, K: int,
               esize: int, aligned16: bool, sms: int) -> BlockPlan:
    """The launch of ``block_rmatvec`` (``adjoint``) or ``block_matvec`` on
    a of shape (N, m, n) in M blocks with K right-hand sides; ``esize``:
    bytes of an element of a (4, or 2 for bf16 / fp16); ``aligned16``:
    whether a starts 16-byte aligned; ``sms``: the card's SM count. The
    stream route streams whole rows through a ring of tiles, CTAs a node
    about sms / N (each with at least MIN_TILES tiles); every other call
    keeps the scalar kernels and their sums (the f32 ones bit for bit)."""
    nb = -(-n // M)
    if esize == 2 and n > 0 and n % 8 == 0 and nb % 8 == 0 and aligned16:
        plan = (_stream_rmatvec if adjoint else _stream_matvec)(
            N, M, m, n, nb, K, sms)
        if plan is not None:
            return plan
    if m == 0 or N == 0 or K == 0:
        return BlockPlan("scalar", 0, 0, 0, 0, 0)
    if not adjoint:
        return BlockPlan("scalar", 0, 0, 32 * SCALAR_WARPS,
                         -(-m // SCALAR_WARPS) * M, 1)
    # row slices: about TARGET_CTAS CTAs in flight, each slice at least
    # SLICE_ROWS rows (csrc/block_matvec.cu's slice plan)
    ctiles = -(-nb // SCALAR_COLS)
    slices = -(-TARGET_CTAS // max(ctiles * M * N, 1))
    slices = max(1, min(slices, -(-m // SLICE_ROWS)))
    rps = -(-m // slices)
    slices = -(-m // rps)
    return BlockPlan("scalar", rps, 0, SCALAR_COLS, ctiles * M * slices,
                     1 + int(slices > 1))


def _stream_launches(N: int, m: int, K: int, rows: int, kc: int,
                     sms: int, adjoint: bool) -> tuple[int, int]:
    """CTAs a node and launches a call of the stream route."""
    tiles = -(-m // rows)
    ctas = max(1, min(sms // max(N, 1), tiles // MIN_TILES))
    launches = 0 if m == 0 or N == 0 or K == 0 else \
        -(-K // kc) + int(adjoint and ctas > 1)
    return ctas, launches


def _stream_matvec(N, M, m, n, nb, K, sms) -> BlockPlan | None:
    """block_matvec: a warp an item (row, block). X of a pass in registers
    (``vpt`` chunks a lane, a power of two) where M divides STREAM_WARPS
    and one pass of vpt x K fits MAX_CHUNK_RHS, else in shared memory
    (``vpt`` 0). Rows a tile: the power of two nearest below MV_TILE_BYTES
    of A, halved while the ring cannot hold one tile more than the
    STREAM_WARPS warps work on at once; stages: those tiles and MV_SPARE
    more, as far as they fit."""
    cb = nb // 8
    vpt = 1 << (-(-cb // 32) - 1).bit_length()
    if STREAM_WARPS % M == 0 and vpt <= MAX_VPT \
            and vpt * min(K, MAX_KC) <= MAX_CHUNK_RHS:
        kc, x_bytes = min(K, MAX_KC), 0
    else:
        vpt, kc = 0, min(K, MAX_KC, MAX_X_BYTES // (4 * n))
        x_bytes = _align16(4 * n * kc)
    if kc < 1:
        return None
    ring = RING_BYTES - x_bytes
    row_bytes = 2 * n
    rows = 1 << (max(1, MV_TILE_BYTES // row_bytes).bit_length() - 1)

    def busy(r):                      # tiles the warps work on at once
        return -(-STREAM_WARPS // (r * M))

    while rows > 1 and ring // (rows * row_bytes) < busy(rows) + 1:
        rows //= 2
    stages = min(MAX_STAGES, busy(rows) + MV_SPARE,
                 ring // (rows * row_bytes))
    if stages < 2:
        return None
    ctas, launches = _stream_launches(N, m, K, rows, kc, sms, False)
    return BlockPlan("stream", rows, stages, 32 * STREAM_WARPS + 32, ctas,
                     launches, 1, 1, vpt, kc)


def _stream_rmatvec(N, M, m, n, nb, K, sms) -> BlockPlan | None:
    """block_rmatvec: a lane VPT chunks of a block's row in every tile,
    groups of warps on the tile's rows (module constants above)."""
    nc, cb = n // 8, nb // 8
    mb = -(-nc // cb)                  # non-empty blocks
    if mb > STREAM_WARPS:
        return None
    wb = min(-(-cb // 32), STREAM_WARPS // mb)
    vpt = 1 << (-(-cb // (32 * wb)) - 1).bit_length()
    if vpt > MAX_VPT:
        return None
    groups = STREAM_WARPS // (mb * wb)
    rows = groups * max(1, min(MAX_GROUP_ROWS,
                               RMV_TILE_BYTES // (groups * 2 * n)))
    kc = min(K, MAX_KC, MAX_CHUNK_RHS // vpt)
    stage = _align16(2 * rows * n) + _align16(4 * rows * mb * kc)
    stages = min(MAX_STAGES, RING_BYTES // stage,
                 max(2, 1 + RMV_FLIGHT_BYTES // stage))
    if stages < 2:
        return None
    ctas, launches = _stream_launches(N, m, K, rows, kc, sms, True)
    return BlockPlan("stream", rows, stages, 32 * groups * mb * wb + 32,
                     ctas, launches, groups, wb, vpt, kc)


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


def plan_for(a: torch.Tensor, M: int, K: int, *,
             adjoint: bool) -> BlockPlan:
    """:func:`block_plan` for a CUDA ``a`` (N, m, n) in M blocks."""
    N, m, n = a.shape
    return block_plan(adjoint, N, M, m, n, K, a.element_size(),
                      a.data_ptr() % 16 == 0, sm_count(a.device))


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
    pl = plan_for(a, M, K, adjoint=adjoint)
    if not pl.launches:            # m == 0: an empty sum
        return out.zero_()
    lib = build.library("block_matvec", _SIGNATURES)
    sfx = SUFFIX[a.dtype]
    if pl.route == "stream":
        part = torch.empty((N, pl.ctas, M, nb, K) if adjoint and pl.ctas > 1
                           else (0,), dtype=torch.float32, device=a.device)
        rc = getattr(lib, f"block_stream_{sfx}")(
            a.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(), N,
            M, m, n, nb, K, int(adjoint), pl.rows, pl.stages, pl.wb,
            pl.groups, pl.vpt, pl.kc, pl.ctas, build.stream(a))
    elif adjoint:
        part = torch.empty((-(-m // pl.rows), N, M, nb, K)
                           if pl.launches == 2 else (0,),
                           dtype=torch.float32, device=a.device)
        rc = getattr(lib, f"block_rmatvec_{sfx}")(
            a.data_ptr(), v.data_ptr(), part.data_ptr(), out.data_ptr(), N,
            M, m, n, nb, K, pl.rows, build.stream(a))
    else:
        rc = getattr(lib, f"block_matvec_{sfx}")(
            a.data_ptr(), v.data_ptr(), out.data_ptr(), N, M, m, n, nb, K,
            build.stream(a))
    build.check(rc, name)
    build.count_launches(name, sfx, pl.launches)
    return out

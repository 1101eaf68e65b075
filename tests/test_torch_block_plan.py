"""The choices ``block_matvec`` / ``block_rmatvec`` make before they
launch, on the CPU.

``repro_torch.kernels.block_matvec.block_plan`` decides, from the shapes,
the element size, the 16-byte alignment of A and the card's SM count,
whether a call takes the stream route (``block_stream_kernel`` of
``csrc/block_matvec.cu``: whole rows through a ring of tiles on a
persistent grid) or the scalar kernels, and with what tiles, ring,
threads, CTAs and launches. It is a pure function of that metadata,
checked here against the source's constants and against a model of the
kernel's index arithmetic: every row of a node taken once by one CTA and
one row group, every 16-byte chunk of a row owned by one lane, and every
chunk inside one feature block. The kernels themselves are held against
their plain versions in tests/test_torch_cuda.py, on a machine with a card.
"""
import re

import pytest
import torch

from repro_torch.kernels import block_matvec as bm
from repro_torch.kernels import build

H100_SMS = 132


def _plan(adjoint, N, M, m, n, K=1, esize=2, aligned=True):
    return bm.block_plan(adjoint, N, M, m, n, K, esize, aligned, H100_SMS)


def test_constants_mirror_the_cuda_source():
    src = (build.CSRC / "block_matvec.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kWarps"], consts["kCols"], consts["kRows"],
            consts["kTargetCtas"]) == (bm.SCALAR_WARPS, bm.SCALAR_COLS,
                                       bm.SLICE_ROWS, bm.TARGET_CTAS)
    assert (consts["kStreamWarps"], consts["kMaxVpt"], consts["kMaxKc"],
            consts["kMaxChunkRhs"], consts["kMaxGroupRows"],
            consts["kMaxXBytes"], consts["kMaxStages"],
            consts["kRingBytes"]) == (
        bm.STREAM_WARPS, bm.MAX_VPT, bm.MAX_KC, bm.MAX_CHUNK_RHS,
        bm.MAX_GROUP_ROWS, bm.MAX_X_BYTES, bm.MAX_STAGES, bm.RING_BYTES)
    assert "block_matvec" in build.SOURCES
    # the stream entry's plan arguments in the wrapper's order, one entry a
    # half-width type and none for f32
    assert ("int adjoint, int rows, int stages, int wb, int groups, int vpt, "
            "int kc, int ctas, void* stream" in " ".join(src.split()))
    assert "STREAM_ENTRY(bf16, " in src and "STREAM_ENTRY(f16, " in src
    assert "STREAM_ENTRY(f32, " not in src
    for sfx in bm.SUFFIX.values():
        assert f"BLOCK_ENTRIES({sfx}, " in src
    assert len(bm._SIGNATURES["block_stream_bf16"]) == 19
    assert len(bm._SIGNATURES["block_rmatvec_f32"]) == 12


# (adjoint, N, M, m, n, K) -> (rows, stages, threads, ctas, launches,
# groups, wb, vpt, kc)
PATH_PLANS = [
    # a sharded rank's bf16 / fp16 block (the sharded_bf16 cell) on every
    # SM: block_matvec's 16 warps a row each (4 chunks a lane, X in
    # registers at K = 1, in shared memory at K = 3), 8-row tiles of 16 KB,
    # the warps on 2 at once, 4 stages; block_rmatvec's 4 groups of 4 warps
    # (a chunk a lane), 16-row tiles of 32 KB, 3 stages, and the CTAs'
    # partials added by a second launch
    ((False, 1, 1, 25_000, 1_000, 1), (8, 4, 544, 132, 1, 1, 1, 4, 1)),
    ((True, 1, 1, 25_000, 1_000, 1), (16, 3, 544, 132, 2, 4, 4, 1, 1)),
    ((False, 1, 1, 25_000, 1_000, 3), (8, 4, 544, 132, 1, 1, 1, 0, 3)),
    ((True, 1, 1, 25_000, 1_000, 3), (16, 3, 544, 132, 2, 4, 4, 1, 3)),
    # sharded_fp16's one-node block: block_matvec's warps on 8 two-row
    # tiles at once (10 stages, X in shared memory); block_rmatvec one group
    # of 16 warps
    ((False, 1, 1, 25_000, 4_000, 1), (2, 10, 544, 132, 1, 1, 1, 0, 1)),
    ((True, 1, 1, 25_000, 4_000, 1), (4, 3, 544, 132, 2, 1, 16, 1, 1)),
    # Fig. 3's point with M = 4, 16 CTAs a node: 8 items a 2-row tile;
    # block_rmatvec 4 blocks of 4 warps
    ((False, 8, 4, 25_000, 4_000, 1), (2, 4, 544, 16, 1, 1, 1, 4, 1)),
    ((True, 8, 4, 25_000, 4_000, 1), (4, 3, 544, 16, 2, 1, 4, 1, 1)),
]


@pytest.mark.parametrize("args,want", PATH_PLANS)
def test_plan_at_the_path_shapes(args, want):
    p = _plan(*args)
    assert p.route == "stream"
    assert (p.rows, p.stages, p.threads, p.ctas, p.launches, p.groups, p.wb,
            p.vpt, p.kc) == want


@pytest.mark.parametrize("n,M,esize,aligned,routes", [
    # (block_matvec's route, block_rmatvec's)
    (1_000, 1, 2, True, ("stream", "stream")),
    (1_000, 1, 2, False, ("scalar", "scalar")),   # A off a 16-byte boundary
    (1_001, 4, 2, True, ("scalar", "scalar")),    # odd n
    (1_000, 4, 2, True, ("scalar", "scalar")),    # nb = 250: a chunk
                                                  # straddles two blocks
    (1_000, 1, 4, True, ("scalar", "scalar")),    # f32 keeps the scalar kernels
    (4_000, 4, 4, True, ("scalar", "scalar")),
    (256, 17, 2, True, ("stream", "stream")),     # 16 blocks of 16, one empty
    (272, 17, 2, True, ("stream", "scalar")),     # 17 non-empty blocks: more
                                                  # than rmatvec's 16 warps
    (16_384, 1, 2, True, ("stream", "stream")),   # X 64 KB; 4 chunks a lane
    (16_392, 1, 2, True, ("scalar", "scalar")),   # one chunk wider
    (0, 1, 2, True, ("scalar", "scalar")),
])
def test_plan_routes_by_shape_and_alignment(n, M, esize, aligned, routes):
    for adjoint, route in zip((False, True), routes):
        p = _plan(adjoint, 2, M, 300, n, esize=esize, aligned=aligned)
        assert p.route == route, (n, M, esize, aligned, adjoint)


def _stream_model(p, adjoint, N, M, m, n):
    """The stream kernels' index arithmetic in Python (cta_range, the
    producer's fill, block_stream_mv_kernel's items and
    block_stream_rmv_kernel's groups and chunks): how often each (node,
    row, block) is taken, and which thread slot owns each chunk of a row."""
    nb = -(-n // M)
    nc, cb = n // 8, nb // 8
    mb = -(-nc // cb)
    taken = {}
    tiles = -(-m // p.rows)
    for b in range(N * p.ctas):
        z, c = divmod(b, p.ctas)
        ntiles = (tiles - c + p.ctas - 1) // p.ctas   # tiles c, c + ctas, ...
        assert ntiles >= 1
        for t in range(ntiles):
            row0 = (c + t * p.ctas) * p.rows
            rows = min(p.rows, m - row0)
            if adjoint:                  # every row of the tile, every block
                for g in range(p.groups):
                    for rr in range(p.rows // p.groups):
                        r = g + p.groups * rr
                        for j in range(mb) if r < rows else ():
                            key = (z, row0 + r, j)
                            taken[key] = taken.get(key, 0) + 1
                continue
            first = t * p.rows * M       # item i to warp i % STREAM_WARPS
            for it in range(first, first + rows * M):
                r, j = divmod(it - first, M)
                key = (z, row0 + r, j)
                taken[key] = taken.get(key, 0) + 1
    owned = {}
    if adjoint:
        tpg = 32 * mb * p.wb
        assert p.threads == p.groups * tpg + 32    # and the producer warp
        for tid in range(tpg):                     # one group's threads
            j, wbi, lane = tid // (32 * p.wb), tid // 32 % p.wb, tid % 32
            q = 32 * wbi + lane
            cbj = min(cb, nc - j * cb)
            for u in range(p.vpt):
                cu = q + u * 32 * p.wb
                if cu < cbj:
                    owned.setdefault(j * cb + cu, []).append((tid, u))
    else:
        assert p.threads == 32 * bm.STREAM_WARPS + 32
        for j in range(mb):                        # a warp on item (r, j)
            cbj = min(cb, nc - j * cb)
            for lane in range(32):
                for u in range(lane, cbj, 32):
                    owned.setdefault(j * cb + u, []).append((lane, u))
    # every chunk's 8 columns lie in its block
    for chunk in owned:
        j = chunk // cb
        assert j * nb <= 8 * chunk and 8 * chunk + 8 <= j * nb + min(
            nb, n - j * nb)
    return taken, owned, mb


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("N,M,m,n,K", [
    (1, 1, 25_000, 1_000, 1), (1, 1, 25_000, 4_000, 1),
    (8, 4, 2_500, 4_000, 1),       # Fig. 3's blocks on fewer rows
    (1, 1, 1, 1_000, 1),           # one row: one CTA, one partial tile
    (1, 1, 37, 1_000, 3),          # fewer tiles than SMs
    (2, 4, 301, 256, 3),           # m not a multiple of the tile's rows
    (3, 4, 9, 64, 1),              # M = 4, nb = 16, few rows
    (1, 17, 50, 256, 2),           # an empty last block
    (2, 2, 7, 16, 5),              # K past a pass: two passes
    (1, 1, 300, 16_384, 1),        # 4 chunks a lane (rmatvec)
    (1, 1, 300, 8_192, 3),         # 2 chunks a lane, passes of 2 and 1
])
def test_stream_plan_takes_every_row_and_chunk_once(adjoint, N, M, m, n, K):
    p = _plan(adjoint, N, M, m, n, K)
    assert p.route == "stream"
    taken, owned, mb = _stream_model(p, adjoint, N, M, m, n)
    blocks = mb if adjoint else M    # block_matvec writes the empty ones too
    assert taken == {(z, i, j): 1 for z in range(N) for i in range(m)
                     for j in range(blocks)}
    assert sorted(owned) == list(range(n // 8))
    assert all(len(v) == 1 for v in owned.values())
    passes = -(-K // p.kc)
    assert p.launches == passes + int(adjoint and p.ctas > 1)
    assert p.ctas * N <= max(H100_SMS, N)


def test_stream_plan_asks_only_for_what_the_source_takes():
    """The entry's checks (stream_entry) hold at every plan over a grid of
    shapes: 2 to MAX_STAGES stages, kc within MAX_KC; block_matvec's X in
    registers only where M divides STREAM_WARPS and vpt x kc fits
    MAX_CHUNK_RHS, else X and ring within RING_BYTES (X within
    MAX_X_BYTES); block_rmatvec's vpt a
    power of two up to MAX_VPT covering the block, vpt x kc within
    MAX_CHUNK_RHS, rows a multiple of the groups with at most
    MAX_GROUP_ROWS a group, at most STREAM_WARPS consumer warps, the ring
    and the groups' partials within RING_BYTES."""
    seen = 0
    for n in range(8, 20_000, 56):
        for M in (1, 2, 3, 4, 5, 8, 16):
            nb = -(-n // M)
            for K in (1, 2, 3, 5):
                for adjoint in (False, True):
                    p = _plan(adjoint, 2, M, 700, n, K)
                    if p.route != "stream":
                        # a ragged nb; block_matvec: X past MAX_X_BYTES;
                        # block_rmatvec: a block wider than MAX_VPT chunks
                        # a lane of the warps its share of the CTA allows
                        mb = -(-n // 8 // (nb // 8)) if nb % 8 == 0 else 0
                        assert nb % 8 or (
                            nb // 8 > bm.MAX_VPT * 32 * (
                                bm.STREAM_WARPS // mb) if adjoint
                            else 4 * n > bm.MAX_X_BYTES), (n, M, adjoint)
                        continue
                    seen += 1
                    nc, cb = n // 8, nb // 8
                    mb = -(-nc // cb)
                    assert 2 <= p.stages <= bm.MAX_STAGES
                    assert 1 <= p.kc <= bm.MAX_KC
                    assert 1 <= p.ctas <= -(-700 // p.rows)
                    if not adjoint:
                        assert p.vpt in (0, 1, 2, 4)
                        if p.vpt:       # X in registers
                            assert bm.STREAM_WARPS % M == 0
                            assert 32 * p.vpt >= cb
                            assert p.vpt * p.kc <= bm.MAX_CHUNK_RHS
                        x_bytes = 0 if p.vpt else -(-4 * n * p.kc // 16) * 16
                        assert x_bytes <= bm.MAX_X_BYTES
                        assert x_bytes + p.stages * p.rows * n * 2 \
                            <= bm.RING_BYTES
                        continue
                    assert p.vpt in (1, 2, 4) and 32 * p.wb * p.vpt >= cb
                    assert p.vpt * p.kc <= bm.MAX_CHUNK_RHS
                    assert p.rows % p.groups == 0
                    assert p.rows // p.groups <= bm.MAX_GROUP_ROWS
                    assert p.groups * mb * p.wb <= bm.STREAM_WARPS
                    stage = -(-p.rows * n * 2 // 16) * 16 \
                        + -(-p.rows * mb * p.kc * 4 // 16) * 16
                    assert p.stages * stage <= bm.RING_BYTES
                    comb = 4 * (p.groups - 1) * p.vpt * 8 * p.kc \
                        * 32 * mb * p.wb
                    assert comb <= bm.RING_BYTES
    assert seen > 1_000


@pytest.mark.parametrize("N,M,m,nb,want", [
    # (rows a slice, launches) of the scalar rmatvec: the f32 card test's
    # shapes (4,000 rows in 32 slices of 125; 100 rows in one slice) and the
    # ragged (2, 3,000, 1,001) of the kernels phase
    (2, 4, 4_000, 16, (125, 2)),
    (2, 4, 100, 16, (100, 1)),
    (2, 4, 3_000, 251, (125, 2)),
    (8, 4, 25_000, 1_000, (1_563, 2)),  # the f32 Fig. 3 blocks: 16 slices
    (1, 1, 25_000, 1_000, (128, 2)),    # the f32 sharded rank: 196 slices
])
def test_scalar_rmatvec_row_slices(N, M, m, nb, want):
    """The scalar route's row slices: the slice_plan (kernels at about
    TARGET_CTAS CTAs, slices of at least SLICE_ROWS rows), now computed by
    the plan and passed to the kernel, so the f32 sums keep their order."""
    p = _plan(True, N, M, m, nb * M, esize=4)
    assert p.route == "scalar"
    assert (p.rows, p.launches) == want
    slices = -(-m // p.rows)
    ctiles = -(-nb // bm.SCALAR_COLS)
    assert p.ctas == ctiles * M * slices
    assert slices <= -(-m // bm.SLICE_ROWS)
    assert p.rows * (slices - 1) < m <= p.rows * slices
    q = _plan(False, N, M, m, nb * M, esize=4)
    assert (q.route, q.launches, q.ctas) == (
        "scalar", 1, -(-m // bm.SCALAR_WARPS) * M)


def test_plan_empty_sums_launch_nothing():
    for esize in (2, 4):
        for adjoint in (False, True):
            assert _plan(adjoint, 2, 4, 0, 256, esize=esize).launches == 0


def test_cpu_tensors_take_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 40, 64, generator=g).to(torch.bfloat16)
    x = torch.randn(2, 4, 16, 3, generator=g)
    y = torch.randn(2, 4, 40, 3, generator=g)
    assert torch.equal(bm.block_matvec(a, x, 4),
                       bm.block_matvec_ref(a, x, 4))
    assert torch.equal(bm.block_rmatvec(a, y, 4),
                       bm.block_rmatvec_ref(a, y, 4))

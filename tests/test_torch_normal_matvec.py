"""The choices ``normal_matvec`` makes before it launches, on the CPU.

``repro_torch.kernels.matvec.normal_plan`` decides, from the shapes, the
16-byte alignment of A and the card's SM count, how ``csrc/normal_matvec.cu``
reads A once: the load path (one bulk copy a tile, or 4-byte copies into
padded rows), the float4 column chunks a thread owns, the rows of a tile,
the ring's stages, the CTAs a node and one or two launches; or that the
call takes the composition of the matvec and rmatvec kernels. It is a pure
function of that metadata, checked here with the mirrors of the source's
constants and the wrapper's refusals (``normal_args`` reads metadata only).
CPU tensors take the plain version, held against the JAX package's
``ops.normal_matvec`` (Pallas in interpret mode) on the same numpy inputs:
rtol 1e-4 / atol 1e-5 per unit of the summed magnitudes, the JAX package's
f32 kernel bound. The kernel itself is held against the plain version in
tests/test_torch_cuda.py, on a machine with a card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import runtime
from repro_torch.kernels import build, matvec, ops, ref

H100_SMS = 132


def _plan(N, m, n, K=None, aligned=True, esize=4, aligned4=True):
    return matvec.normal_plan(N, m, n, K, aligned, H100_SMS, esize, aligned4)


def test_constants_mirror_the_cuda_source():
    src = (build.CSRC / "normal_matvec.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kThreads"]), int(consts["kMaxVpt"]),
            int(consts["kMaxRows"]), int(consts["kMaxTileVecs"]),
            int(consts["kMaxStages"]), int(consts["kRingBytes"])) == (
        matvec.NM_THREADS, matvec.NM_MAX_VPT, matvec.NM_MAX_ROWS,
        matvec.NM_MAX_TILE_VECS, matvec.NM_MAX_STAGES,
        matvec.NM_RING_BYTES)
    assert "normal_matvec" in build.SOURCES
    # the C entries' argument order: the shift's three forms, then the bulk
    # flag where the plan's path goes; one entry per element type of A
    assert "int bulk, int vpt, int rows, int stages, int ctas," in src
    for sfx in matvec.SUFFIX.values():
        assert f"NORMAL_ENTRY({sfx}, " in src
    assert matvec.NM_PATHS == ("scalar", "bulk")
    assert "s.kind == 0 ? s.val : s.kind == 1 ? s.ptr[0] : s.ptr[col]" in src


@pytest.mark.parametrize("N,m,n,want", [
    # the Woodbury fit's stacked polish: 40 KB rows one a tile, 5 stages,
    # every SM
    (1, 6_400, 10_000, ("bulk", 5, 1, 5, 132, 2)),
    # the Fig. 3 PCG x-update: 16 KB rows two a tile, 6 stages, 16 CTAs a
    # node (128 of the 132 SMs)
    (8, 25_000, 4_000, ("bulk", 2, 2, 6, 16, 2)),
    # its stacked polish
    (1, 200_000, 4_000, ("bulk", 2, 2, 6, 132, 2)),
    # the PCG parity fit: 50 four-row tiles a node, at least 8 a CTA
    (2, 200, 2_500, ("bulk", 2, 4, 5, 6, 2)),
])
def test_plan_at_the_path_shapes(N, m, n, want):
    p = _plan(N, m, n)
    assert p.route == "fused"
    assert (p.path, p.vpt, p.rows, p.stages, p.ctas, p.launches) == want
    # the ring fits the shared memory it was given, and holds >= 2 stages
    assert 2 <= p.stages <= matvec.NM_MAX_STAGES
    assert p.stages * p.rows * 16 * -(-n // 4) <= matvec.NM_RING_BYTES
    assert p.ctas * N <= H100_SMS


@pytest.mark.parametrize("n,aligned,path,vpt,rows,stages", [
    (4_001, True, "scalar", 2, 2, 6),    # n % 4 == 1: rows padded to 4,004
    (4_002, True, "scalar", 2, 2, 6),
    (1_003, True, "scalar", 1, 4, 8),    # short rows: 4 a tile, 8 stages
    (4_000, False, "scalar", 2, 2, 6),   # A one float past 16 bytes
    (2_560, True, "bulk", 2, 4, 5),      # the widest 4-row tile (40 KB)
    (2_564, True, "bulk", 2, 2, 8),      # one chunk wider: 2 rows
    (12_288, True, "bulk", 6, 1, 4),
    (16_384, True, "bulk", 8, 1, 3),     # the widest row the kernel takes
    (3, True, "scalar", 1, 4, 8),
])
def test_plan_ragged_and_unaligned(n, aligned, path, vpt, rows, stages):
    p = _plan(2, 1_000, n, aligned=aligned)
    assert (p.route, p.path, p.vpt, p.rows, p.stages) == (
        "fused", path, vpt, rows, stages)
    n4 = -(-n // 4)
    assert (vpt - 1) * matvec.NM_THREADS < n4 <= vpt * matvec.NM_THREADS


@pytest.mark.parametrize("esize", [4, 2])
def test_plan_asks_only_for_instantiated_kernels(esize):
    """Every width up to NM_MAX_N gets a tile of rows x vpt 16-byte chunks
    a thread that the source instantiates (at most 4 NM_MAX_VPT columns a
    thread: f32 vpt <= 8, bf16 / fp16 vpt <= 4), and a ring of 2 or more
    stages."""
    for n in range(2, matvec.NM_MAX_N + 1, 6):
        p = _plan(1, 100, n, esize=esize)
        assert p.route == "fused", n
        assert p.rows in (1, 2, 4) and 1 <= p.vpt <= matvec.NM_MAX_VPT
        assert p.vpt * 16 // esize <= 4 * matvec.NM_MAX_VPT, n
        assert p.rows * p.vpt <= matvec.NM_MAX_TILE_VECS, n
        assert 2 <= p.stages <= matvec.NM_MAX_STAGES, n
        assert p.stages * p.rows * 16 * p.vpt <= matvec.NM_RING_BYTES * 2


@pytest.mark.parametrize("N,m,n,want", [
    # the bf16 Fig. 3 PCG x-update: 8 KB rows four a tile, 6 stages
    (8, 25_000, 4_000, ("bulk", 1, 4, 6, 16, 2)),
    (1, 200_000, 4_000, ("bulk", 1, 4, 6, 132, 2)),
    # the bf16 Woodbury polish: 20 KB rows two a tile
    (1, 6_400, 10_000, ("bulk", 3, 2, 5, 132, 2)),
    # the widest row: 2,048 chunks of 8 columns, 4 a thread
    (1, 1_000, 16_384, ("bulk", 4, 1, 6, 125, 2)),
])
def test_plan_half_width_rows(N, m, n, want):
    """bf16 / fp16 A: 16 bytes hold 8 columns, so a row takes half the ring
    and a tile twice the rows of f32 at the same width; p and the column
    partials stay f32, so NM_MAX_N is the same."""
    p = _plan(N, m, n, esize=2)
    assert p.route == "fused"
    assert (p.path, p.vpt, p.rows, p.stages, p.ctas, p.launches) == want
    assert p.stages * p.rows * 16 * -(-n // 8) <= matvec.NM_RING_BYTES


@pytest.mark.parametrize("n,aligned,aligned4,route,path", [
    (4_000, True, True, "fused", "bulk"),
    (4_004, True, True, "fused", "scalar"),   # n % 8 == 4: 4-byte words
    (4_002, True, True, "fused", "scalar"),   # even n
    (4_000, False, True, "fused", "scalar"),  # A 4 bytes past 16
    (4_001, True, True, "composed", "scalar"),   # odd n: no 4-byte words
    (4_000, False, False, "composed", "scalar"),  # A 2 bytes past 4
    (matvec.NM_MAX_N + 8, True, True, "composed", "bulk"),
])
def test_plan_half_width_ragged_rows(n, aligned, aligned4, route, path):
    """4-byte copies move two bf16 / fp16 elements: an odd n, or A off a
    4-byte boundary, takes the composed matvec + rmatvec kernels (counted
    under their own names), never the plain version."""
    p = _plan(2, 1_000, n, aligned=aligned, esize=2, aligned4=aligned4)
    assert (p.route, p.path) == (route, path)
    # f32 rows (always on 4-byte boundaries) are whole 4-byte words
    if aligned4:
        assert _plan(2, 1_000, min(n, matvec.NM_MAX_N),
                     aligned=aligned).route == "fused"


@pytest.mark.parametrize("N,m,ctas,launches", [
    (1, 6_400, 132, 2),
    (8, 800, 16, 2),       # 200 tiles a node: 16 CTAs, 132 // 8
    (8, 400, 12, 2),       # 100 tiles a node, at least 8 a CTA
    (2, 31, 1, 1),         # 8 tiles: one CTA, which writes the output
    (150, 400, 1, 1),      # more nodes than SMs: one CTA a node
    (66, 4_000, 2, 2),
    (1, 1, 1, 1),
])
def test_plan_ctas_fill_the_card_with_whole_tiles(N, m, ctas, launches):
    p = _plan(N, m, 1_000)          # 4-row tiles
    assert (p.ctas, p.launches) == (ctas, launches)
    tiles = -(-m // p.rows)
    assert p.ctas == 1 or tiles // p.ctas >= matvec.NM_MIN_TILES


def test_plan_empty_axes_and_the_composed_route():
    assert _plan(3, 0, 7)[5:] == (0, 1)          # m = 0: shift * p, A unread
    assert _plan(3, 5, 0).launches == 0          # n = 0: an empty output
    assert _plan(0, 5, 7).launches == 0          # N = 0
    for p in (_plan(2, 100, 64, K=3), _plan(2, 100, 64, K=1),
              _plan(1, 100, matvec.NM_MAX_N + 1)):
        assert (p.route, p.launches) == ("composed", 0)
    assert _plan(1, 100, matvec.NM_MAX_N).route == "fused"


def test_wrapper_refusals_read_metadata_only():
    a = torch.zeros(3, 40, 64)
    p = torch.zeros(3, 64)
    for args in ((a.double(), p.double(), 1.0),          # not f32
                 (a, p.half(), 1.0),                     # p not f32
                 (a.bfloat16(), p.bfloat16(), 1.0),
                 (a.mT.contiguous().mT, p, 1.0),         # not row-major
                 (a, p[:, :63], 1.0),                    # p does not fit
                 (a, p[:2], 1.0),
                 (a, torch.zeros(64), 1.0),
                 (a[0], p, 1.0),
                 (torch.zeros(64), p[0], 1.0),           # a is 1-D
                 (a, p, torch.ones(63)),                 # shift does not
                 (a, p, torch.ones(3, 64)),
                 (a, p, torch.ones(128)[::2]),
                 (a, p, torch.ones(64, dtype=torch.float64)),
                 (a, p, "1.0"), (a, p, True)):
        with pytest.raises(ValueError):
            matvec.normal_args(*args)


def test_wrapper_takes_half_width_a():
    for dt in (torch.bfloat16, torch.float16):
        got = matvec.normal_args(torch.zeros(3, 40, 64, dtype=dt),
                                 torch.zeros(3, 64), torch.ones(64))
        assert (got.N, got.m, got.n, got.K, got.shift_kind) == (
            3, 40, 64, None, 2)


def test_wrapper_shift_forms():
    a, p = torch.zeros(3, 40, 64), torch.zeros(3, 64)
    got = matvec.normal_args(a, p, 2)
    assert (got.N, got.m, got.n, got.K) == (3, 40, 64, None)
    assert got[4:] == (0, 2.0, 0)                          # a value
    assert matvec.normal_args(a, p, np.float32(0.5))[4:] == (0, 0.5, 0)
    assert matvec.normal_args(a, p, torch.tensor(1.5))[4:] == (0, 1.5, 0)
    vec = torch.ones(64)
    assert matvec.normal_args(a, p, vec)[4:] == (vec.data_ptr(), 0.0, 2)
    assert matvec.normal_args(a[0], p[0], vec)[:4] == (1, 40, 64, None)
    assert matvec.normal_args(a, p[..., None], vec).K == 1


def test_registry_rows():
    assert "normal_matvec" in ops.KERNELS
    assert runtime.kernel("normal_matvec", "cuda") is matvec.normal_matvec
    assert runtime.kernel("normal_matvec", "cpu") is ref.normal_matvec_ref
    ops.reset_launch_counts()
    ops.normal_matvec_auto(torch.ones(2, 5, 3), torch.ones(2, 3), 1.0)
    assert ops.launch_counts()["normal_matvec"] == 0     # the plain row


@pytest.mark.parametrize("shape", [(70, 45), (2, 33, 21), (1, 129, 64)])
@pytest.mark.parametrize("shift_kind", ["scalar", "0-d", "vector"])
def test_cpu_path_matches_pallas(shape, shift_kind):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    p = rng.standard_normal(shape[:-2] + shape[-1:]).astype(np.float32)
    n = shape[-1]
    vec = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    shift = {"scalar": 1.5, "0-d": torch.tensor(0.25),
             "vector": torch.as_tensor(vec)}[shift_kind]
    got = matvec.normal_matvec(torch.as_tensor(a), torch.as_tensor(p), shift)
    assert got.shape == p.shape and got.dtype == torch.float32
    jshift = (jnp.asarray(vec) if shift_kind == "vector"
              else float(shift))
    a3, p3 = a.reshape((-1,) + shape[-2:]), p.reshape(-1, n)
    for z in range(a3.shape[0]):
        want = jops.normal_matvec(jnp.asarray(a3[z]), jnp.asarray(p3[z]),
                                  jshift, interpret=True)
        scale = float((np.abs(a3[z]).T @ (np.abs(a3[z]) @ np.abs(p3[z])))
                      .max())
        np.testing.assert_allclose(np.asarray(got).reshape(-1, n)[z],
                                   np.asarray(want), rtol=1e-4,
                                   atol=1e-5 * scale)

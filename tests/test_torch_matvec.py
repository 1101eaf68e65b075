"""The choices the ``matvec`` / ``rmatvec`` wrapper makes before it launches.

``repro_torch.kernels.matvec.plan`` decides, from the operands' shapes and
16-byte alignment and the card's SM count, which load path
``csrc/matvec.cu`` takes (16-byte or scalar), whether rmatvec's 128-row
slices are added by one block (one launch) or by a second kernel (two
launches), and the grid. It is a pure function
of that metadata, checked here on the CPU, together with the mirrors of the
source's constants. CPU tensors still take the plain versions, held against
the JAX package's ``ops.matvec`` / ``ops.rmatvec`` / ``ops.normal_matvec``
(Pallas in interpret mode) on the same numpy inputs, at the shapes the
choices tell apart: rtol 1e-4 / atol 1e-5 per unit of the summed
magnitudes, the JAX package's f32 kernel bound.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, matvec, ops, ref

H100_SMS = 132


def _plan(adjoint, N, m, n, K, a_aligned=True, v_aligned=True, esize=4):
    return matvec.plan(adjoint, N, m, n, K, a_aligned, v_aligned, H100_SMS,
                       esize)


def test_constants_mirror_the_cuda_source():
    src = (build.CSRC / "matvec.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kRows"]), int(consts["kTeam"]),
            int(consts["kMaxK"]), int(consts["kWarps"]),
            int(consts["kMinBlocks"]), int(consts["kRowsPerWarp1"]),
            int(consts["kRowsPerWarpK"])) == (
        matvec.ROWS_PER_SLICE, matvec.TEAM_SLICES, matvec.MAX_K,
        matvec.WARPS, matvec.MIN_BLOCKS, matvec.ROWS_PER_WARP_K1,
        matvec.ROWS_PER_WARP)
    assert "enum Path { kVec1 = 0, kVecK = 1, kScalar = 2 };" in src
    assert matvec.MATVEC_PATHS == ("vec1", "veck", "scalar")
    # one pair of C entries per element type of A, all in the signatures
    for dt, sfx in matvec.SUFFIX.items():
        assert f"MATVEC_ENTRIES({sfx}, " in src
        assert {f"matvec_{sfx}", f"rmatvec_{sfx}"} <= set(matvec._SIGNATURES)
    assert set(matvec.SUFFIX) == {torch.float32, torch.bfloat16,
                                  torch.float16}


@pytest.mark.parametrize("n,a_al,x_al,path", [
    (10_000, True, True, "vec1"),      # the Woodbury prox's nodes
    (10_000, True, False, "scalar"),   # x one float past 16 bytes
    (10_000, False, True, "scalar"),   # a one float past 16 bytes
    (250, True, True, "scalar"),       # n % 4 == 2: the split parity fit
    (1_001, True, True, "scalar"),     # n % 4 == 1
    (1_003, True, True, "scalar"),     # n % 4 == 3
])
def test_matvec_at_k1_keeps_the_first_kernels_load_path(n, a_al, x_al,
                                                        path):
    """K = 1 takes the 16-byte path exactly where the first kernel did, so
    each output keeps its summation order (an unaligned x is not copied)."""
    p = _plan(False, 8, 800, n, 1, a_al, x_al)
    assert (p.path, p.launches, p.align_x) == (path, 1, False)


@pytest.mark.parametrize("n,K,a_al,x_al,path,align_x", [
    (10_000, 3, True, True, "veck", False),    # softmax polish, X aligned
    (10_000, 3, True, False, "veck", True),    # X copied to 16 bytes
    (4_000, 8, True, False, "veck", True),     # the last one-pass K
    (4_000, 9, True, False, "veck", False),    # passes of 8, X as scalars
    (250, 3, True, True, "scalar", False),     # n % 4 != 0
    (4_000, 3, False, True, "scalar", False),  # a unaligned
])
def test_matvec_above_k1_reads_a_in_16_bytes_where_it_can(n, K, a_al, x_al,
                                                          path, align_x):
    p = _plan(False, 1, 6_400, n, K, a_al, x_al)
    assert (p.path, p.launches, p.align_x) == (path, 1, align_x)


@pytest.mark.parametrize("n,K,a_al,path", [
    (10_000, 1, True, "vec1"),       # the bf16 Woodbury prox's nodes
    (10_004, 1, True, "scalar"),     # n % 8 == 4: a row is not 16 bytes
    (4_000, 3, True, "veck"),        # bf16 softmax: X read as float4s
    (4_004, 3, True, "scalar"),
    (4_000, 1, False, "scalar"),     # a off 16 bytes
    (4_001, 1, True, "scalar"),
])
def test_matvec_half_width_rows_align_at_eight_elements(n, K, a_al, path):
    """A 16-byte load holds 8 bf16 / fp16 elements: the 16-byte paths need
    n % 8 == 0, where f32 needs n % 4 == 0; the grid is the same."""
    p = _plan(False, 8, 800, n, K, a_al, True, esize=2)
    f32 = _plan(False, 8, 800, n, K, a_al, True)
    assert p.path == path and p.grid == f32.grid
    assert p.launches == 1
    if n % 4 == 0 and a_al:
        assert f32.path != "scalar"


@pytest.mark.parametrize("N,m,n", [(8, 800, 10_000), (1, 6_400, 10_000),
                                   (1, 40_000, 4_000), (2, 300, 42)])
@pytest.mark.parametrize("K", [1, 3])
def test_rmatvec_half_width_plan_is_the_f32_plan(N, m, n, K):
    """rmatvec's lane owns 4 columns at any element size (one 8-byte load
    of bf16 / fp16): the same slices, launches and grid as f32."""
    assert _plan(True, N, m, n, K, esize=2) == _plan(True, N, m, n, K)


@pytest.mark.parametrize("N,m,K", [(8, 800, 1), (1, 6_400, 3),
                                   (1, 40_000, 1), (1, 40_000, 3),
                                   (3, 7, 1), (2, 5, 5), (1, 1, 2)])
def test_matvec_grid_has_one_warp_per_row_group(N, m, K):
    p = _plan(False, N, m, 4_000, K)
    rows = matvec.ROWS_PER_WARP_K1 if K == 1 else matvec.ROWS_PER_WARP
    groups = N * -(-m // rows)
    assert p.grid * matvec.WARPS >= groups > (p.grid - 1) * matvec.WARPS


@pytest.mark.parametrize("N,m,n,slices,launches,grid", [
    (8, 800, 10_000, 7, 1, 8 * 79),    # Woodbury prox: one block per chunk
    (4, 1_024, 10_000, 8, 1, 4 * 79),  # the most slices one block adds
    (8, 1_025, 10_000, 9, 2, None),    # one slice past that
    (8, 800, 1_000, 7, 2, None),       # 64 chunks do not fill 132 SMs
    (1, 128, 10_000, 1, 1, 79),        # one slice: always one launch
    (1, 129, 10_000, 2, 2, None),      # 79 chunks do not fill the card
    (2, 300, 40, 3, 2, None),
    (1, 6_400, 10_000, 50, 2, None),   # the stacked polish
    (1, 40_000, 4_000, 313, 2, None),
])
def test_rmatvec_one_launch_only_where_one_block_adds_the_slices(
        N, m, n, slices, launches, grid):
    p = _plan(True, N, m, n, 1)
    assert (p.path, p.slices, p.launches) == ("vec", slices, launches)
    if grid is not None:
        assert p.grid == grid


@pytest.mark.parametrize("N,m,n,K", [(1, 6_400, 10_000, 1),
                                     (1, 6_400, 10_000, 3),
                                     (1, 40_000, 4_000, 3),
                                     (8, 25_000, 4_000, 1),
                                     (2, 1_500, 33, 2), (1, 1_025, 4, 1),
                                     (1, 1_025, 4, 9)])
def test_rmatvec_slices_grid(N, m, n, K):
    """Past one block's slices the warps walk (node, slice, chunk) items:
    at K = 1 one item a warp, every item's warp in the grid; above, at most
    one wave of MIN_BLOCKS blocks an SM, every warp the same count of items
    and no block without one."""
    p = _plan(True, N, m, n, K)
    vec = n % 4 == 0
    items = N * p.slices * -(-n // (32 * (4 if vec else 1)))
    per_warp = -(-items // (p.grid * matvec.WARPS))
    assert p.launches == 2
    assert p.path == ("vec" if vec else "scalar")
    assert p.grid * matvec.WARPS * per_warp >= items
    assert (p.grid - 1) * matvec.WARPS * per_warp < items
    if K == 1:
        assert per_warp == 1
    else:
        assert p.grid <= matvec.MIN_BLOCKS * H100_SMS


def test_rmatvec_path_follows_the_columns_alignment_only():
    assert _plan(True, 8, 800, 10_000, 1, True, False).path == "vec"
    assert _plan(True, 8, 800, 10_000, 1, False, True).path == "scalar"
    assert _plan(True, 8, 800, 10_002, 1).path == "scalar"


def test_empty_reductions_launch_nothing():
    assert _plan(True, 3, 0, 5, 1).launches == 0      # A^T y over no rows
    assert _plan(False, 3, 5, 0, 2).launches == 0     # A x over no columns


@pytest.mark.parametrize("N,m,n,K", [
    (2, 60, 40, 1),      # 16-byte path, one slice
    (1, 130, 33, 1),     # scalar path, two slices, m odd past R
    (2, 129, 42, 3),     # n % 4 == 2, K = 3, a ragged last slice
    (1, 1_025, 12, 3),   # nine slices: the sliced rmatvec
    (1, 7, 20, 9),       # K past one pass of 8
    (2, 5, 3, None),     # 1-D right-hand sides
])
def test_cpu_tensors_take_the_plain_version(N, m, n, K):
    rng = np.random.default_rng(N * 1_000 + m + n)
    a = rng.standard_normal((N, m, n)).astype(np.float32)
    kk = () if K is None else (K,)
    x = rng.standard_normal((N, n, *kk)).astype(np.float32)
    y = rng.standard_normal((N, m, *kk)).astype(np.float32)
    at, xt, yt = (torch.as_tensor(v) for v in (a, x, y))
    ops.reset_launch_counts()
    got, got_t = matvec.matvec(at, xt), matvec.rmatvec(at, yt)
    assert not build.LAUNCHES["matvec"] and not build.LAUNCHES["rmatvec"]
    torch.testing.assert_close(got, ref.matvec_ref(at, xt), rtol=0, atol=0)
    torch.testing.assert_close(got_t, ref.rmatvec_ref(at, yt), rtol=0,
                               atol=0)
    for z in range(N):
        want = jops.matvec(jnp.asarray(a[z]), jnp.asarray(x[z]), block_m=64,
                           block_n=128, interpret=True)
        want_t = jops.rmatvec(jnp.asarray(a[z]), jnp.asarray(y[z]),
                              block_m=64, block_n=128, interpret=True)
        np.testing.assert_allclose(np.asarray(got[z]), np.asarray(want),
                                   rtol=1e-4, atol=1e-5 * n)
        np.testing.assert_allclose(np.asarray(got_t[z]), np.asarray(want_t),
                                   rtol=1e-4, atol=1e-5 * m)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cpu_half_width_a_takes_the_plain_version(dtype):
    """bf16 / fp16 CPU tensors reach the plain versions: A widened to f32
    (exact), an f32 product, no launch; the operand may be half-width too."""
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.standard_normal((2, 33, 21)).astype(
        np.float32)).to(dtype)
    x = torch.as_tensor(rng.standard_normal((2, 21)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((2, 33)).astype(
        np.float32)).to(dtype)
    ops.reset_launch_counts()
    got, got_t = matvec.matvec(a, x), matvec.rmatvec(a, y)
    assert not build.LAUNCHES["matvec"] and not build.LAUNCHES["rmatvec"]
    assert got.dtype == got_t.dtype == torch.float32
    assert torch.equal(got, (a.float() @ x[..., None])[..., 0])
    assert torch.equal(got_t, (a.float().mT @ y.float()[..., None])[..., 0])


@pytest.mark.parametrize("m,n", [(1_025, 12), (60, 41)])
def test_cpu_normal_matvec_is_the_composition_of_the_plain_versions(m, n):
    rng = np.random.default_rng(m + n)
    a = rng.standard_normal((m, n)).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    shift = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    got = matvec.normal_matvec(torch.as_tensor(a), torch.as_tensor(p),
                               torch.as_tensor(shift))
    want = jops.normal_matvec(jnp.asarray(a), jnp.asarray(p),
                              jnp.asarray(shift), interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * m * n)

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


def _plan(adjoint, N, m, n, K, a_aligned=True, v_aligned=True):
    return matvec.plan(adjoint, N, m, n, K, a_aligned, v_aligned, H100_SMS)


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

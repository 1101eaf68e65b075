"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; they carry the ``cuda`` marker
and skip where there is no card. Run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
They import only ``torch`` and ``repro_torch``. Tolerance: rtol 1e-4 and
an atol of 1e-5 per unit of the summed magnitudes, since the kernels sum
in another order than the plain versions (bf16 / fp16 A too: both widen it
to f32 exactly and compute in f32). Flash attention is held to the
JAX package's own bounds for it (tests/test_kernels.py): f32 rtol 2e-5 /
atol 1e-4, bf16 rtol 2e-2 / atol 1e-1; the bf16 kernel is also held to one
rounding of its output against the f32 computation.
"""
import pytest
import torch

from repro_torch.core import bicadmm, bilinear
from repro_torch.kernels import (bisect_proj, block_matvec, build,
                                 flash_attention, gram, matvec, ops, ref)

RTOL = 1e-4


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, scale):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5 * scale)


def _ladder_ref(az, th, block=256):
    """ladder_stats_ref over blocks of rungs (its (n, B) broadcast of a
    1,100,003 x 8,192 ladder would take 36 GB)."""
    return torch.cat([ref.ladder_stats_ref(az, th[i:i + block])
                      for i in range(0, th.shape[0], block)], dim=1)


# The path's shapes first; then n empty, one entry, a staged piece (4,096)
# +- 1, the composed path's MAX_N + 1 and slices of two pieces a CTA
# against B = 1, odd, the path's 128 and MAX_RUNGS (eight rung passes of
# 1,024 threads)
LADDER_CASES = [(10_000, 128), (10_001, 7), (3, 200),
                (bisect_proj.MAX_N + 1, 128)] + [
    (n, B) for n in (0, 1, 4_095, 4_097, bisect_proj.MAX_N + 1, 1_100_003)
    for B in (1, 7, 128, bisect_proj.MAX_RUNGS)
    if (n, B) != (bisect_proj.MAX_N + 1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", LADDER_CASES)
def test_cuda_ladder_stats(cuda_gen, n, B):
    """One launch a call; counts equal to the plain version's, sums within
    its check; the same bits on a repeat call; zeros for n = 0."""
    az = torch.rand(n, device="cuda", generator=cuda_gen)
    th = torch.rand(B, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    got = bisect_proj.ladder_stats(az, th)
    assert ops.launch_counts()["ladder_stats"] == 1
    want = _ladder_ref(az, th)
    _close(got[0], want[0], float(az.sum()))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got, bisect_proj.ladder_stats(az, th))
    if n == 0:
        assert not got.any()


@pytest.mark.cuda
def test_cuda_ladder_stats_is_one_device_kernel(cuda_gen):
    """The profiler sees one device kernel a call (the scratch is cached
    after the first), and unsorted rungs, a theta below every entry and one
    above all agree too."""
    from torch.profiler import ProfilerActivity, profile
    az = torch.randn(bisect_proj.MAX_N + 1, device="cuda",
                     generator=cuda_gen).abs()
    th = torch.cat([torch.rand(126, device="cuda", generator=cuda_gen),
                    torch.tensor([-1.0, 1e9], device="cuda")])
    want = ref.ladder_stats_ref(az, th)
    bisect_proj.ladder_stats(az, th)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = bisect_proj.ladder_stats(az, th)
        torch.cuda.synchronize()
    kernels = [ev.name for ev in prof.events()
               if str(ev.device_type).endswith("CUDA")]
    assert len(kernels) == 1 and "ladder_kernel" in kernels[0], kernels
    assert torch.equal(got[1], want[1])
    _close(got[0], want[0], float(az.sum()))


# The one-launch projections (csrc/ladder_proj.cu) against their plain
# versions and the sort oracles, through bilinear's dispatch: at MAX_N + 1
# the dispatch takes the ladder_stats rounds and the composed polish. The
# counts are exact, so s* is equal bit for bit; theta, z, t and u_max are
# held to rtol 1e-5 and an atol of 1e-6 x max |z| (the f32 fixpoints of
# two summation orders lie ulps apart); the sort oracle runs in f64.
PROJ_N = (1, 127, 4_000, 10_000, 12_000, bisect_proj.MAX_N,
          bisect_proj.MAX_N + 1)


def _proj_close(got, want, scale):
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                               atol=1e-6 * scale)


def _ties(gen, n, reps):
    """n entries drawn from about n / reps values, each repeated reps times."""
    vals = torch.randn(max(1, n // reps), device="cuda", generator=gen)
    vals = vals.repeat_interleave(reps)
    return torch.cat([vals] * -(-n // vals.shape[0]))[:n].contiguous()


def _l1_cases(gen, n):
    z = torch.randn(n, device="cuda", generator=gen)
    l1 = float(z.abs().sum())
    ties = _ties(gen, n, 50)
    return {"random": (z, 0.3 * l1), "t0=0": (z, 0.0),
            "inside": (z, l1 * 1.01 + 1.0),
            "apex": (z, -2.0 * float(z.abs().max()) - 1.0),
            "ties": (ties, 0.2 * float(ties.abs().sum())),
            "zeros": (torch.zeros(n, device="cuda"), 0.5),
            "tiny": (z * 1e-30, 1e-31)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", PROJ_N)
def test_cuda_l1_epigraph_proj_agrees(cuda_gen, n):
    for name, (z0, t0) in _l1_cases(cuda_gen, n).items():
        t0 = torch.tensor(t0, dtype=torch.float32, device="cuda")
        z, t = bilinear.project_l1_epigraph(z0, t0)
        scale = float(z0.abs().max())
        wz, wt, wth, _ = ref.l1_epigraph_proj_ref(z0, t0, stats=True)
        sz, st = bilinear.project_l1_epigraph_sort(z0.double(),
                                                   t0.double())
        for wz_, wt_ in ((wz, wt), (sz, st)):
            _proj_close(z, wz_, scale)
            _proj_close(t, wt_, scale)
        if n <= bisect_proj.MAX_N:           # theta, from the kernel itself
            _, _, theta, _ = bisect_proj.l1_epigraph_proj(z0, t0, stats=True)
            _proj_close(theta, wth, scale)
            if float(sz.abs().sum()) > 0:    # the f64 oracle's theta
                _proj_close(theta, st - t0.double(), scale)
        assert float(z.abs().double().sum()) <= float(t) * (1 + 1e-5) + \
            1e-6 * scale, name                                     # feasible


def _skappa_cases(gen, n):
    z = torch.randn(n, device="cuda", generator=gen)
    ties = _ties(gen, n, 40)
    sparse = torch.where(torch.rand(n, device="cuda", generator=gen) < 0.1,
                         z, 0.0)
    return {"random": (z, n / 5), "fractional": (z, n / 5 + 0.5),
            "ties": (ties, n / 3 + 0.25), "kappa>=nnz": (sparse, n / 5),
            "kappa>=n": (z, n + 3.0), "kappa=0.5": (z, 0.5),
            "zeros": (torch.zeros(n, device="cuda"), 2.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", PROJ_N)
def test_cuda_skappa_support_agrees(cuda_gen, n):
    for name, (z, kappa) in _skappa_cases(cuda_gen, n).items():
        u, s = bilinear.support_skappa_ladder(z, kappa)
        wu, ws = ref.skappa_support_ref(z, kappa)
        assert torch.equal(s, ws), name
        scale = float(z.abs().max())
        _proj_close(u, wu, scale)
        su, _ = bilinear.support_skappa_sort(z.double(), kappa)
        _proj_close(u, su, scale)
        kap32 = float(torch.tensor(kappa, dtype=torch.float32))
        assert float(s.abs().double().sum()) <= kap32 * (1 + 1e-6), name
        assert float(s.abs().max()) <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
def test_cuda_projections_every_cluster_size(cuda_gen, ctas):
    """Each cluster size agrees with the plain versions (the plan picks
    one by n; the others must hold too)."""
    for n in (ctas, 4_000, 12_000):
        z = torch.randn(n, device="cuda", generator=cuda_gen)
        t0 = torch.tensor(0.25 * float(z.abs().sum()), device="cuda")
        got = bisect_proj.l1_epigraph_proj(z, t0, ctas=ctas, stats=True)
        want = ref.l1_epigraph_proj_ref(z, t0, stats=True)
        scale = float(z.abs().max())
        for g, w in zip(got[:3], want[:3]):      # z, t, theta
            _proj_close(g, w, scale)
        u, s = bisect_proj.skappa_support(z, n / 4 + 0.5, ctas=ctas)
        wu, ws = ref.skappa_support_ref(z, n / 4 + 0.5)
        assert torch.equal(s, ws)
        _proj_close(u, wu, scale)


@pytest.mark.cuda
def test_cuda_projections_launch_once(cuda_gen):
    """A projection at the Woodbury fit's n = 10,000 is one device kernel
    (build.LAUNCHES and the profiler); past MAX_N the rounds go to
    ladder_stats, one launch a round."""
    from torch.profiler import ProfilerActivity, profile
    z = torch.randn(10_000, device="cuda", generator=cuda_gen)
    t0 = torch.tensor(5.0, device="cuda")
    bilinear.project_l1_epigraph(z, t0)          # built and loaded
    bilinear.support_skappa_ladder(z, 2_000.0)
    torch.cuda.synchronize()
    for fn in (lambda: bilinear.project_l1_epigraph(z, t0),
               lambda: bilinear.support_skappa_ladder(z, 2_000.0)):
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [ev for ev in prof.events()
                   if str(ev.device_type).endswith("CUDA")]
        assert len(kernels) == 1, [ev.name for ev in kernels]
        counts = ops.launch_counts()
        assert counts["l1_epigraph_proj"] + counts["skappa_support"] == 1
        assert counts["ladder_stats"] == 0
    big = torch.randn(bisect_proj.MAX_N + 1, device="cuda",
                      generator=cuda_gen)
    ops.reset_launch_counts()
    bilinear.project_l1_epigraph(big, t0)
    counts = ops.launch_counts()
    assert counts["ladder_stats"] == 2 and counts["l1_epigraph_proj"] == 0
    with pytest.raises(ValueError):
        bisect_proj.l1_epigraph_proj(big, t0)      # past the one launch
    with pytest.raises(ValueError):
        bisect_proj.skappa_support(z.double(), 3.0)
    with pytest.raises(RuntimeError):
        bisect_proj.l1_epigraph_proj(z, t0, ctas=3)    # no such cluster


@pytest.mark.cuda
def test_cuda_zt_and_s_updates_make_no_host_sync(cuda_gen):
    """One (7b) update (121 projections) and one (7c) update at the
    Woodbury fit's shape, d = 10,000, read nothing back to the host."""
    d = 10_000
    z0 = torch.randn(d, device="cuda", generator=cuda_gen)
    w = torch.randn(d, device="cuda", generator=cuda_gen)
    s = torch.rand(d, device="cuda", generator=cuda_gen) * 2 - 1
    t0 = torch.tensor(3.0, device="cuda")
    v = torch.tensor(0.1, device="cuda")
    bicadmm._zt_update(z0, t0, w, s, v, 8.0, 4.0, 2.0, 2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z, t = bicadmm._zt_update(z0, t0, w, s, v, 8.0, 4.0, 2.0, 120)
        s_new = bilinear.s_update(z, t, v, 2_000)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(z).all()) and bool(torch.isfinite(t))
    assert bool(torch.isfinite(s_new).all())
    assert int((s_new != 0).sum()) <= 2_001


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 130, 517), (1, 64, 64), (2, 17, 1),
                                   (2, 4000, 300), (1, 700, 1000),
                                   (3, 50, 129)])
def test_cuda_gram(cuda_gen, shape):
    """gram(x) (one operand: only the tiles on and above the diagonal, each
    written to both places) is exactly symmetric, agrees with the plain
    version and is bit-identical to the general path's full product of an
    equal copy (each entry the same f32 sum in the same k order)."""
    a = torch.randn(shape, device="cuda", generator=cuda_gen)
    for x in (a, a.mT, a[0]):
        got = gram.gram(x)
        _close(got, ref.gram_ref(x), x.shape[-2])
        assert torch.equal(got, got.mT)
        assert torch.equal(got, gram.gram_xy(x, x.clone()))
    b = torch.randn(shape[:-1] + (9,), device="cuda", generator=cuda_gen)
    _close(gram.gram_xy(a, b), ref.gram_xy_ref(a, b), shape[-2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape_x,shape_y", [
    ((2, 3000, 260), (2, 3000, 300)),   # f32, unit column stride: cp.async
    ((1, 5000, 130), (1, 5000, 7)),     # a long reduction, ragged widths
    ((3, 20, 2), (3, 20, 257)),
])
def test_cuda_gram_xy_general_path(cuda_gen, shape_x, shape_y):
    x = torch.randn(shape_x, device="cuda", generator=cuda_gen)
    y = torch.randn(shape_y, device="cuda", generator=cuda_gen)
    _close(gram.gram_xy(x, y), ref.gram_xy_ref(x, y), shape_x[-2])
    xt = torch.randn(shape_x[:1] + shape_x[:0:-1], device="cuda",
                     generator=cuda_gen).mT           # k axis unit stride
    _close(gram.gram_xy(xt, y), ref.gram_xy_ref(xt, y), shape_x[-2])
    _close(gram.gram_xy(y, xt), ref.gram_xy_ref(y, xt), shape_x[-2])


@pytest.mark.cuda
@pytest.mark.parametrize("N,m,n,M", [(2, 12_000, 1024, 4), (3, 6_001, 1000, 4),
                                     (1, 3_000, 1001, 3)])
def test_cuda_gram_long_strided_block_view(cuda_gen, N, m, n, M):
    """Every node's feature blocks as one strided (N, M, m, nb) view of A,
    as the feature split's set-up takes them (long k, one launch): the
    plain version's values, bit-identical per node to one call a node."""
    nb = n // M
    a = torch.randn(N, m, n, device="cuda", generator=cuda_gen)
    view = a[..., :M * nb].unflatten(-1, (M, nb)).permute(0, 2, 1, 3)
    ops.reset_launch_counts()
    got = gram.gram(view)
    assert ops.launch_counts()["gram"] == 1
    assert got.shape == (N, M, nb, nb) and torch.equal(got, got.mT)
    _close(got, ref.gram_ref(view), m)
    for i in range(N):
        assert torch.equal(got[i], gram.gram(view[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 1, 3, 6])
@pytest.mark.parametrize("shape", [(3, 130, 517), (1, 300, 16), (2, 5, 3)])
def test_cuda_matvec_rmatvec(cuda_gen, shape, k):
    N, m, n = shape
    a = torch.randn(shape, device="cuda", generator=cuda_gen)
    x = torch.randn((N, n) if k is None else (N, n, k), device="cuda",
                    generator=cuda_gen)
    y = torch.randn((N, m) if k is None else (N, m, k), device="cuda",
                    generator=cuda_gen)
    _close(matvec.matvec(a, x), ref.matvec_ref(a, x), n)
    _close(matvec.rmatvec(a, y), ref.rmatvec_ref(a, y), m)
    _close(matvec.matvec(a[0], x[0]), ref.matvec_ref(a[0], x[0]), n)
    _close(matvec.rmatvec(a[0], y[0]), ref.rmatvec_ref(a[0], y[0]), m)
    shift = torch.rand(n, device="cuda", generator=cuda_gen)
    p = x[..., 0] if k is not None else x
    _close(matvec.normal_matvec(a, p, shift),
           ref.normal_matvec_ref(a, p, shift), m * n)


def _misaligned(t, elems=1):
    """A contiguous copy of t whose storage starts ``elems`` elements past
    a 16-byte boundary."""
    per = 16 // t.element_size()
    buf = torch.empty(t.numel() + 2 * per, device=t.device, dtype=t.dtype)
    off = elems + (-buf.data_ptr() // t.element_size()) % per
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == elems * t.element_size()
    return out


# (N, m, n, the rmatvec plan's slices and launches): m is not a multiple of
# matvec's 4 or 2 rows a warp nor of rmatvec's 128-row slice; n % 4 is 0-3
MATVEC_PATH_SHAPES = [
    (2, 301, 16_896, 3, 1),      # one block per (node, chunk) adds 3 slices
    (2, 301, 16_897, 3, 1),      # the same on the scalar path
    (1, 1_031, 256, 9, 2),       # nine slices: partials, then their sum
    (1, 1_031, 257, 9, 2),
    (2, 259, 258, 3, 2),         # 3 slices, too few chunks for one block
    (3, 5, 259, 1, 1),           # one slice
]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 8, 9])
@pytest.mark.parametrize("N,m,n,slices,launches", MATVEC_PATH_SHAPES)
def test_cuda_matvec_rmatvec_every_path(cuda_gen, N, m, n, slices, launches,
                                        K):
    """Every load path, K across the register chunk of 8, aligned and
    misaligned operands: the plain version's values, and the plan's launch
    count."""
    a = torch.randn(N, m, n, device="cuda", generator=cuda_gen)
    x = torch.randn(N, n, K, device="cuda", generator=cuda_gen)
    y = torch.randn(N, m, K, device="cuda", generator=cuda_gen)
    p = matvec.plan(True, N, m, n, K, True, True, matvec.sm_count(a.device))
    assert (p.slices, p.launches) == (slices, launches)
    want, want_t = ref.matvec_ref(a, x), ref.rmatvec_ref(a, y)
    for aa in (a, _misaligned(a)):
        for xx in (x, _misaligned(x)):
            _close(matvec.matvec(aa, xx), want, n)
        for yy in (y, _misaligned(y)):
            ops.reset_launch_counts()
            _close(matvec.rmatvec(aa, yy), want_t, m)
            if aa is a:
                assert ops.launch_counts()["rmatvec"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("N,m,n,slices,launches", MATVEC_PATH_SHAPES)
def test_cuda_matvec_rmatvec_batched_is_one_call_a_node(cuda_gen, N, m, n,
                                                       slices, launches, K):
    """Each node's output of one batched call is bit-identical to a call on
    that node alone (rmatvec may take another path there: the sums keep
    their order), and a 1-D operand to its (..., 1) form."""
    a = torch.randn(N, m, n, device="cuda", generator=cuda_gen)
    x = torch.randn(N, n, K, device="cuda", generator=cuda_gen)
    y = torch.randn(N, m, K, device="cuda", generator=cuda_gen)
    got, got_t = matvec.matvec(a, x), matvec.rmatvec(a, y)
    for z in range(N):
        assert torch.equal(got[z], matvec.matvec(a[z], x[z]))
        assert torch.equal(got_t[z], matvec.rmatvec(a[z], y[z]))
    if K == 1:
        assert torch.equal(matvec.matvec(a, x[..., 0]), got[..., 0])
        assert torch.equal(matvec.rmatvec(a, y[..., 0]), got_t[..., 0])
        assert torch.equal(matvec.matvec(a[0], x[0, :, 0]), got[0, :, 0])
        assert torch.equal(matvec.rmatvec(a[0], y[0, :, 0]), got_t[0, :, 0])


@pytest.mark.cuda
def test_cuda_matvec_rmatvec_over_an_empty_axis_are_zeros(cuda_gen):
    """A^T y over no rows and A x over no columns are zeros, with no launch
    (a grid of no slices would not launch)."""
    ops.reset_launch_counts()
    g = matvec.rmatvec(torch.ones(2, 0, 5, device="cuda"),
                       torch.ones(2, 0, device="cuda"))
    w = matvec.matvec(torch.ones(2, 5, 0, device="cuda"),
                      torch.ones(2, 0, 3, device="cuda"))
    assert g.shape == (2, 5) and not g.any()
    assert w.shape == (2, 5, 3) and not w.any()
    assert ops.launch_counts()["rmatvec"] == ops.launch_counts()["matvec"] == 0


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_gen):
    a = torch.randn(4, 6, device="cuda", generator=cuda_gen)
    with pytest.raises(ValueError):
        matvec.matvec(a.mT, torch.ones(4, device="cuda"))   # not row-major
    with pytest.raises(ValueError):
        matvec.matvec(a.double(), torch.ones(6, device="cuda").double())
    with pytest.raises(ValueError):
        bisect_proj.ladder_stats(a, torch.ones(3, device="cuda"))


@pytest.mark.cuda
def test_cuda_launch_counts_are_device_kernel_launches(cuda_gen):
    """ladder_stats issues one kernel per call; rmatvec one within one
    128-row slice, one up to eight slices when one block per (node, column
    chunk) fills the card (the Woodbury prox's (8, 800, 10,000)), two
    otherwise; gram and matvec one."""
    a = torch.randn(2, 300, 40, device="cuda", generator=cuda_gen)
    wide = torch.randn(8, 800, 10_000, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    bisect_proj.ladder_stats(a[0, 0].abs(), torch.rand(
        8, device="cuda", generator=cuda_gen))
    matvec.rmatvec(a, torch.ones(2, 300, device="cuda"))           # 2
    matvec.rmatvec(a[:, :100].contiguous(), torch.ones(2, 100,
                                                       device="cuda"))  # 1
    matvec.rmatvec(wide, torch.ones(8, 800, device="cuda"))        # 1
    matvec.matvec(a, torch.ones(2, 40, device="cuda"))
    matvec.matvec(wide, torch.ones(8, 10_000, 3, device="cuda"))
    gram.gram(a)
    assert ops.launch_counts() == {"ladder_stats": 1, "l1_epigraph_proj": 0,
                                   "skappa_support": 0, "gram": 1,
                                   "matvec": 2, "rmatvec": 4,
                                   "normal_matvec": 0, "block_matvec": 0,
                                   "block_rmatvec": 0, "flash_attention": 0}



# csrc/normal_matvec.cu: (A^T A + diag(shift)) p reading A once. The plain
# version is the composition in f32; the kernel sums in another (fixed)
# order, so the bound is rtol 1e-4 and an atol of 1e-5 per unit of the
# summed magnitudes |A|^T (|A| |p|) + |shift| |p|.
def _normal_scale(a, p, shift):
    ab, pb = (a, p) if a.ndim == 3 else (a[None], p[None])
    s = torch.as_tensor(shift, device=a.device).abs()
    mags = torch.matmul(ab.abs().mT, torch.matmul(ab.abs(), pb.abs()[..., None]))
    return float((mags[..., 0] + s * pb.abs()).max())


def _normal_check(a, p, shift):
    """The kernel against its plain version; two calls bit for bit; the
    plan's launches counted; the output's shape and dtype."""
    ops.reset_launch_counts()
    got = matvec.normal_matvec(a, p, shift)
    again = matvec.normal_matvec(a, p, shift)
    counts = ops.launch_counts()
    N = a.shape[0] if a.ndim == 3 else 1
    pl = matvec.normal_plan(N, a.shape[-2], a.shape[-1], None,
                            a.data_ptr() % 16 == 0, matvec.sm_count(a.device))
    assert pl.route == "fused"
    assert counts["normal_matvec"] == 2 * pl.launches
    assert counts["matvec"] == counts["rmatvec"] == 0
    assert got.shape == p.shape and got.dtype == torch.float32
    assert torch.equal(got, again)
    want = ref.normal_matvec_ref(a, p, shift)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=1e-5 * _normal_scale(a, p, shift))
    return pl


def _shifts(gen, n):
    return {"float": 0.75,
            "0-d": torch.tensor(1.25, device="cuda"),
            "vector": torch.rand(n, device="cuda", generator=gen) + 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,path,launches", [
    ((6_400, 10_000), "bulk", 2),      # the Woodbury fit's stacked polish
    ((2, 200, 2_500), "bulk", 2),      # the PCG parity fit's x-update
    ((400, 2_500), "bulk", 2),         # and its stacked polish
    ((3, 301, 4_001), "scalar", 2),    # n % 4 == 1: padded stage rows
    ((2, 517, 4_002), "scalar", 2),    # n % 4 == 2
    ((1, 999, 1_003), "scalar", 2),    # N = 1, n % 4 == 3
    ((1, 5, 3), "scalar", 1),          # one CTA: it writes the output
    ((150, 40, 64), "bulk", 1),        # more nodes than CTAs a node
    ((70, 16_384), "bulk", 2),         # the widest row: vpt 8, 3 stages
    ((2, 33, 12_288), "bulk", 2),      # 48 KB rows: 1-row tiles, 4 stages
])
def test_cuda_normal_matvec_agrees(cuda_gen, shape, path, launches):
    a = torch.randn(shape, device="cuda", generator=cuda_gen)
    p = torch.randn(shape[:-2] + shape[-1:], device="cuda",
                    generator=cuda_gen)
    for shift in _shifts(cuda_gen, shape[-1]).values():
        pl = _normal_check(a, p, shift)
        assert (pl.path, pl.launches) == (path, launches)


@pytest.mark.cuda
def test_cuda_normal_matvec_at_the_fig3_shapes(cuda_gen):
    """The PCG x-update's (8, 25,000, 4,000) with a scalar shift, and its
    stacked polish (200,000, 4,000) with a vector shift: A is 3.2 GB."""
    a = torch.randn(8, 25_000, 4_000, device="cuda", generator=cuda_gen)
    p = torch.randn(8, 4_000, device="cuda", generator=cuda_gen)
    assert _normal_check(a, p, 4.1).ctas == 16
    flat = a.view(-1, 4_000)
    shift = torch.rand(4_000, device="cuda", generator=cuda_gen) + 1e-3
    assert _normal_check(flat, p[0], shift).ctas == matvec.sm_count(a.device)


@pytest.mark.cuda
def test_cuda_normal_matvec_unaligned_a_and_empty_axes(cuda_gen):
    """A starting one float past 16 bytes takes the scalar path; m = 0 is
    shift * p from the second kernel alone (A unread); n = 0 and N = 0
    launch nothing."""
    a = _misaligned(torch.randn(2, 300, 1_000, device="cuda",
                                generator=cuda_gen))
    p = torch.randn(2, 1_000, device="cuda", generator=cuda_gen)
    for shift in _shifts(cuda_gen, 1_000).values():
        assert _normal_check(a, p, shift).path == "scalar"
    shift = torch.rand(7, device="cuda", generator=cuda_gen)
    p = torch.randn(3, 7, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    got = matvec.normal_matvec(torch.empty(3, 0, 7, device="cuda"), p, shift)
    assert ops.launch_counts()["normal_matvec"] == 1
    assert torch.equal(got, shift * p)
    for a0, p0 in ((torch.empty(3, 5, 0, device="cuda"),
                    torch.empty(3, 0, device="cuda")),
                   (torch.empty(0, 5, 7, device="cuda"),
                    torch.empty(0, 7, device="cuda"))):
        got = matvec.normal_matvec(a0, p0, 1.0)
        assert got.shape == p0.shape
    assert ops.launch_counts()["normal_matvec"] == 1


@pytest.mark.cuda
def test_cuda_normal_matvec_composes_with_a_right_hand_side_axis(cuda_gen):
    """A p with a K axis (no caller passes one) takes the matvec and
    rmatvec kernels, as the plan says."""
    a = torch.randn(2, 300, 256, device="cuda", generator=cuda_gen)
    p = torch.randn(2, 256, 3, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    got = matvec.normal_matvec(a, p, 0.5)
    counts = ops.launch_counts()
    assert counts["normal_matvec"] == 0 and counts["matvec"] == 1
    _close(got, ref.normal_matvec_ref(a, p, 0.5), 300 * 256)


@pytest.mark.cuda
def test_cuda_normal_matvec_makes_no_host_sync(cuda_gen):
    """A 0-d CUDA shift is read on the device: the call reads nothing back
    to the host."""
    a = torch.randn(8, 800, 4_000, device="cuda", generator=cuda_gen)
    p = torch.randn(8, 4_000, device="cuda", generator=cuda_gen)
    shift = torch.tensor(2.5, device="cuda")
    want = matvec.normal_matvec(a, p, shift)        # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = matvec.normal_matvec(a, p, shift)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    assert torch.equal(want, matvec.normal_matvec(a, p, 2.5))


@pytest.mark.cuda
def test_cuda_normal_matvec_refuses(cuda_gen):
    a = torch.randn(3, 40, 64, device="cuda", generator=cuda_gen)
    p = torch.randn(3, 64, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    for args in ((a.double(), p.double(), 1.0),          # not f32
                 (a.mT.contiguous().mT, p, 1.0),         # not row-major
                 (a, p[:, :63], 1.0),                    # p does not fit
                 (a, p, torch.ones(63, device="cuda")),  # shift does not
                 (a, p, torch.ones(3, 64, device="cuda")),
                 (a, p, torch.ones(64, device="cuda").double())):
        with pytest.raises(ValueError):
            matvec.normal_matvec(*args)
    assert ops.launch_counts()["normal_matvec"] == 0


@pytest.mark.cuda
def test_cuda_pcg_fit_agrees_with_the_cpu_fit(cuda_gen):
    """chip_smoke's fourth parity fit: the Woodbury parity data through the
    PCG x-update (normal_matvec every CG step), card against the port's
    CPU fit: the same status and support, coef within 1e-3, iterations
    within 2."""
    import numpy as np

    from repro_torch import api
    from repro_torch.data import SyntheticSpec, make_sparse_regression
    spec = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
    As, bs, _ = make_sparse_regression(1, spec)
    kw = dict(kappa=spec.kappa, gamma=10.0, rho_c=4.0, tol=1e-4,
              max_iter=300, x_solver="pcg")
    ops.reset_launch_counts()
    card = api.SparseLinearRegression(**kw).fit(As, bs).result_
    assert ops.launch_counts()["normal_matvec"] > 0
    cpu = api.SparseLinearRegression(device="cpu", **kw).fit(As, bs).result_
    assert int(card.status) == int(cpu.status)
    assert torch.equal(card.support.cpu(), cpu.support)
    np.testing.assert_allclose(card.coef.cpu().numpy(), cpu.coef.numpy(),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(card.iters) - int(cpu.iters)) <= 2

def _half_views(gen, dtype):
    """{name: (operand, expected path bits)} of the half-width Gram: nx not
    a multiple of 8 or of the 64-wide tile, m not a multiple of the 32-deep
    k-slice, an odd-n view 2 bytes past 16, the (N, M, m, nb) strided block
    view, and the transposed view A A^T takes."""
    XK, YK, VEC = gram.XK, gram.YK, gram.VEC
    a = torch.randn(2, 1000, 520, device="cuda", generator=gen).to(dtype)
    r = torch.randn(3, 130, 517, device="cuda", generator=gen).to(dtype)
    o = torch.randn(2 * 301 * 1001 + 1, device="cuda",
                    generator=gen).to(dtype)[1:].view(2, 301, 1001)
    assert o.data_ptr() % 16 == 2
    blk = torch.randn(2, 600, 1024, device="cuda", generator=gen).to(dtype)
    rag = torch.randn(3, 601, 1000, device="cuda", generator=gen).to(dtype)
    return {
        "A^T A m%32=8 nx%64=8": (a, VEC),
        "A A^T m%32=8 nx%64=40": (a.mT, XK | YK | VEC),
        "A^T A nx=517": (r, 0),
        "A A^T m=517": (r.mT, XK | YK),
        "one node, tile-exact": (a[0, :64, :64].contiguous(), VEC),
        "odd n, 2 bytes past 16": (o, 0),
        "odd n transposed": (o.mT, XK | YK),
        "block view nb=256": (blk.unflatten(-1, (4, 256)).permute(0, 2, 1, 3),
                              VEC),
        "block view nb=250": (rag.unflatten(-1, (4, 250)).permute(0, 2, 1, 3),
                              0),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_half_width_gram_on_the_tensor_cores(cuda_gen, dtype):
    """Each view through the FP64 tensor-core kernel, one launch a call:
    within one f32 rounding of the plain version (an f64 product rounded
    once), exactly symmetric, equal bit for bit to the general path's full
    product of an equal copy and to a repeat call."""
    for name, (x, path) in _half_views(cuda_gen, dtype).items():
        assert gram.half_path(x, x) == path, name
        ops.reset_launch_counts()
        got = gram.gram(x)
        assert ops.launch_counts()["gram"] == 1, name
        torch.testing.assert_close(got, ref.gram_ref(x), rtol=2.0 ** -23,
                                   atol=0.0, msg=name)
        assert torch.equal(got, got.mT), name
        assert torch.equal(got, gram.gram_xy(x, x.clone())), name
        assert torch.equal(got, gram.gram(x)), name
        y = torch.randn(x.shape[:-1] + (70,), device="cuda",
                        generator=cuda_gen).to(dtype)
        for u, v in ((x, y), (y, x), (x.mT.contiguous().mT, y)):
            torch.testing.assert_close(gram.gram_xy(u, v),
                                       ref.gram_xy_ref(u, v),
                                       rtol=2.0 ** -23, atol=0.0, msg=name)


@pytest.mark.cuda
def test_cuda_half_width_gram_issues_dmma(cuda_gen):
    """cuobjdump's SASS of the built gram library: every bf16 / fp16
    instantiation issues DMMA (the FP64 tensor cores); the f32 kernel none."""
    import os
    import subprocess
    lib = build.library("gram", gram._SIGNATURES)
    del lib
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path("gram"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = {f.split("\n", 1)[0].strip(): f
             for f in sass.split("Function : ")[1:]}
    half = [k for k in funcs if "gram_dmma_kernel" in k]
    f32 = [k for k in funcs if "gram_xy_kernel" in k]
    assert len(half) == 16 and len(f32) == 2, list(funcs)
    assert all("DMMA" in funcs[k] for k in half)
    assert not any("DMMA" in funcs[k] for k in f32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_reduced_precision_operands_widen_to_f32(cuda_gen, dtype):
    """bf16/fp16 operands are widened to f32 as they load (gram, matvec,
    rmatvec, normal_matvec); the plain versions widen first too, so the f32
    bound holds (the Gram's f64 sums to one rounding). The registry rows
    round to the operands' promotion."""
    a = torch.randn(2, 70, 45, device="cuda", generator=cuda_gen).to(dtype)
    x = torch.randn(2, 45, device="cuda", generator=cuda_gen).to(dtype)
    # the Gram of half-width data is summed in f64 on both sides: within
    # one f32 rounding of the plain version
    for v in (a.mT, a):
        torch.testing.assert_close(gram.gram(v), ref.gram_ref(v),
                                   rtol=2.0 ** -23, atol=0.0)
    got = matvec.matvec(a, x)
    assert got.dtype == torch.float32
    _close(got, ref.matvec_ref(a, x), 45)
    assert ops.matvec_auto(a, x).dtype == dtype
    assert ops.matvec_auto(a, x.float()).dtype == torch.float32
    assert ops.matvec_auto(a, x, torch.float32).dtype == torch.float32
    p = torch.randn(2, 45, device="cuda", generator=cuda_gen)
    _close(matvec.normal_matvec(a, p, 0.5), ref.normal_matvec_ref(a, p, 0.5),
           70 * 45)
    with pytest.raises(ValueError):       # p must be f32 (the iterates)
        matvec.normal_matvec(a, p.to(dtype), 0.5)


# (N, m, n) of the half-width GEMVs: matvec's 16-byte paths need n % 8 ==
# 0, rmatvec's n % 4 == 0; m is not a multiple of 4, 2 or 128 rows
HALF_SHAPES = [
    (2, 301, 16_896),    # 16-byte paths; one rmatvec block adds 3 slices
    (2, 301, 16_900),    # n % 8 == 4: matvec scalar, rmatvec 4 columns
    (1, 1_031, 258),     # nine slices, scalar rmatvec
    (3, 5, 259),         # odd n, one slice
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("N,m,n", HALF_SHAPES)
def test_cuda_half_width_matvec_rmatvec(cuda_gen, dtype, K, N, m, n):
    """matvec_bf16/f16 and rmatvec_bf16/f16 against the plain versions, A
    aligned and one element past 16 bytes, X aligned and not, a half-width
    Y widened by the wrapper; one launch or the plan's two."""
    a = torch.randn(N, m, n, device="cuda", generator=cuda_gen).to(dtype)
    x = torch.randn(N, n, K, device="cuda", generator=cuda_gen)
    y = torch.randn(N, m, K, device="cuda", generator=cuda_gen)
    pl = matvec.plan(True, N, m, n, K, True, True, matvec.sm_count(a.device),
                     2)
    want, want_t = ref.matvec_ref(a, x), ref.rmatvec_ref(a, y)
    for aa in (a, _misaligned(a)):
        for xx in (x, _misaligned(x)):
            ops.reset_launch_counts()
            got = matvec.matvec(aa, xx)
            assert ops.launch_counts()["matvec"] == 1
            assert got.dtype == torch.float32
            _close(got, want, n)
        ops.reset_launch_counts()
        _close(matvec.rmatvec(aa, y), want_t, m)
        if aa is a:
            assert ops.launch_counts()["rmatvec"] == pl.launches
        y16 = y.to(dtype)
        _close(matvec.rmatvec(aa, y16), ref.rmatvec_ref(a, y16), m)
    if K == 1:
        assert torch.equal(matvec.matvec(a[0], x[0, :, 0]),
                           matvec.matvec(a, x)[0, :, 0])
        assert torch.equal(matvec.rmatvec(a, y[..., 0]),
                           matvec.rmatvec(a, y)[..., 0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_half_width_over_an_empty_axis_are_zeros(cuda_gen, dtype):
    ops.reset_launch_counts()
    g = matvec.rmatvec(torch.ones(2, 0, 5, device="cuda", dtype=dtype),
                       torch.ones(2, 0, device="cuda"))
    w = matvec.matvec(torch.ones(2, 5, 0, device="cuda", dtype=dtype),
                      torch.ones(2, 0, 3, device="cuda"))
    assert g.shape == (2, 5) and not g.any()
    assert w.shape == (2, 5, 3) and not w.any()
    # m = 0: shift * p from the sum kernel alone (n % 8 == 0: the fused
    # route); at odd n the composed route, whose products are empty
    for n, launches in ((8, 1), (7, 0)):
        p = torch.randn(3, n, device="cuda", generator=cuda_gen)
        shift = torch.rand(n, device="cuda", generator=cuda_gen)
        ops.reset_launch_counts()
        got = matvec.normal_matvec(torch.empty(3, 0, n, device="cuda",
                                               dtype=dtype), p, shift)
        assert torch.equal(got, shift * p)
        counts = ops.launch_counts()
        assert counts["normal_matvec"] == launches
        assert counts["matvec"] == counts["rmatvec"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,route,path", [
    ((6_400, 10_000), "fused", "bulk"),   # the bf16 Woodbury polish
    ((2, 200, 2_500), "fused", "scalar"),  # n % 8 == 4: 4-byte copies
    ((2, 517, 4_002), "fused", "scalar"),
    ((1, 999, 1_000), "fused", "bulk"),
    ((150, 40, 64), "fused", "bulk"),     # one CTA a node: one launch
    ((70, 16_384), "fused", "bulk"),      # the widest row, vpt 4
    ((2, 33, 12_288), "fused", "bulk"),
    ((3, 301, 4_001), "composed", "scalar"),  # odd n: matvec + rmatvec
    ((1, 5, 3), "composed", "scalar"),
])
def test_cuda_half_width_normal_matvec(cuda_gen, dtype, shape, route, path):
    """normal_matvec_bf16/f16 with a float, 0-d and vector shift against
    the plain version (w in f32); two calls bit for bit; odd n takes the
    half-width matvec and rmatvec kernels, counted under their names."""
    a = torch.randn(shape, device="cuda", generator=cuda_gen).to(dtype)
    p = torch.randn(shape[:-2] + shape[-1:], device="cuda",
                    generator=cuda_gen)
    N = shape[0] if len(shape) == 3 else 1
    for aa, want_route, want_path in ((a, route, path),
                                      (_misaligned(a, 2), route, "scalar"),
                                      (_misaligned(a, 1), "composed", None)):
        pl = matvec.normal_plan(N, shape[-2], shape[-1], None,
                                aa.data_ptr() % 16 == 0,
                                matvec.sm_count(a.device), 2,
                                aa.data_ptr() % 4 == 0)
        assert pl.route == want_route
        assert want_path is None or pl.path == want_path
        for shift in _shifts(cuda_gen, shape[-1]).values():
            ops.reset_launch_counts()
            got = matvec.normal_matvec(aa, p, shift)
            assert torch.equal(got, matvec.normal_matvec(aa, p, shift))
            counts = ops.launch_counts()
            if pl.route == "fused":
                assert counts["normal_matvec"] == 2 * pl.launches
                assert counts["matvec"] == counts["rmatvec"] == 0
            else:
                assert counts["normal_matvec"] == 0
                assert counts["matvec"] == 2 and counts["rmatvec"] >= 2
            assert got.shape == p.shape and got.dtype == torch.float32
            torch.testing.assert_close(
                got, ref.normal_matvec_ref(a, p, shift), rtol=RTOL,
                atol=1e-5 * _normal_scale(a.float(), p, shift))


@pytest.mark.cuda
def test_cuda_half_width_normal_matvec_at_the_fig3_shapes(cuda_gen):
    """The bf16 PCG x-update's (8, 25,000, 4,000) (A is 1.6 GB) and its
    stacked polish (200,000, 4,000)."""
    a = torch.randn(8, 25_000, 4_000, device="cuda",
                    generator=cuda_gen).to(torch.bfloat16)
    p = torch.randn(8, 4_000, device="cuda", generator=cuda_gen)
    flat = a.view(-1, 4_000)
    shift = torch.rand(4_000, device="cuda", generator=cuda_gen) + 1e-3
    for aa, pp, s in ((a, p, 4.1), (flat, p[0], shift)):
        got = matvec.normal_matvec(aa, pp, s)
        torch.testing.assert_close(
            got, ref.normal_matvec_ref(aa, pp, s), rtol=RTOL,
            atol=1e-5 * _normal_scale(aa.float(), pp, s))


@pytest.mark.cuda
@pytest.mark.parametrize("precision,x_solver", [("bf16", "woodbury"),
                                                ("fp16", "pcg")])
def test_cuda_reduced_precision_fit_agrees_with_the_cpu_fit(
        cuda_gen, precision, x_solver):
    """chip_smoke's reduced-precision parity fits: the Woodbury parity data
    cast to bf16 / fp16, card against the port's CPU fit: the same status
    and support, coef within 1e-3, iterations within 2; the half-width
    kernels launch."""
    import numpy as np

    from repro_torch import api
    from repro_torch.data import SyntheticSpec, make_sparse_regression
    spec = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
    As, bs, _ = make_sparse_regression(1, spec)
    kw = dict(kappa=spec.kappa, gamma=10.0, rho_c=4.0, tol=1e-4,
              max_iter=300, x_solver=x_solver, precision=precision)
    ops.reset_launch_counts()
    card = api.SparseLinearRegression(**kw).fit(As, bs).result_
    counts = ops.launch_counts()
    assert counts["normal_matvec" if x_solver == "pcg" else "matvec"] > 0
    cpu = api.SparseLinearRegression(device="cpu", **kw).fit(As, bs).result_
    assert int(card.status) == int(cpu.status)
    assert torch.equal(card.support.cpu(), cpu.support)
    np.testing.assert_allclose(card.coef.cpu().numpy(), cpu.coef.numpy(),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(card.iters) - int(cpu.iters)) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("shape", [
    (2, 300, 250, 4),    # ragged: nb = 63, not a multiple of 4
    (3, 130, 517, 3),    # odd n: no segment starts 16-byte aligned
    (2, 300, 256, 4),    # every segment aligned: the 16-byte loads
    (1, 5, 5, 4),        # the last block holds no column at all
])
def test_cuda_block_matvec_rmatvec(cuda_gen, shape, K):
    N, m, n, M = shape
    nb = -(-n // M)
    a = torch.randn((N, m, n), device="cuda", generator=cuda_gen)
    x = torch.randn((N, M, nb, K), device="cuda", generator=cuda_gen)
    y = torch.randn((N, M, m, K), device="cuda", generator=cuda_gen)
    _close(block_matvec.block_matvec(a, x, M),
           ref.block_matvec_ref(a, x, M), nb)
    got = block_matvec.block_rmatvec(a, y, M)
    _close(got, ref.block_rmatvec_ref(a, y, M), m)
    assert not got.reshape(N, M * nb, K)[:, n:].any()   # padded rows: 0
    # a segment that starts at an odd column: the data seen from column 1
    a1 = a[..., 1:].contiguous()
    nb1 = -(-(n - 1) // M)
    x1 = x[:, :, :nb1].contiguous()
    _close(block_matvec.block_matvec(a1, x1, M),
           ref.block_matvec_ref(a1, x1, M), nb1)


@pytest.mark.cuda
def test_cuda_block_launch_counts_and_refusals(cuda_gen):
    """block_matvec is one launch a call; block_rmatvec one when its rows
    fit one slice and two (slices + the ordered sum) past that. A
    non-contiguous a is refused, never copied."""
    a = torch.randn(2, 4000, 64, device="cuda", generator=cuda_gen)
    small = a[:, :100].contiguous()
    x = torch.randn(2, 4, 16, 1, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    block_matvec.block_matvec(a, x, 4)
    block_matvec.block_rmatvec(a, torch.ones(2, 4, 4000, 1, device="cuda"), 4)
    block_matvec.block_rmatvec(small, torch.ones(2, 4, 100, 1,
                                                 device="cuda"), 4)
    counts = ops.launch_counts()
    assert (counts["block_matvec"], counts["block_rmatvec"]) == (1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        block_matvec.block_matvec(a.mT.contiguous().mT, x, 4)
    with pytest.raises(ValueError, match="contiguous"):
        block_matvec.block_rmatvec(a[:, :, :32], torch.ones(
            2, 4, 4000, 1, device="cuda"), 4)
    with pytest.raises(ValueError):
        block_matvec.block_matvec(a, x[:, :3], 4)       # wrong block count


FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 1e-1)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
@pytest.mark.parametrize("BH,BHkv,Sq,Sk,causal", [
    (4, 4, 128, 128, True),      # group 1, whole tiles
    (6, 2, 100, 100, True),      # group 3, ragged S
    (8, 2, 1000, 1000, True),    # group 4, ragged over many tiles
    (16, 2, 200, 100, False),    # group 8, non-causal, Sk < block_k
    (6, 2, 64, 256, False),      # Sq != Sk, non-causal
    (8, 2, 70, 300, True),       # Sq < Sk, causal (top-left aligned)
    (3, 1, 1, 5, True),          # one query row
])
def test_cuda_flash_attention(cuda_gen, BH, BHkv, Sq, Sk, causal, Dh,
                              dtype):
    q = torch.randn(BH, Sq, Dh, device="cuda", generator=cuda_gen).to(dtype)
    k = torch.randn(BHkv, Sk, Dh, device="cuda", generator=cuda_gen).to(dtype)
    v = torch.randn(BHkv, Sk, Dh, device="cuda", generator=cuda_gen).to(dtype)
    got = flash_attention.flash_attention_flat(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_flat_ref(q, k, v, causal=causal)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_cuda_flash_attention_scale_and_model_layout(cuda_gen):
    bf = torch.bfloat16
    q = torch.randn(2, 300, 8, 64, device="cuda", generator=cuda_gen).to(bf)
    k = torch.randn(2, 300, 2, 64, device="cuda", generator=cuda_gen).to(bf)
    v = torch.randn(2, 300, 2, 64, device="cuda", generator=cuda_gen).to(bf)
    got = ops.flash_attention(q, k, v)
    assert got.dtype == bf
    flat = [t.float().transpose(1, 2).reshape(-1, 300, 64)
            for t in (q, k, v)]
    want = ref.flash_attention_flat_ref(*flat).reshape(2, 8, 300, 64)
    torch.testing.assert_close(got.float(), want.transpose(1, 2),
                               rtol=2 ** -8, atol=1e-4)
    got = flash_attention.flash_attention_flat(*flat, sm_scale=0.05)
    torch.testing.assert_close(
        got, ref.flash_attention_flat_ref(*flat, sm_scale=0.05),
        rtol=2e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_launches_once_and_refuses(cuda_gen):
    q = torch.randn(8, 200, 64, device="cuda", generator=cuda_gen)
    k = torch.randn(2, 200, 64, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    flash_attention.flash_attention_flat(q, k, k)
    ops.flash_attention_auto(q, k, k)
    assert ops.launch_counts()["flash_attention"] == 2
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention_flat(q[..., :48].contiguous(),
                                             k[..., :48].contiguous(),
                                             k[..., :48].contiguous())
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention.flash_attention_flat(q, k, k, causal=False)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_flat(q.mT.contiguous().mT, k, k)
    for dt in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="the kernel takes one of"):
            flash_attention.flash_attention_flat(q.to(dt), k.to(dt),
                                                 k.to(dt))
    assert ops.launch_counts()["flash_attention"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("BH,BHkv,Sq,Sk,Dh,causal", [
    (4, 2, 200, 200, 128, True),
    (6, 2, 130, 300, 64, True),       # Sq < Sk
    (8, 2, 70, 100, 32, False),       # Sk < one key tile
    (3, 3, 129, 129, 16, True),       # one key tile and one key
])
def test_cuda_flash_attention_bf16_reads_no_key_past_sk(cuda_gen, BH, BHkv,
                                                        Sq, Sk, Dh, causal):
    """Ragged Sq and Sk with every other KV head filled with 1e3: the rows
    just past a head's Sk keys are the next head's, so a key or value read
    across the boundary breaks the one-rounding check."""
    bf = torch.bfloat16
    q = torch.randn(BH, Sq, Dh, device="cuda", generator=cuda_gen).to(bf)
    k = torch.randn(BHkv, Sk, Dh, device="cuda", generator=cuda_gen)
    v = torch.randn(BHkv, Sk, Dh, device="cuda", generator=cuda_gen)
    k[1::2], v[1::2] = 1e3, 1e3
    k, v = k.to(bf), v.to(bf)
    got = flash_attention.flash_attention_flat(q, k, v, causal=causal)
    want = ref.flash_attention_flat_ref(q.float(), k.float(), v.float(),
                                        causal=causal)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,BHkv,Sq,Sk,Dh,causal", [
    (8, 2, 2048, 2048, 128, True), (4, 4, 333, 333, 64, True),
    (6, 2, 130, 512, 32, False), (3, 1, 77, 77, 16, True),
    # fewer keys than the K/V ring holds: below one tile, one tile and one
    # key, two tiles and one key (a non-causal Sk above 128 is a multiple
    # of 128, as in the JAX package)
    *[(4, 2, sk + 3, sk, 128, True) for sk in (1, 64, 127, 128, 129, 257)],
    *[(4, 2, sk + 3, sk, 128, False) for sk in (1, 64, 127, 128, 256)]])
def test_cuda_flash_attention_bf16_within_one_rounding(cuda_gen, BH, BHkv,
                                                       Sq, Sk, Dh, causal):
    """The bf16 (tensor-core) kernel against the f32 computation on the
    same bf16 inputs: within one rounding of its bf16 output (rtol 2^-8)
    plus 1e-4. sm_scale 1 makes each row's softmax peaked, so a missed or
    misplaced key shows."""
    bf = torch.bfloat16
    q = torch.randn(BH, Sq, Dh, device="cuda", generator=cuda_gen).to(bf)
    k = torch.randn(BHkv, Sk, Dh, device="cuda", generator=cuda_gen).to(bf)
    v = torch.randn(BHkv, Sk, Dh, device="cuda", generator=cuda_gen).to(bf)
    for sm_scale in (None, 1.0):
        got = flash_attention.flash_attention_flat(q, k, v, causal=causal,
                                                   sm_scale=sm_scale)
        want = ref.flash_attention_flat_ref(q.float(), k.float(), v.float(),
                                            causal=causal, sm_scale=sm_scale)
        torch.testing.assert_close(got.float(), want, rtol=2 ** -8,
                                   atol=1e-4)

"""The main path's leftovers in the port (repro_torch.core.bilinear's
support_skappa, bisection oracles and Theorem 2.1 certificate, the sort
projection as a config option, subsolver.pad_features, the fleet loss maps,
results.mark_aborted) against the JAX package's, on the CPU, same numpy
data; and the lane forms of the projections against their solo forms.

Tolerances: the projections at the JAX ladder tests' atol 1e-5 (f32 sums
in another order), s* and supports exactly; fits at
tests/test_torch_bicadmm.py's bounds (the same status and support, coef
within 1e-3, iterations within 2). A lane of the plain lane versions
(``kernels.ref``) and of the CPU lane path (``core.bilinear``) equals the
solo one on that row bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import bilinear as jbl
from repro.core import fleet as jfleet
from repro.core import results as jresults
from repro.core import subsolver as jsub
from repro.core.losses import get_loss as jax_get_loss
from repro_torch import api, runtime
from repro_torch.core import BiCADMM, BiCADMMConfig, bilinear as tbl
from repro_torch.core import fleet, losses, results, subsolver
from repro_torch.kernels import bisect_proj, matvec, ref
from repro_torch.data import SyntheticSpec, make_sparse_regression

ATOL = 1e-5


def _vec(seed, n, ties=True):
    """A vector with zeros and, if ``ties``, a tie cluster."""
    z = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    if ties and n >= 8:
        z[:3] = 0.0
        z[3:7] = z[3]
        z[7] = -z[3]
    return z


def _lanes(seed, B, d):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((B, d))
         * rng.random((B, 1))).astype(np.float32)
    if d >= 8:
        z[:, :2] = 0.0
        z[::2, 2:6] = z[::2, 2:3]
    return torch.as_tensor(z)


# ------------------------------------------------------- bilinear oracles ----
@pytest.mark.parametrize("kappa", [0, 1, 2.5, 5, 7.25, 12, 40])
@pytest.mark.parametrize("seed,n", [(0, 12), (1, 33), (2, 300)])
def test_support_skappa_matches_jax(seed, n, kappa):
    """Static kappa: the top-k LP, ties to the lower index (jax top_k)."""
    z = _vec(seed, n)
    u, s = tbl.support_skappa(torch.as_tensor(z), kappa)
    ju, js = jbl.support_skappa(jnp.asarray(z), kappa)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(float(u), float(ju), rtol=1e-6, atol=ATOL)


def test_support_skappa_with_a_tensor_kappa_takes_the_sort_oracle():
    z = _vec(3, 50)
    for kappa in (4.0, 9.5):
        u, s = tbl.support_skappa(torch.as_tensor(z), torch.tensor(kappa))
        ju, js = jbl.support_skappa(jnp.asarray(z), jnp.asarray(kappa))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_allclose(float(u), float(ju), rtol=1e-6,
                                   atol=ATOL)


@pytest.mark.parametrize("iters", [10, 60])
@pytest.mark.parametrize("seed,n", [(4, 12), (5, 257)])
def test_bisect_oracles_match_jax(seed, n, iters):
    z = _vec(seed, n)
    for t0 in (-1.0, 0.5, 0.3 * float(np.abs(z).sum()), 1e3):
        zz, tt = tbl.project_l1_epigraph_bisect(torch.as_tensor(z), t0,
                                                iters=iters)
        jz, jt = jbl.project_l1_epigraph_bisect(jnp.asarray(z), t0,
                                                iters=iters)
        np.testing.assert_allclose(zz.numpy(), np.asarray(jz), atol=ATOL)
        np.testing.assert_allclose(float(tt), float(jt), atol=ATOL)
    for kappa in (0, 3, 6.5, n):
        u, s = tbl.support_skappa_bisect(torch.as_tensor(z), kappa,
                                         iters=iters)
        ju, js = jbl.support_skappa_bisect(jnp.asarray(z), kappa,
                                           iters=iters)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)
        np.testing.assert_allclose(float(u), float(ju), rtol=1e-6,
                                   atol=ATOL)


def test_check_theorem_certificate_matches_jax():
    x = _vec(6, 20, ties=False)
    x[np.argsort(np.abs(x))[:14]] = 0.0            # 6-sparse
    for kappa in (6, 4, 10):
        got = tbl.check_theorem_certificate(torch.as_tensor(x), kappa)
        want = jbl.check_theorem_certificate(jnp.asarray(x), kappa)
        assert sorted(got) == sorted(want)
        for name in got:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       atol=ATOL, err_msg=name)
    assert float(tbl.check_theorem_certificate(torch.as_tensor(x),
                                               4)["l1_s"]) == 2.0


# ------------------------------------------------- projection="sort" fits ----
SPEC = SyntheticSpec(2, 40, 60, sparsity_level=0.75, noise=1e-3)
FIT_KW = dict(kappa=SPEC.kappa, gamma=10.0, rho_c=1.0, max_iter=150,
              tol=1e-4, zt_iters=20)


def test_sort_projection_fit_matches_jax():
    """BiCADMMConfig.projection="sort": the (7b) and (7c) oracles through
    a whole fit, against the JAX engine's; the api takes the option."""
    As, bs, _ = make_sparse_regression(1, SPEC)
    kw = dict(FIT_KW, projection="sort", x_solver="woodbury")
    res = BiCADMM("squared", BiCADMMConfig(**kw)).fit(torch.as_tensor(As),
                                                      torch.as_tensor(bs))
    jres = JaxBiCADMM("squared", JaxConfig(**kw)).fit(jnp.asarray(As),
                                                      jnp.asarray(bs))
    assert int(res.status) == int(jres.status)
    np.testing.assert_array_equal(res.support.numpy(),
                                  np.asarray(jres.support))
    np.testing.assert_allclose(res.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(res.iters) - int(jres.iters)) <= 2
    est = api.SparseLinearRegression(device="cpu", projection="sort",
                                     x_solver="woodbury",
                                     **{k: v for k, v in FIT_KW.items()})
    assert torch.equal(est.fit(As, bs).support_, res.support)
    with pytest.raises(ValueError, match="projection"):
        BiCADMM("squared", BiCADMMConfig(kappa=3, projection="bisect"))


def test_sort_projection_fleet_matches_jax():
    """The sort oracles on a lane axis: a fleet with projection="sort"."""
    rng = np.random.default_rng(8)
    As = rng.standard_normal((3, 2, 20, 10)).astype(np.float32)
    xs = rng.standard_normal((3, 10)) * (rng.random((3, 10)) < 0.4)
    bs = np.einsum("bnmf,bf->bnm", As, xs).astype(np.float32)
    kw = dict(kappa=4, gamma=5.0, rho_c=1.0, max_iter=100, tol=5e-3,
              zt_iters=20, projection="sort")
    got = fleet.fit_many_stacked(BiCADMM("squared", BiCADMMConfig(**kw)),
                                 torch.as_tensor(As), torch.as_tensor(bs),
                                 kappas=[3, 4, 5])
    want = jfleet.fit_many_stacked(JaxBiCADMM("squared", JaxConfig(**kw)),
                                   jnp.asarray(As), jnp.asarray(bs),
                                   kappas=jnp.asarray([3, 4, 5]))
    np.testing.assert_array_equal(got.support.numpy(),
                                  np.asarray(want.support))
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-3, atol=1e-3)
    assert np.max(np.abs(got.iters.numpy() - np.asarray(want.iters))) <= 2


# ------------------------------------------------------------ subsolver ----
@pytest.mark.parametrize("n,M", [(12, 4), (13, 4), (5, 8), (250, 4)])
def test_pad_features_matches_jax(n, M):
    A = np.random.default_rng(n).standard_normal((7, n)).astype(np.float32)
    got, nb = subsolver.pad_features(torch.as_tensor(A), M)
    want, jnb = jsub.pad_features(jnp.asarray(A), M)
    assert nb == jnb and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- loss maps ----
LOSSES = [("squared", 1), ("logistic", 1), ("hinge", 1),
          ("smoothed_hinge", 1), ("softmax", 3)]


@pytest.mark.parametrize("name,K", LOSSES)
def test_fleet_loss_maps_match_jax(name, K):
    rng = np.random.default_rng(9)
    Bf, m = 4, 17
    preds = rng.standard_normal((Bf, m) + ((K,) if K > 1 else ())).astype(
        np.float32)
    bs = (rng.integers(0, K, (Bf, m)).astype(np.int32) if K > 1 else
          np.sign(rng.standard_normal((Bf, m))).astype(np.float32))
    loss, jloss = losses.get_loss(name, K), jax_get_loss(name, K)
    tp, tb = torch.as_tensor(preds), torch.as_tensor(bs)
    got = loss.value_many(tp, tb)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jloss.value_many(
                                   jnp.asarray(preds), jnp.asarray(bs))),
                               rtol=1e-5, atol=1e-5)
    for i in range(Bf):    # each problem's sum is value's, bit for bit
        assert torch.equal(got[i], loss.value(tp[i], tb[i]))
    np.testing.assert_array_equal(
        loss.decision_many(tp).numpy(),
        np.asarray(jloss.decision_many(jnp.asarray(preds))))
    np.testing.assert_array_equal(
        loss.predict_many(tp).numpy(),
        np.asarray(jloss.predict_many(jnp.asarray(preds))))
    assert loss.predict_dim(11) == jloss.predict_dim(11) == 11 * K


def test_value_many_of_a_loss_without_the_many_keyword():
    plain = losses.Loss("plain", lambda p, b: torch.sum((p - b) ** 2),
                        losses.squared.grad, losses.squared.prox_omega)
    p, b = torch.randn(3, 5), torch.randn(3, 5)
    torch.testing.assert_close(plain.value_many(p, b),
                               ((p - b) ** 2).sum(1))


# --------------------------------------------------------------- results ----
def test_mark_aborted_matches_jax():
    codes = results.SolveStatus
    status = np.array([codes.MAX_ITER, codes.CONVERGED, codes.MAX_ITER,
                       codes.MAX_ITER, codes.DIVERGED], np.int32)
    iters = np.array([0, 4, 7, 300, 2], np.int32)
    caps = np.array([0, 9, 7, 500, 2], np.int32)
    got = results.mark_aborted(torch.as_tensor(status),
                               torch.as_tensor(iters), caps, 300)
    want = jresults.mark_aborted(jnp.asarray(status), jnp.asarray(iters),
                                 jnp.asarray(caps), 300)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [codes.ABORTED, codes.CONVERGED, codes.ABORTED,
                            codes.MAX_ITER, codes.DIVERGED]


# ------------------------------------------- the projections on lanes ----
@pytest.mark.parametrize("rounds", [0, 2])
@pytest.mark.parametrize("B,d", [(1, 1), (7, 16), (6, 64), (5, 300),
                                 (3, 1000)])
def test_lane_plain_versions_equal_the_solo_plain_version(B, d, rounds):
    """ref.l1_epigraph_proj_lanes_ref / skappa_support_lanes_ref: each
    row of a B-lane call bit for bit as the solo plain version (its
    one-lane call): the masked loops leave every lane its own fixpoint
    (ties, zeros, the inside and apex cases, kappa from 0 past the
    nonzeros)."""
    z = _lanes(B * 1000 + d, B, d)
    scale = z.abs().sum(1)
    t0 = torch.linspace(-0.2, 1.1, B) * scale
    t0[0] = -2.0 * float(z.abs().max()) - 1.0                  # the apex
    kap = torch.tensor([(3 * i) % (d + 3) for i in range(B)],
                       dtype=torch.int32)
    zl, tl, thl, kl = ref.l1_epigraph_proj_lanes_ref(z, t0, rounds=rounds,
                                                     stats=True)
    ul, sl, ksl = ref.skappa_support_lanes_ref(z, kap, rounds=rounds,
                                               stats=True)
    for i in range(B):
        zs, ts, ths, ks = ref.l1_epigraph_proj_ref(z[i], t0[i],
                                                   rounds=rounds, stats=True)
        assert torch.equal(zs, zl[i]) and torch.equal(ts, tl[i])
        assert torch.equal(ths, thl[i]) and ks == int(kl[i])
        us, ss, kss = ref.skappa_support_ref(z[i], int(kap[i]),
                                             rounds=rounds, stats=True)
        assert torch.equal(us, ul[i]) and torch.equal(ss, sl[i])
        assert kss == int(ksl[i])


@pytest.mark.parametrize("B,d", [(1, 5), (6, 16), (4, 333)])
def test_lane_cpu_path_equals_the_solo_cpu_path(B, d):
    """core.bilinear on (B, d) lanes on the CPU: each row as the solo
    composed path computes it, bit for bit; the sort oracles too."""
    z = _lanes(d, B, d)
    t0 = torch.linspace(-0.1, 0.9, B) * z.abs().sum(1)
    v = torch.linspace(-0.3, 0.3, B)
    kap = torch.tensor([1 + (2 * i) % d for i in range(B)],
                       dtype=torch.float32)
    zl, tl = tbl.project_l1_epigraph(z, t0)
    ul, sl = tbl.support_skappa_ladder(z, kap)
    s_new = tbl.s_update(z, t0, v, kap)
    g = tbl.g(z, s_new, t0)
    zs_, ts_ = tbl.project_l1_epigraph_sort(z, t0)
    us_, ss_ = tbl.support_skappa_sort(z, kap)
    ht = tbl.hard_threshold_lanes(z, kap)
    for i in range(B):
        zi, ti = tbl.project_l1_epigraph(z[i], t0[i])
        assert torch.equal(zi, zl[i]) and torch.equal(ti, tl[i])
        ui, si = tbl.support_skappa_ladder(z[i], float(kap[i]))
        assert torch.equal(ui, ul[i]) and torch.equal(si, sl[i])
        s_i = tbl.s_update(z[i], t0[i], v[i], float(kap[i]))
        assert torch.equal(s_i, s_new[i])
        assert torch.equal(tbl.g(z[i], s_i, t0[i]), g[i])
        zo, to = tbl.project_l1_epigraph_sort(z[i], t0[i])
        torch.testing.assert_close(zo, zs_[i], rtol=0, atol=1e-6)
        torch.testing.assert_close(to, ts_[i], rtol=0, atol=1e-6)
        uo, so = tbl.support_skappa_sort(z[i], float(kap[i]))
        assert torch.equal(so, ss_[i])
        assert torch.equal(tbl.hard_threshold(z[i], float(kap[i])), ht[i])


def test_lane_plan_follows_the_width():
    # a warp a lane up to d = 256 (the narrow layout), a CTA beyond
    for d in (1, 16, 64, 65, 100, 200):
        assert bisect_proj.lane_plan(d) == (1, 32)
    assert bisect_proj.LANE_WARP_MAX_N == 256
    assert bisect_proj.lane_plan(bisect_proj.LANE_WARP_MAX_N) == (1, 32)
    assert bisect_proj.lane_plan(bisect_proj.LANE_WARP_MAX_N + 1) == (
        1, bisect_proj.THREADS)
    for d in (999, 1_000, 2_500, 10_000, bisect_proj.MAX_N):
        p = bisect_proj.plan(d)
        lp = bisect_proj.lane_plan(d)
        assert lp.ctas == p.ctas
        assert lp.threads == bisect_proj.THREADS
    with pytest.raises(ValueError, match="one-launch"):
        bisect_proj.lane_plan(bisect_proj.MAX_N + 1)
    # the layouts the source's lane entry points take: a warp a lane on the
    # narrow kernels, a cluster of 1,024-thread CTAs on the solo body
    src = (bisect_proj.build.CSRC / "ladder_proj.cu").read_text()
    assert bisect_proj.LANE_THREADS == (32, bisect_proj.THREADS)
    assert ("threads == kThreads ||\n"
            "          (ctas == 1 && threads == 32 && n <= kLaneWarpMaxN)"
            in src)
    assert "constexpr int kLaneWarpMaxN = 256;" in src
    assert "launch_narrow(l1_warp_lanes_kernel<kF64>," in src
    assert "launch_narrow(skappa_warp_lanes_kernel," in src
    assert "l1_lanes_kernel<C, kThreads, kF64>" in src


def test_lane_kernels_have_a_cuda_and_a_cpu_row_and_no_default():
    table = runtime.kernel_table()
    for name in ("l1_epigraph_proj_lanes", "skappa_support_lanes"):
        assert sorted(table[name]) == ["cpu", "cuda"]
    assert table["l1_epigraph_proj_lanes"]["cpu"] is \
        ref.l1_epigraph_proj_lanes_ref
    with pytest.raises(ValueError):
        bisect_proj.l1_epigraph_proj_lanes(torch.zeros(2, 3, device="meta"),
                                           torch.zeros(2, device="meta"))


def test_normal_matvec_takes_a_shift_per_system():
    """A per-node (or per-node-and-entry) shift: the plain version is the
    composition, and the card wrapper routes it to the composed kernels."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 9, 6, generator=g)
    p = torch.randn(4, 6, generator=g)
    for shift in (torch.rand(4, 1, generator=g), torch.rand(4, 6,
                                                            generator=g)):
        want = ref.rmatvec_ref(a, ref.matvec_ref(a, p)) + shift * p
        torch.testing.assert_close(matvec.normal_matvec(a, p, shift), want)
        assert matvec.per_system_shift(shift)
    assert not matvec.per_system_shift(torch.rand(6))
    assert not matvec.per_system_shift(torch.tensor(2.0))
    assert not matvec.per_system_shift(2.0)


@pytest.mark.parametrize("name,K", LOSSES + [("hinge", 1)])
def test_grad_tangent_equals_the_forward_mode_product(name, K):
    """prox.grad_tangent (reverse mode over one recorded graph for the
    elementwise losses) gives torch.func.jvp's bits."""
    from repro_torch.core import prox
    g = torch.Generator().manual_seed(11)
    loss = losses.get_loss(name, K)
    shape = (3, 40)
    pred = torch.randn(*shape, *((K,) if K > 1 else ()), generator=g)
    b = (torch.randint(0, K, shape, generator=g) if K > 1
         else torch.sign(torch.randn(shape, generator=g)))
    dgrad = prox.grad_tangent(loss, pred, b)
    for _ in range(2):                  # the recorded graph serves again
        t = torch.randn(pred.shape, generator=g)
        want = torch.func.jvp(lambda pr: loss.grad(pr, b), (pred,), (t,))[1]
        assert torch.equal(dgrad(t), want)

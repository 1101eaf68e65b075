"""The port's fleet driver (repro_torch.core.fleet, api.fit_many, the lane
grid of core.path) against the JAX package's (repro.core.fleet,
repro.api.fit_many, repro.core.path.fit_grid), on the CPU, same numpy data.

The contracts of tests/test_fleet.py at its sizes (B = 5, N = 2, m = 30,
n = 12) and its config, with 20 FISTA steps an outer iteration on both
sides (as tests/test_torch_path.py runs its paths) to bound the CPU time:

* against JAX, per lane, tests/test_torch_path.py's bounds: the same
  status, support and cardinality, z within 1e-4, coef within 1e-3,
  iterations within 2, train loss within rtol 1e-3;
* within the port, each lane equals a solo ``BiCADMM`` fit of its problem
  in iteration count and support, iterates within test_fleet.py's fp
  round-off band (atol 5e-5).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.api as japi
from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import fit_grid as jax_fit_grid
from repro.core import fleet as jfleet
from repro_torch import api, convert
from repro_torch.core import (BiCADMM, BiCADMMConfig, SolveStatus, fit_grid,
                              fleet, prox)
from repro_torch.data import SyntheticSpec, make_sparse_regression

B, N, M, NFEAT = 5, 2, 30, 12
CFG = dict(kappa=5, gamma=5.0, rho_c=1.0, max_iter=600, tol=5e-3,
           zt_iters=20)
Z_TOL = dict(rtol=0.0, atol=5e-5)   # test_fleet.py's fp round-off band


def _fleet_data(seed=1, B=B, N=N, m=M, n=NFEAT):
    """tests/test_fleet.py's data, as numpy."""
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((B, N, m, n)).astype(np.float32)
    xs = rng.standard_normal((B, n)) * (rng.random((B, n)) < 0.4)
    bs = np.einsum("bnmf,bf->bnm", As, xs).astype(np.float32)
    bs += 0.01 * rng.standard_normal((B, N, m)).astype(np.float32)
    return As, bs


@functools.lru_cache(maxsize=None)
def _solvers(loss="squared", **over):
    kw = {**CFG, **over}
    return (BiCADMM(loss, BiCADMMConfig(**kw)),
            JaxBiCADMM(loss, JaxConfig(**kw)))


@functools.lru_cache(maxsize=None)
def _fits(which: str):
    """The fleets several tests read, each fitted once: the homogeneous
    fleet (port and JAX) and the heterogeneous one."""
    As, bs = _fleet_data()
    solver, jsolver = _solvers()
    kw = {}
    if which == "het":
        kw = dict(kappas=[3, 4, 5, 6, 7], gammas=[2.0, 5.0, 5.0, 10.0, 20.0],
                  rho_cs=[1.0, 1.0, 2.0, 1.0, 0.5])
    port = fleet.fit_many_stacked(solver, torch.as_tensor(As),
                                  torch.as_tensor(bs), **kw)
    jax_ = jfleet.fit_many_stacked(jsolver, jnp.asarray(As), jnp.asarray(bs),
                                   **{k: jnp.asarray(v) for k, v in
                                      kw.items()})
    return port, jax_, kw


def assert_lanes_match_jax(got, want, z_tol=1e-4):
    """Per lane: status, support and cardinality equal, z within z_tol,
    coef within 1e-3, iterations within 2, train loss within rtol 1e-3."""
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    np.testing.assert_array_equal(got.support.numpy(),
                                  np.asarray(want.support))
    np.testing.assert_array_equal(got.cardinality.numpy(),
                                  np.asarray(want.cardinality))
    if z_tol is not None:
        np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z),
                                   rtol=z_tol, atol=z_tol)
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-3, atol=1e-3)
    assert np.max(np.abs(got.iters.numpy().astype(np.int64)
                         - np.asarray(want.iters, np.int64))) <= 2
    if got.train_loss is not None and want.train_loss is not None:
        np.testing.assert_allclose(got.train_loss.numpy(),
                                   np.asarray(want.train_loss), rtol=1e-3,
                                   atol=1e-4)


def _assert_lane_is_solo(got, solo):
    assert int(got.iters) == int(solo.iters)
    assert torch.equal(got.support, solo.support)
    np.testing.assert_allclose(got.z.numpy(), solo.z.numpy(), **Z_TOL)
    np.testing.assert_allclose(got.coef.numpy(), solo.coef.numpy(), **Z_TOL)
    assert int(got.status) == int(solo.status)


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------
def test_fleet_matches_the_jax_fleet():
    port, jax_, _ = _fits("homog")
    assert port.strategy == jax_.strategy == "fleet-vmap"
    assert len(port) == B and port.x.shape == (B, NFEAT)
    assert_lanes_match_jax(port, jax_)
    for name in ("kappas", "gammas", "rho_cs"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_, name)))


def test_lanes_equal_solo_fits_of_the_port():
    """Each lane is a solo fit of its problem: the same iterations and
    support, the iterates within the fp round-off band."""
    port, _, _ = _fits("homog")
    As, bs = _fleet_data()
    solver, _ = _solvers()
    for i in range(B):
        _assert_lane_is_solo(port[i], solver.fit(torch.as_tensor(As[i]),
                                                 torch.as_tensor(bs[i])))


def test_lanes_converge_independently():
    port, _, _ = _fits("homog")
    iters = port.iters.numpy()
    assert len(set(iters.tolist())) > 1
    done = iters < CFG["max_iter"]
    assert done.any()
    for i in np.nonzero(done)[0]:
        assert float(port.p_r[i]) < CFG["tol"]
        assert float(port.d_r[i]) < CFG["tol"]
        assert float(port.b_r[i]) < CFG["tol"]
        assert int(port.status[i]) == int(SolveStatus.CONVERGED)


def test_heterogeneous_hyperparameters_match_jax_and_solo_overrides():
    """Per-problem kappa / gamma / rho_c (the spectral factors): each lane
    within the band of the JAX fleet's, and equal to a solo run_from with
    the same tensor overrides."""
    port, jax_, kw = _fits("het")
    assert_lanes_match_jax(port, jax_)
    np.testing.assert_array_equal(port.cardinality.numpy(), kw["kappas"])
    As, bs = _fleet_data()
    solver, _ = _solvers()
    for i in (3, 4):
        A, b = torch.as_tensor(As[i]), torch.as_tensor(bs[i])
        solo = solver.run_from(A, b, solver.init_state(A, b),
                               kappa=kw["kappas"][i],
                               gamma=torch.tensor(kw["gammas"][i]),
                               rho_c=torch.tensor(kw["rho_cs"][i]))
        _assert_lane_is_solo(port[i], solo)


def test_warm_refit_resumes_and_crosses_packages():
    """states= resumes every lane: a capped fleet resumed once matches the
    JAX fleet's resumed run, and a port fleet resumed from the JAX fleet's
    state matches it too."""
    As, bs = _fleet_data()
    solver, jsolver = _solvers(max_iter=40)
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    jA, jb = jnp.asarray(As), jnp.asarray(bs)
    first = fleet.fit_many_stacked(solver, A, b)
    assert int(first.iters.max()) == 40
    second = fleet.fit_many_stacked(solver, A, b, states=first.state)
    jfirst = jfleet.fit_many_stacked(jsolver, jA, jb)
    # the JAX fleet donates the state it resumes from: read it first
    jstate = {k: np.asarray(v) for k, v in jfirst.state._asdict().items()
              if k != "inner"}
    jsecond = jfleet.fit_many_stacked(jsolver, jA, jb, states=jfirst.state)
    assert_lanes_match_jax(second, jsecond)
    from_jax = fleet.fit_many_stacked(
        solver, A, b, states=convert.fleet_state_from_numpy(jstate, "cpu"))
    assert_lanes_match_jax(from_jax, jsecond)
    # the first fleet's state was not consumed: a second resume is the same
    again = fleet.fit_many_stacked(solver, A, b, states=first.state)
    assert torch.equal(again.z, second.z)
    solo = solver.run_from(A[1], b[1], solver.fit(A[1], b[1]).state)
    _assert_lane_is_solo(second[1], solo)


def test_fleet_result_lane_view_and_state_conversions():
    port, _, _ = _fits("homog")
    As, bs = _fleet_data()
    solver, _ = _solvers()
    one = port[2]
    assert one.coef.shape == (NFEAT, 1) and one.z.shape == (NFEAT,)
    assert one.state.x.shape == (N, NFEAT) and one.state.k.shape == ()
    A, b = torch.as_tensor(As[2]), torch.as_tensor(bs[2])
    resumed = solver.run_from(A, b, one.state)
    assert torch.equal(resumed.support, port.support[2])
    stacked = fleet.stack_states([port[i].state for i in range(B)])
    for got, want in zip(stacked, port.state):
        assert (got is None and want is None) or torch.equal(got, want)
    cold = fleet.zero_lane_state(solver, N, NFEAT)
    assert float(cold.p_r) == float("inf") and int(cold.k) == 0
    out = convert.fleet_to_numpy(port)
    assert out["strategy"] == "fleet-vmap" and out["state"]["x"].shape == (
        B, N, NFEAT)
    back = convert.fleet_state_from_numpy(out["state"], "cpu")
    assert torch.equal(back.z, port.state.z)


def test_iter_caps_abort_lanes_and_cap_zero_is_inert():
    As, bs = _fleet_data()
    solver, jsolver = _solvers()
    caps = [0, 5, 40, 3, 0]
    got = api.fit_many(api.SparseProblem("squared", kappa=CFG["kappa"],
                                         gamma=CFG["gamma"]),
                       As, bs, iter_caps=caps,
                       options=api.SolverOptions(device="cpu", max_iter=600,
                                                 tol=CFG["tol"],
                                                 zt_iters=20))
    want = jfleet.fit_many_stacked(jsolver, jnp.asarray(As), jnp.asarray(bs),
                                   iter_caps=jnp.asarray(caps))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    aborted = int(SolveStatus.ABORTED)
    assert got.status.tolist()[:2] == [aborted, aborted]
    assert got.iters.tolist()[0] == got.iters.tolist()[4] == 0
    assert got.iters.tolist()[1:4] == [5, 40, 3]
    assert torch.equal(got.z[0], torch.zeros(NFEAT))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


# --------------------------------------------------------------------------
# bucketing / padding
# --------------------------------------------------------------------------
def test_zero_row_padding_is_exact():
    As, bs = _fleet_data(seed=3, B=1, m=24)
    solver, _ = _solvers()
    A, b = torch.as_tensor(As[0]), torch.as_tensor(bs[0])
    Ap = torch.nn.functional.pad(A, (0, 0, 0, 8))
    bp = torch.nn.functional.pad(b, (0, 8))
    r0, r1 = solver.fit(A, b), solver.fit(Ap, bp)
    assert int(r0.iters) == int(r1.iters)
    assert torch.equal(r0.support, r1.support)
    np.testing.assert_allclose(r0.z.numpy(), r1.z.numpy(), **Z_TOL)


def _lists_match_jax(results, jresults):
    for res, jres in zip(results, jresults, strict=True):
        assert int(res.status) == int(jres.status)
        np.testing.assert_array_equal(res.support.numpy(),
                                      np.asarray(jres.support))
        np.testing.assert_allclose(res.coef.numpy(), np.asarray(jres.coef),
                                   rtol=1e-3, atol=1e-3)
        assert abs(int(res.iters) - int(jres.iters)) <= 2


def test_bucketing_round_trip():
    """Two m's of one n: one signature, scattered back in caller order,
    each within the JAX fleet's band and equal to its solo port fit."""
    ms = [20, 28, 20, 24, 28]
    problems = []
    for i, m in enumerate(ms):
        As, bs = _fleet_data(seed=10 + i, B=1, m=m)
        problems.append((As[0], bs[0]))
    buckets = fleet.bucket_problems(problems)
    assert len(buckets) == 1
    assert buckets[0].signature == (N, 28, NFEAT)
    assert buckets[0].m_orig == tuple(ms)
    assert buckets[0].indices == tuple(range(5))
    solver, jsolver = _solvers()
    seen = []
    results = fleet.fit_many(solver, problems, on_bucket=seen.append)
    assert [b.signature for b in seen] == [(N, 28, NFEAT)]
    _lists_match_jax(results, jfleet.fit_many(jsolver, problems))
    for res, (A, b) in zip(results[:2], problems[:2]):
        solo = solver.fit(torch.as_tensor(A), torch.as_tensor(b))
        assert int(res.iters) == int(solo.iters)
        assert torch.equal(res.support, solo.support)


def test_bucketing_multiple_signatures():
    p1 = _fleet_data(seed=20, B=1, n=12)
    p2 = _fleet_data(seed=21, B=1, n=8)
    p3 = _fleet_data(seed=22, B=1, n=12)
    problems = [(p[0][0], p[1][0]) for p in (p1, p2, p3)]
    assert len(fleet.bucket_problems(problems)) == 2
    solver, jsolver = _solvers()
    results = fleet.fit_many(solver, problems, kappas=[5, 4, 6])
    assert [r.z.shape[0] for r in results] == [12, 8, 12]
    _lists_match_jax(results, jfleet.fit_many(jsolver, problems,
                                              kappas=[5, 4, 6]))


def test_corrected_train_losses():
    """A loss with l(0, 0) != 0 (logistic): the correction removes
    N * pad * log 2 from the padded member, as the JAX fleet's does, and
    equals the true loss of the returned coefficients on the unpadded
    data. (Random labels: the fit runs its 40 iterations; the JAX
    comparison of a logistic fleet is test_logistic_fleet_matches_jax.)"""
    rng = np.random.default_rng(5)
    kw = dict(kappa=4, gamma=5.0, rho_c=1.0, max_iter=40, tol=1e-3,
              zt_iters=20)
    solver = BiCADMM("logistic", BiCADMMConfig(**kw))
    jsolver = JaxBiCADMM("logistic", JaxConfig(**kw))
    m1, m2, n = 20, 30, 10
    X1 = rng.standard_normal((N, m1, n)).astype(np.float32)
    X2 = rng.standard_normal((N, m2, n)).astype(np.float32)
    y1 = np.sign(rng.standard_normal((N, m1))).astype(np.float32)
    y2 = np.sign(rng.standard_normal((N, m2))).astype(np.float32)
    problems = [(X1, y1), (X2, y2)]
    [bucket] = fleet.bucket_problems(problems)
    [jbucket] = jfleet.bucket_problems(problems)
    assert bucket.signature == jbucket.signature
    assert bucket.m_orig == jbucket.m_orig
    np.testing.assert_array_equal(bucket.As.numpy(), np.asarray(jbucket.As))
    got = fleet.fit_many_stacked(solver, bucket.As, bucket.bs)
    raw = got.train_loss.numpy()
    corrected = fleet.corrected_train_losses(solver, got, bucket).numpy()
    pads = np.asarray([bucket.signature[1] - m for m in bucket.m_orig])
    np.testing.assert_allclose(raw - corrected, N * pads * np.log(2.0),
                               rtol=1e-5)
    np.testing.assert_allclose(fleet._pad_loss_unit(solver),
                               jfleet._pad_loss_unit(jsolver), rtol=1e-7)
    for j, (X, y) in enumerate(problems):
        pred = torch.as_tensor(X.reshape(-1, n)) @ got.coef[j]
        true = float(solver.loss.value(pred[:, 0],
                                       torch.as_tensor(y.reshape(-1))))
        np.testing.assert_allclose(corrected[j], true, rtol=1e-4)


# --------------------------------------------------------------------------
# the api front-end / capability negotiation
# --------------------------------------------------------------------------
def _problem(**kw):
    return dict(loss="squared", kappa=CFG["kappa"], gamma=CFG["gamma"],
                rho_c=CFG["rho_c"], **kw)


def test_api_fit_many_stacked_3d_and_sequence_inputs():
    """The api on the fleet's two quickest problems (lanes 0 and 3): the
    stacked input as the core driver and the JAX api, the (B, m, n) input,
    and a sequence input lane for lane as the stacked one."""
    As, bs = _fleet_data()
    As, bs = As[[0, 3]], bs[[0, 3]]
    opts = dict(max_iter=CFG["max_iter"], tol=CFG["tol"], zt_iters=20)
    res = api.fit_many(api.SparseProblem(**_problem()), As, bs,
                       options=api.SolverOptions(device="cpu", **opts))
    assert isinstance(res, api.FleetResult)
    core, _, _ = _fits("homog")
    for name in ("z", "coef", "iters", "support", "status"):
        assert torch.equal(getattr(res, name), getattr(core, name)[[0, 3]])
    want = japi.fit_many(japi.SparseProblem(**_problem()), jnp.asarray(As),
                         jnp.asarray(bs), options=japi.SolverOptions(**opts))
    assert_lanes_match_jax(res, want)
    # (B, m, n) input grows the N = 1 node axis
    flat = api.fit_many(api.SparseProblem(**_problem()),
                        As.reshape(2, N * M, NFEAT), bs.reshape(2, N * M),
                        options=api.SolverOptions(device="cpu", max_iter=100,
                                                  tol=1e-3, zt_iters=20))
    assert flat.coef.shape == (2, NFEAT, 1)
    assert flat.state.x.shape == (2, 1, NFEAT)
    # a sequence of problems: a list of FitResult, lane for lane the
    # stacked fleet's
    seq = api.fit_many(api.SparseProblem(**_problem()), list(As), list(bs),
                       options=api.SolverOptions(device="cpu", **opts))
    assert len(seq) == 2
    for i, r in enumerate(seq):
        assert int(r.iters) == int(res.iters[i])
        assert torch.equal(r.support, res.support[i])
    with pytest.raises(ValueError, match="stacked"):
        api.fit_many(api.SparseProblem(**_problem()), list(As), list(bs),
                     iter_caps=[1, 1],
                     options=api.SolverOptions(device="cpu", **opts))


def test_fleet_capability_negotiation(tmp_path):
    As, bs = _fleet_data()
    caps = api.engine_capabilities("reference", api.SolverOptions())
    jcaps = japi.engine_capabilities("reference", japi.SolverOptions())
    assert caps.fleet and jcaps.fleet
    fs = dict(n_feature_blocks=3, force_feature_split=True)
    assert not api.engine_capabilities("reference",
                                       api.SolverOptions(**fs)).fleet
    assert not japi.engine_capabilities("reference",
                                        japi.SolverOptions(**fs)).fleet
    prob = api.SparseProblem("squared", kappa=3)
    with pytest.raises((api.CapabilityError, ValueError)):
        api.fit_many(prob, As, bs,
                     options=api.SolverOptions(device="cpu", **fs))
    # the sharded engine's own refusal (JAX _ShardedAdapter.fit_many)
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("nodes", "feat"))
    assert not api.engine_capabilities("sharded").fleet
    with pytest.raises(api.CapabilityError, match="fleet"):
        api.fit_many(prob, As, bs,
                     options=api.SolverOptions(device="cpu", mesh=mesh,
                                               engine="sharded"))
    solver, _ = _solvers(force_feature_split=True, n_feature_blocks=2)
    with pytest.raises(ValueError, match="feature-split"):
        fleet.fit_many_stacked(solver, torch.as_tensor(As),
                               torch.as_tensor(bs))
    with pytest.raises(api.CapabilityError):
        fleet.fit_many_stacked(_solvers()[0], torch.as_tensor(As).double(),
                               torch.as_tensor(bs).double())


@pytest.mark.parametrize("x_solver", ["woodbury", "pcg"])
def test_heterogeneous_penalties_through_the_dual_and_pcg_factors(x_solver):
    """Per-lane penalties through the spectral Woodbury solve (its
    refinement's per-lane shift) and PCG, against the JAX fleet."""
    rng = np.random.default_rng(4)
    Bh, Nh, mh, nh = 3, 2, 10, 24          # m < n: the dual factors
    As = rng.standard_normal((Bh, Nh, mh, nh)).astype(np.float32)
    xs = rng.standard_normal((Bh, nh)) * (rng.random((Bh, nh)) < 0.3)
    bs = np.einsum("bnmf,bf->bnm", As, xs).astype(np.float32)
    kw = dict(kappas=[4, 5, 6], gammas=[2.0, 5.0, 10.0],
              rho_cs=[1.0, 2.0, 0.5])
    solver, jsolver = _solvers(x_solver=x_solver, max_iter=200, tol=1e-3)
    got = fleet.fit_many_stacked(solver, torch.as_tensor(As),
                                 torch.as_tensor(bs), **kw)
    want = jfleet.fit_many_stacked(jsolver, jnp.asarray(As), jnp.asarray(bs),
                                   **{k: jnp.asarray(v)
                                      for k, v in kw.items()})
    assert_lanes_match_jax(got, want, z_tol=1e-3)


def test_logistic_fleet_matches_jax():
    """The loss of examples/lm_sparse_probe.py through Newton-CG on the
    nodes of every lane, with per-lane kappa."""
    rng = np.random.default_rng(6)
    As = rng.standard_normal((4, 1, 40, 10)).astype(np.float32)
    xs = rng.standard_normal((4, 10)) * (rng.random((4, 10)) < 0.5)
    bs = np.sign(np.einsum("bnmf,bf->bnm", As, xs) + 1e-3).astype(
        np.float32)
    kw = dict(kappa=4, gamma=1000.0, rho_c=1.0, max_iter=60, tol=1e-3,
              zt_iters=20)
    got = fleet.fit_many_stacked(BiCADMM("logistic", BiCADMMConfig(**kw)),
                                 torch.as_tensor(As), torch.as_tensor(bs),
                                 kappas=[4, 3, 5, 4])
    want = jfleet.fit_many_stacked(JaxBiCADMM("logistic", JaxConfig(**kw)),
                                   jnp.asarray(As), jnp.asarray(bs),
                                   kappas=jnp.asarray([4, 3, 5, 4]))
    assert_lanes_match_jax(got, want, z_tol=None)


# --------------------------------------------------------------------------
# the grid on lanes
# --------------------------------------------------------------------------
GRID_SPEC = SyntheticSpec(2, 40, 60, sparsity_level=0.75, noise=1e-3)
GRID_KW = dict(kappa=GRID_SPEC.kappa, gamma=10.0, rho_c=1.0, alpha=0.5,
               max_iter=300, tol=1e-4, zt_iters=20)


@pytest.mark.parametrize("penalties", [False, True])
@pytest.mark.parametrize("x_solver", ["dense", "woodbury", "pcg"])
def test_grid_on_lanes_matches_the_jax_grid(x_solver, penalties):
    As, bs, _ = make_sparse_regression(1, GRID_SPEC)
    pen = (dict(gammas=[20.0, 10.0, 5.0], rho_cs=[1.0, 1.0, 2.0])
           if penalties else {})
    kw = dict(GRID_KW, x_solver=x_solver)
    got = fit_grid(BiCADMM("squared", BiCADMMConfig(**kw)),
                   torch.as_tensor(As), torch.as_tensor(bs), [16, 12, 8],
                   **pen)
    want = jax_fit_grid(JaxBiCADMM("squared", JaxConfig(**kw)),
                        jnp.asarray(As), jnp.asarray(bs), [16, 12, 8], **pen)
    assert got.strategy == want.strategy == "vmap"
    assert_lanes_match_jax(got, want)


def test_grid_columns_solve_each_point_as_its_own_system():
    """prox.x_solve_columns: column p of a shared-factor solve is the solo
    x_solve at point p's penalties, for every factor type."""
    As, bs, _ = make_sparse_regression(1, GRID_SPEC)
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    Q = torch.randn(2, 60, 3, generator=torch.Generator().manual_seed(0))
    rho = torch.tensor([1.0, 2.0, 0.5])
    sig = torch.tensor([0.05, 0.025, 0.1])
    for eng in (prox.NodeProxEngine("dense", True),
                prox.NodeProxEngine("woodbury", True),
                prox.NodeProxEngine("pcg", True)):
        f = eng.setup(A, b, 0.05, 1.0)
        got = prox.x_solve_columns(f, Q, rho, sig)
        for p in range(3):
            want = prox.x_solve(f, Q[..., p], float(rho[p]), float(sig[p]))
            torch.testing.assert_close(got[..., p], want, rtol=1e-4,
                                       atol=1e-5)

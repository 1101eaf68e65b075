"""The port's sharded engine (repro_torch.core.sharded) against the JAX
package's ``ShardedBiCADMM``, in this process, on the CPU: a world-size-1
gloo group and a (1, 1) DeviceMesh on the port's side, a (1, 1) mesh of
explicitly Auto axes on the JAX side (``jax.make_mesh``'s default axis
types under JAX 0.9 are explicit, which ``shard_map`` refuses), the same
numpy data.

* Every projection mode, both x-updates, the squared, logistic and 3-class
  softmax losses, bf16 through the api and fp16 through the engine, a warm
  start from a converted JAX state and the kappa path warm and cold: the
  same iterations and support, z within 2e-4 (``tests/test_sharded.py``'s
  bound; 5e-3 for the logistic fit, as there), the softmax fit and the
  reduced presets after the same fixed number of outer iterations.
* The port's own reference: on one rank the sharded engine's exact modes
  are ``BiCADMM(force_feature_split=True, polish=False)`` bit for bit, its
  cg x-update ``BiCADMM(x_solver="pcg", polish=False)``.
* The half-width block products (their plain versions, the CPU rows)
  against the JAX package's CPU rows on the same bf16 / fp16 blocks:
  rtol / atol 1e-5.
* The api: up-front capability errors (overrides, penalty grids, fleets,
  streams, fp16 data), the estimator against the raw engine bit for bit,
  and the fault the engine detects.

The multi-rank grids run in tests/test_torch_sharded_grid.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AxisType
from torch.distributed.device_mesh import init_device_mesh

import repro.api as japi
from repro.core import BiCADMMConfig as JaxConfig
from repro.core.sharded import ShardedBiCADMM as JaxSharded
from repro.kernels import ops as jops
from repro_torch import api, convert, faults
from repro_torch.core import BiCADMM, BiCADMMConfig
from repro_torch.core.results import SolveStatus
from repro_torch.core.sharded import ShardedBiCADMM
from repro_torch.data import (SyntheticSpec, make_sparse_classification,
                              make_sparse_regression, make_sparse_softmax)
from repro_torch.kernels import ops

SPEC = SyntheticSpec(1, 80, 40, sparsity_level=0.75, noise=1e-3)
KW = dict(kappa=SPEC.kappa, gamma=10.0, rho_c=1.0, alpha=0.5, max_iter=150,
          tol=1e-4, inner_iters=10, zt_iters=20)
CG_KW = dict(KW, gamma=0.5, cg_iters=120, cg_tol=1e-7)
Z_TOL = 2e-4


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(the port's (1, 1) DeviceMesh on a world-size-1 gloo group, the JAX
    (1, 1) mesh)."""
    if not dist.is_initialized():
        store = tmp_path_factory.mktemp("gloo") / "store"
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("nodes", "feat"))
    jmesh = jax.make_mesh((1, 1), ("nodes", "feat"),
                          axis_types=(AxisType.Auto,) * 2)
    return mesh, jmesh


def _regression():
    As, bs, _ = make_sparse_regression(11, SPEC)
    return As.reshape(-1, 40), bs.reshape(-1)


def _pair(meshes, loss, kw, n_classes=1, **engine):
    mesh, jmesh = meshes
    port = ShardedBiCADMM(loss, BiCADMMConfig(**kw), mesh,
                          n_classes=n_classes, device="cpu", **engine)
    jax_ = JaxSharded(loss, JaxConfig(**kw), jmesh, n_classes=n_classes,
                      **engine)
    return port, jax_


def _assert_same(port, want, z_tol=Z_TOL):
    assert int(port.iters) == int(want.iters)
    assert int(port.status) == int(want.status)
    np.testing.assert_array_equal(port.support.numpy(),
                                  np.asarray(want.support))
    np.testing.assert_allclose(port.z.numpy(), np.asarray(want.z), rtol=0,
                               atol=z_tol)


def _fit_both(port, jax_, A, b, **kw):
    return (port.fit(torch.as_tensor(A), torch.as_tensor(b), **kw),
            jax_.fit(jnp.asarray(A), jnp.asarray(b)))


CASES = {
    "ladder_exact": ("squared", KW, dict(projection="ladder_exact")),
    "exact": ("squared", KW, dict(projection="exact")),
    "batched": ("squared", KW, dict(projection="batched")),
    "bisect": ("squared", dict(KW, zt_iters=10),
               dict(projection="bisect")),
    "cg": ("squared", CG_KW, dict(x_update="cg")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_squared_fit_matches_jax_sharded(meshes, case):
    loss, kw, engine = CASES[case]
    A, b = _regression()
    port, want = _fit_both(*_pair(meshes, loss, kw, **engine), A, b)
    _assert_same(port, want)
    assert port.coef.shape == (40, 1) and port.state.x.shape == (1, 40, 1)


@pytest.mark.parametrize("projection", ["ladder_exact", "exact"])
def test_one_rank_is_the_feature_split_bit_for_bit(meshes, projection):
    """Both exact modes on one rank take the reference engine's sums in
    its order: BiCADMM's feature split with M = 1, bit for bit."""
    A, b = _regression()
    ref = BiCADMM("squared", BiCADMMConfig(
        **KW, force_feature_split=True, polish=False)).fit(
        torch.as_tensor(A)[None], torch.as_tensor(b)[None])
    port = ShardedBiCADMM("squared", BiCADMMConfig(**KW), meshes[0],
                          projection=projection, device="cpu").fit(
        torch.as_tensor(A), torch.as_tensor(b))
    assert int(port.iters) == int(ref.iters)
    assert torch.equal(port.z, ref.z)
    assert torch.equal(port.support, ref.support)


def test_one_rank_cg_is_the_pcg_x_update(meshes):
    A, b = _regression()
    ref = BiCADMM("squared", BiCADMMConfig(
        **CG_KW, x_solver="pcg", polish=False)).fit(
        torch.as_tensor(A)[None], torch.as_tensor(b)[None])
    port = ShardedBiCADMM("squared", BiCADMMConfig(**CG_KW), meshes[0],
                          x_update="cg", device="cpu").fit(
        torch.as_tensor(A), torch.as_tensor(b))
    assert int(port.iters) == int(ref.iters)
    np.testing.assert_allclose(port.z.numpy(), ref.z.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(port.support, ref.support)


def test_classifiers_match_jax_sharded(meshes):
    spec = SyntheticSpec(1, 120, 40, sparsity_level=0.75, noise=0.0)
    As, bs, _ = make_sparse_classification(3, spec)
    kw = dict(kappa=spec.kappa, gamma=50.0, rho_c=0.5, alpha=0.5,
              max_iter=150, tol=3e-4, inner_iters=10, zt_iters=20)
    port, want = _fit_both(*_pair(meshes, "logistic", kw),
                           As.reshape(-1, 40), bs.reshape(-1))
    _assert_same(port, want, z_tol=5e-3)
    # 3-class softmax after a fixed 12 outer iterations
    spec3 = SyntheticSpec(1, 90, 30, sparsity_level=0.75, n_classes=3)
    As3, bs3, _ = make_sparse_softmax(5, spec3)
    kw3 = dict(kappa=spec3.kappa * 3, gamma=10.0, rho_c=1.0, alpha=0.5,
               max_iter=12, tol=0.0, inner_iters=10, zt_iters=20)
    port, want = _fit_both(*_pair(meshes, "softmax", kw3, n_classes=3),
                           As3.reshape(-1, 30),
                           bs3.reshape(-1).astype(np.float32))
    _assert_same(port, want)
    assert port.coef.shape == (30, 3)


def test_warm_start_from_a_converted_jax_state(meshes):
    A, b = _regression()
    port, jsolver = _pair(meshes, "squared", KW)
    first = JaxSharded("squared", JaxConfig(**dict(KW, max_iter=6)),
                       meshes[1]).fit(jnp.asarray(A), jnp.asarray(b))
    st = convert.sharded_state_from_numpy(first.state, "cpu")
    got = port.fit(torch.as_tensor(A), torch.as_tensor(b), state=st)
    want = jsolver.fit(jnp.asarray(A), jnp.asarray(b), state=first.state)
    _assert_same(got, want)
    back = convert.sharded_state_to_numpy(got.state)
    for name, arr in back.items():
        np.testing.assert_allclose(arr, np.asarray(getattr(want.state,
                                                           name)),
                                   rtol=0, atol=Z_TOL, err_msg=name)
    assert convert.result_to_numpy(got)["state"].keys() == back.keys()


def test_setup_cache_reused_across_fits(meshes):
    """A warm refit on the same data, and a fit through the api's reshaped
    view of it, find the rank's block and factor in the set-up cache
    (``tests/test_xsolver.py``'s sharded case)."""
    A, b = (torch.as_tensor(x) for x in _regression())
    eng = ShardedBiCADMM("squared", BiCADMMConfig(**dict(KW, max_iter=8)),
                         meshes[0], device="cpu")
    r1 = eng.fit(A, b)
    assert len(eng._cache) == 1
    fac = next(iter(eng._cache.values()))[2][2]
    r2 = eng.fit(A.reshape(1, 80, 40).reshape(80, 40), b, state=r1.state)
    assert len(eng._cache) == 1
    assert next(iter(eng._cache.values()))[2][2] is fac
    assert int(r2.iters) <= 8


@pytest.mark.parametrize("warm", [True, False])
def test_kappa_path_matches_jax_sharded(meshes, warm):
    A, b = _regression()
    port, jsolver = _pair(meshes, "squared", dict(KW, max_iter=40))
    kappas = [10, 6, 3]
    got = port.fit_path(torch.as_tensor(A), torch.as_tensor(b), kappas,
                        warm_start=warm)
    want = jsolver.fit_path(jnp.asarray(A), jnp.asarray(b), kappas,
                            warm_start=warm)
    assert got.strategy == want.strategy
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.support.numpy(),
                                  np.asarray(want.support))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), rtol=0,
                               atol=Z_TOL)
    np.testing.assert_array_equal(got.cardinality.numpy(),
                                  np.asarray(want.cardinality))


def test_bf16_through_the_api_matches_jax(meshes):
    """precision="bf16" through the estimator on both sides: the data cast
    to bf16, the sub-solver's factors in f32, 15 outer iterations."""
    mesh, jmesh = meshes
    As, bs, _ = make_sparse_regression(11, SPEC)
    kw = dict(max_iter=15, tol=0.0, inner_iters=10, zt_iters=20,
              precision="bf16")
    est = api.SparseLinearRegression(
        SPEC.kappa, gamma=10.0, options=api.SolverOptions(
            engine="sharded", mesh=mesh, device="cpu", **kw)).fit(As, bs)
    jest = japi.SparseLinearRegression(
        SPEC.kappa, gamma=10.0, options=japi.SolverOptions(
            engine="sharded", mesh=jmesh, **kw)).fit(jnp.asarray(As),
                                                     jnp.asarray(bs))
    assert est.engine_ == "sharded" and jest.engine_ == "sharded"
    assert est.capabilities_.precisions == ("float32", "bfloat16")
    _assert_same(est.result_, jest.result_)


def test_fp16_through_the_engine_matches_jax(meshes):
    A, b = _regression()
    kw = dict(KW, max_iter=15, tol=0.0, precision="fp16")
    port, want = _fit_both(*_pair(meshes, "squared", kw), A, b)
    _assert_same(port, want)
    assert port.z.dtype == torch.float32


@pytest.mark.parametrize("dt", ["bfloat16", "float16"])
def test_half_width_block_products_match_jax(dt):
    """The plain versions on half-width A (f32 blocks and sums) against the
    JAX package's CPU rows of the same bf16 / fp16 blocks."""
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.standard_normal((1, 50, 24)),
                        dtype=torch.float32).to(getattr(torch, dt))
    x = rng.standard_normal((1, 1, 24, 3)).astype(np.float32)
    y = rng.standard_normal((1, 1, 50, 3)).astype(np.float32)
    ja = jnp.asarray(a.float().numpy()).astype(getattr(jnp, dt))
    got = ops.block_matvec_auto(a, torch.as_tensor(x), 1)
    got_t = ops.block_rmatvec_auto(a, torch.as_tensor(y), 1)
    assert got.dtype == got_t.dtype == torch.float32
    want = jops.block_matvec(ja, jnp.asarray(x[0]))
    want_t = jops.block_rmatvec(ja, jnp.asarray(y[0]))
    assert want.dtype == want_t.dtype == jnp.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_t[0].numpy(), np.asarray(want_t),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ api --
def _sharded_options(mesh, **kw):
    return api.SolverOptions(engine="sharded", mesh=mesh, device="cpu", **kw)


def test_capability_errors_are_up_front(meshes):
    mesh = meshes[0]
    As, bs, _ = make_sparse_regression(11, SPEC)
    opts = _sharded_options(mesh, max_iter=20, zt_iters=20)
    est = api.SparseLinearRegression(SPEC.kappa, gamma=10.0, options=opts)
    with pytest.raises(api.CapabilityError, match="kappa-only"):
        est.fit_path(As, bs, [10, 6], gammas=[10.0, 1.0])
    adapter = api.make_adapter(est.problem, est.options)
    assert adapter.name == "sharded"
    with pytest.raises(api.CapabilityError, match="per-solve"):
        adapter.fit(torch.as_tensor(As), torch.as_tensor(bs), kappa=5)
    prob = api.SparseProblem("squared", kappa=3)
    with pytest.raises(api.CapabilityError):
        api.fit_many(prob, As, bs, options=opts)
    with pytest.raises(api.CapabilityError, match="cannot stream"):
        api.stream(prob, options=opts)
    with pytest.raises(api.CapabilityError, match="float16"):
        api.SparseLinearRegression(3, options=_sharded_options(
            mesh, precision="fp16"))
    caps = api.engine_capabilities("sharded", opts)
    jcaps = japi.engine_capabilities("sharded", japi.SolverOptions())
    for field in ("distributed", "dynamic_penalties", "per_solve_overrides",
                  "penalty_grids", "grid_strategy", "gather_free", "fleet",
                  "stream", "precisions"):
        assert getattr(caps, field) == getattr(jcaps, field), field
    assert not api.engine_capabilities(
        "sharded", _sharded_options(mesh, sharded_projection="exact")
    ).gather_free
    for bad in (dict(engine="sharded"), dict(engine="reference", mesh=mesh),
                dict(mesh=mesh, x_update="lobpcg"),
                dict(mesh=mesh, sharded_projection="sort"),
                dict(mesh=mesh, nodes_axis="rows")):
        with pytest.raises(ValueError):
            api.SolverOptions(device="cpu", **bad)
    with pytest.raises(ValueError):
        ShardedBiCADMM("logistic", BiCADMMConfig(kappa=4), mesh,
                       x_update="cg", device="cpu")


def test_estimator_matches_raw_engine_bit_for_bit(meshes):
    mesh = meshes[0]
    As, bs, _ = make_sparse_regression(11, SPEC)
    opts = _sharded_options(mesh, max_iter=150, tol=1e-4, zt_iters=20,
                            inner_iters=10)
    est = api.SparseLinearRegression(SPEC.kappa, gamma=10.0,
                                     options=opts).fit(As, bs)
    raw = ShardedBiCADMM("squared", BiCADMMConfig(
        kappa=SPEC.kappa, gamma=10.0, max_iter=150, tol=1e-4, zt_iters=20,
        inner_iters=10), mesh, device="cpu").fit(
        torch.as_tensor(As).reshape(-1, 40), torch.as_tensor(bs).reshape(-1))
    assert est.engine_ == "sharded"
    assert int(est.result_.iters) == int(raw.iters)
    for field in ("x", "z", "support"):
        assert torch.equal(getattr(est.result_, field), getattr(raw, field))
    grid = est.fit_grid(As, bs, [10, 6])
    assert grid.strategy == "cold-scan" and est.engine_ == "sharded"
    # a one-rank mesh under engine="auto" takes the reference engine
    auto = api.SparseLinearRegression(SPEC.kappa, gamma=10.0, device="cpu",
                                      mesh=mesh, max_iter=5, zt_iters=20)
    assert auto.fit(As, bs).engine_ == "reference"
    assert api.select_engine(api.SolverOptions(mesh=mesh)) == "reference"
    assert api.select_engine(api.SolverOptions()) == "reference"


def test_sharded_engine_detects_the_same_fault(meshes):
    spec = SyntheticSpec(1, 60, 40, sparsity_level=0.75, noise=1e-3)
    As, bs, _ = make_sparse_regression(0, spec)
    prob = api.SparseProblem("squared", kappa=spec.kappa, gamma=10.0)
    opts = _sharded_options(meshes[0], max_iter=300, tol=1e-3, zt_iters=20,
                            inner_iters=10)
    assert int(api.solve(prob, As, bs, options=opts).status) == int(
        SolveStatus.CONVERGED)
    with faults.inject(faults.nan_x(3)) as inj:
        res = api.solve(prob, As, bs, options=opts)
    assert len(inj.hooked) == 1
    assert int(res.status) == int(SolveStatus.DIVERGED)
    assert int(res.iters) < 10

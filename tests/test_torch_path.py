"""The port's hyperparameter path (repro_torch.core.path, the api's sweeps,
``run_from`` overrides, ``fit_with_history``) against the JAX package's
(repro.core.path, repro.api), on the CPU, same numpy data.

Per grid point the bounds of tests/test_torch_bicadmm.py: the same
SolveStatus and support, ``coef`` within 1e-3, iteration counts within 2
(``z`` within 1e-4 where the losses are smooth enough to hold it).
Residual traces within rtol 1e-4 (atol 1e-5 per unit of the iterates'
norm, since they are norms of differences); ``kappa_ladder``'s integers
exactly. The squared-loss cases share one shape and one JAX solver per
x-update backend, so each JAX scan compiles once per grid kind; the
classifier paths are cut to 60 iterations a point to bound the CPU time.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import fit_path as jax_fit_path
from repro.core import kappa_ladder as jax_kappa_ladder
from repro_torch import api, convert
from repro_torch.core import (BiCADMM, BiCADMMConfig, SolveStatus,
                              fit_grid, fit_path, kappa_ladder)
from repro_torch.data import SyntheticSpec, make_sparse_regression

KW = dict(gamma=10.0, rho_c=1.0, alpha=0.5, max_iter=300, tol=1e-4,
          zt_iters=20)
SPEC = SyntheticSpec(2, 40, 60, sparsity_level=0.75, noise=1e-3)  # m < n
KAPPAS = [16, 12, 8]
PENALTIES = dict(gammas=[20.0, 10.0, 5.0], rho_cs=[1.0, 1.0, 2.0])


def _data():
    As, bs, _ = make_sparse_regression(1, SPEC)
    return As, bs


@functools.lru_cache(maxsize=None)
def _jax_solver(x_solver, **over):
    return JaxBiCADMM("squared", JaxConfig(kappa=SPEC.kappa,
                                           x_solver=x_solver,
                                           **{**KW, **over}))


def _port_solver(x_solver, **over):
    return BiCADMM("squared", BiCADMMConfig(kappa=SPEC.kappa,
                                            x_solver=x_solver,
                                            **{**KW, **over}))


def _assert_points(path, jpath, coef_tol=1e-3, z_tol=1e-4):
    np.testing.assert_array_equal(path.status.numpy(),
                                  np.asarray(jpath.status))
    np.testing.assert_array_equal(path.support.numpy(),
                                  np.asarray(jpath.support))
    if z_tol is not None:
        np.testing.assert_allclose(path.z.numpy(), np.asarray(jpath.z),
                                   rtol=z_tol, atol=z_tol)
    np.testing.assert_allclose(path.coef.numpy(),
                               np.asarray(jpath.coef, np.float32),
                               rtol=coef_tol, atol=coef_tol)
    assert np.max(np.abs(path.iters.numpy().astype(np.int64)
                         - np.asarray(jpath.iters, np.int64))) <= 2
    np.testing.assert_array_equal(path.cardinality.numpy(),
                                  np.asarray(jpath.cardinality))
    np.testing.assert_allclose(path.train_loss.numpy(),
                               np.asarray(jpath.train_loss), rtol=1e-3,
                               atol=1e-4)


# ------------------------------------------------- squared-loss paths ----
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("grid", ["kappa", "penalties"])
@pytest.mark.parametrize("x_solver", ["dense", "woodbury", "pcg"])
def test_path_matches_jax(x_solver, grid, warm):
    """Warm and cold paths through every x-update, with gamma / rho_c grids
    on the spectral factors (the counterpart of
    test_path_traced_penalties_all_backends)."""
    As, bs = _data()
    pen = PENALTIES if grid == "penalties" else {}
    jpath = jax_fit_path(_jax_solver(x_solver), jnp.asarray(As),
                         jnp.asarray(bs), KAPPAS, warm_start=warm, **pen)
    path = fit_path(_port_solver(x_solver), torch.as_tensor(As),
                    torch.as_tensor(bs), KAPPAS, warm_start=warm, **pen)
    _assert_points(path, jpath)
    assert path.strategy == jpath.strategy
    np.testing.assert_array_equal(path.kappas.numpy(), np.asarray(jpath.kappas))
    np.testing.assert_array_equal(path.gammas.numpy(), np.asarray(jpath.gammas))
    np.testing.assert_array_equal(path.rho_cs.numpy(),
                                  np.asarray(jpath.rho_cs))
    if warm:   # the carried state is the last point's
        np.testing.assert_allclose(path.state.z.numpy(),
                                   np.asarray(jpath.state.z), rtol=1e-4,
                                   atol=1e-4)


def test_grid_equals_the_cold_scan_bit_for_bit():
    As, bs = _data()
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    solver = _port_solver("woodbury")
    grid = fit_grid(solver, A, b, KAPPAS, **PENALTIES)
    cold = fit_path(solver, A, b, KAPPAS, warm_start=False, **PENALTIES)
    # the grid runs its points on a lane axis; on these spectral factors
    # its lanes still equal the scan's points bit for bit on the CPU
    assert grid.strategy == "vmap" and cold.strategy == "cold-scan"
    assert grid.state is None
    for name in ("coef", "z", "support", "iters", "p_r", "d_r", "b_r",
                 "cardinality", "train_loss", "status"):
        assert torch.equal(getattr(grid, name), getattr(cold, name)), name
    # the cold scan's points are the plain fits at each kappa
    first = solver.run_from(A, b, solver.init_state(A, b), kappa=16,
                            gamma=20.0, rho_c=1.0)
    assert int(first.iters) == int(cold.iters[0])
    assert torch.equal(first.support, cold.support[0])


def test_warm_path_beats_the_cold_path_and_keeps_the_budget():
    As, bs = _data()
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    solver = _port_solver("woodbury")
    warm = fit_path(solver, A, b, KAPPAS)
    cold = fit_path(solver, A, b, KAPPAS, warm_start=False)
    assert int(warm.iters.sum()) < int(cold.iters.sum())
    assert bool((warm.cardinality <= torch.as_tensor(KAPPAS)).all())
    assert warm.x.shape == warm.x_sparse.shape == (3, SPEC.n_features)
    out = convert.path_to_numpy(warm)
    assert out["strategy"] == "warm-scan" and out["state"]["z"].shape == (60,)
    np.testing.assert_array_equal(out["kappas"], KAPPAS)


def test_setup_cache_keeps_static_and_spectral_factors_apart():
    """A kappa path and a gamma grid on the same tensors take different
    factors (Cholesky and eigh), each set up once."""
    As, bs = _data()
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    solver = _port_solver("woodbury")
    fit_path(solver, A, b, KAPPAS)
    fit_path(solver, A, b, KAPPAS, **PENALTIES)
    kinds = sorted(type(v[-1][0]).__name__
                   for v in solver._setup_cache.values())
    assert kinds == ["WoodburyEighFactors", "WoodburyFactors"]
    fit_path(solver, A, b, KAPPAS, gammas=[1.0, 2.0, 3.0])
    assert len(solver._setup_cache) == 2


def test_run_from_with_overrides_matches_jax():
    As, bs = _data()
    jA, jb = jnp.asarray(As), jnp.asarray(bs)
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    jsolver, solver = _jax_solver("woodbury"), _port_solver("woodbury")
    over = dict(kappa=12, gamma=5.0, rho_c=2.0)
    jres = jsolver.run_from(jA, jb, jsolver.init_state(jA, jb), **over)
    res = solver.run_from(A, b, solver.init_state(A, b), **over)
    assert int(res.status) == int(jres.status)
    np.testing.assert_array_equal(res.support.numpy(),
                                  np.asarray(jres.support))
    np.testing.assert_allclose(res.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(res.iters) - int(jres.iters)) <= 2
    # a rho_c override alone keeps the configured gamma
    only = solver.run_from(A, b, solver.init_state(A, b), rho_c=1.0)
    plain = solver.fit(A, b)
    assert torch.equal(only.support, plain.support)
    assert abs(int(only.iters) - int(plain.iters)) <= 2


@pytest.mark.parametrize("x_solver", ["dense", "woodbury"])
def test_fit_with_history_matches_jax(x_solver):
    As, bs = _data()
    jres = _jax_solver(x_solver).fit_with_history(jnp.asarray(As),
                                                  jnp.asarray(bs), iters=25)
    res = _port_solver(x_solver).fit_with_history(torch.as_tensor(As),
                                                  torch.as_tensor(bs),
                                                  iters=25)
    assert int(res.iters) == int(jres.iters) == 25
    # the residuals are norms of differences of iterates: rtol 1e-4, atol
    # 1e-5 per unit of the iterates' norm (the repo's f32 kernel bound)
    scale = float(np.linalg.norm(np.asarray(jres.state.x)))
    for name in ("p_r", "d_r", "b_r"):
        np.testing.assert_allclose(res.history[name].numpy(),
                                   np.asarray(jres.history[name]),
                                   rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=name)
    assert res.history["card"].dtype == torch.int32
    np.testing.assert_array_equal(res.history["card"].numpy(),
                                  np.asarray(jres.history["card"]))
    np.testing.assert_allclose(res.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)


# ------------------------------------------- the other losses' paths ----
# (their tests: tests/test_torch_path_classifiers.py)
CLS_SPEC = SyntheticSpec(2, 100, 30, sparsity_level=0.8, noise=0.0)
CLS_KW = dict(gamma=50.0, rho_c=0.5, alpha=0.5, tol=3e-4, zt_iters=20)


def test_feature_split_sweeps_kappa_only():
    As, bs = _data()
    kw = dict(n_feature_blocks=2, max_iter=40)
    jpath = jax_fit_path(_jax_solver("auto", **kw), jnp.asarray(As),
                         jnp.asarray(bs), KAPPAS)
    solver = _port_solver("auto", **kw)
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    _assert_points(fit_path(solver, A, b, KAPPAS), jpath)
    with pytest.raises(ValueError, match="feature-split"):
        fit_path(solver, A, b, KAPPAS, gammas=[10.0, 5.0, 1.0])
    with pytest.raises(ValueError, match="feature-split"):
        solver.run_from(A, b, solver.init_state(A, b), gamma=5.0)
    with pytest.raises(ValueError):
        api.solve_grid(api.SparseProblem("squared", kappa=16), As, bs,
                       KAPPAS, rho_cs=[1.0, 2.0, 3.0],
                       options=api.SolverOptions(device="cpu",
                                                 n_feature_blocks=2))


def test_reduced_precision_path_follows_jax():
    """The JAX path applies no precision cast (its fit does): f32 data
    under the bf16 preset runs the f32 path; bf16 data runs with bf16
    grids, and the compiled finalize keeps the polish's A^T b in f32."""
    As, bs = _data()
    kw = dict(precision="bf16")
    jsolver = _jax_solver("woodbury", **kw)
    for cast in (False, True):
        jA, jb = jnp.asarray(As), jnp.asarray(bs)
        A, b = torch.as_tensor(As), torch.as_tensor(bs)
        if cast:
            jA, jb = jA.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
            A, b = A.to(torch.bfloat16), b.to(torch.bfloat16)
        jpath = jax_fit_path(jsolver, jA, jb, KAPPAS, **PENALTIES)
        path = fit_path(_port_solver("woodbury", **kw), A, b, KAPPAS,
                        **PENALTIES)
        _assert_points(path, jpath)
        assert path.kappas.dtype == A.dtype
        assert path.coef.dtype == torch.float32


# ------------------------------------------------------- kappa_ladder ----
def test_kappa_ladder_reproduces_jax_integers():
    """Every split of XLA's float32 linspace (unrolled to 17 steps, folded
    vector lanes by 4 below 56 steps and by 8 below 80, a vector loop from
    80), large n (where an ulp of the float32 values decides the rounding)
    and both orders."""
    ns = list(range(2, 40)) + [100, 120, 400, 999, 1000, 2500, 4000, 10_000,
                               12_345, 100_000, 409_601, 777_777]
    for n in ns:
        for num in (1, 2, 3, 5, 8, 12, 17, 18, 19, 24, 33, 48, 64, 100,
                    128):
            for lo, hi in ((0.05, 0.5), (0.05, 0.25), (0.01, 0.9)):
                want = jax_kappa_ladder(n, num, lo_frac=lo, hi_frac=hi,
                                        descending=False)
                got = kappa_ladder(n, num, lo_frac=lo, hi_frac=hi,
                                   descending=False)
                assert got == want, (n, num, lo, hi)
                assert kappa_ladder(n, num, lo_frac=lo,
                                    hi_frac=hi) == want[::-1]
    assert kappa_ladder(10_000, 8, hi_frac=0.25) == [
        2500, 1986, 1578, 1254, 997, 792, 629, 500]


# ------------------------------------------------- the api's sweeps ----
def test_solve_path_and_grid_match_jax_and_leave_the_estimator_fitted():
    As, bs = _data()
    problem = dict(loss="squared", kappa=SPEC.kappa, gamma=10.0)
    opts = dict(tol=1e-4, zt_iters=20)
    jpath = japi.solve_path(japi.SparseProblem(**problem), jnp.asarray(As),
                            jnp.asarray(bs), KAPPAS,
                            options=japi.SolverOptions(**opts), **PENALTIES)
    path = api.solve_path(api.SparseProblem(**problem), As, bs, KAPPAS,
                          options=api.SolverOptions(device="cpu", **opts),
                          **PENALTIES)
    _assert_points(path, jpath)
    grid = api.solve_grid(api.SparseProblem(**problem), As, bs, KAPPAS,
                          options=api.SolverOptions(device="cpu", **opts))
    assert grid.strategy == "vmap"

    kw = dict(kappa=SPEC.kappa, gamma=10.0, **opts)
    for method in ("fit_path", "fit_grid"):
        est = api.SparseLinearRegression(device="cpu", **kw)
        jest = japi.SparseLinearRegression(**kw)
        p = getattr(est, method)(As, bs, KAPPAS, **PENALTIES)
        jp = getattr(jest, method)(jnp.asarray(As), jnp.asarray(bs), KAPPAS,
                                   **PENALTIES)
        assert est.n_iter_ == int(p.iters[-1])
        assert abs(est.n_iter_ - jest.n_iter_) <= 2
        assert torch.equal(est.coef_, p.coef[-1, :, 0])
        assert torch.equal(est.support_, p.support[-1])
        assert est.result_.status_name == SolveStatus(int(p.status[-1])).name
        np.testing.assert_allclose(est.coef_.numpy(), np.asarray(jest.coef_),
                                   rtol=1e-3, atol=1e-3)
        assert abs(est.score(As, bs) - jest.score(jnp.asarray(As),
                                                  jnp.asarray(bs))) < 1e-4
        # the last point's state warm-starts a refit (warm paths carry it)
        if method == "fit_path":
            again = est.fit(As, bs, state=p.state)
            assert again.result_.state is not None


def test_capabilities_follow_the_feature_split():
    caps = api.engine_capabilities("reference")
    jcaps = japi.engine_capabilities("reference")
    split = api.engine_capabilities(
        "reference", api.SolverOptions(n_feature_blocks=2))
    jsplit = japi.engine_capabilities(
        "reference", japi.SolverOptions(n_feature_blocks=2))
    for got, want in ((caps, jcaps), (split, jsplit)):
        for name in ("dynamic_penalties", "per_solve_overrides",
                     "penalty_grids", "distributed", "warm_start"):
            assert getattr(got, name) == getattr(want, name), name
    assert caps.grid_strategy == jcaps.grid_strategy == "vmap"
    assert split.grid_strategy == "cold-scan"
    # the fleet and streaming follow the JAX engine's rule; serving waits
    assert caps.fleet == jcaps.fleet and split.fleet == jsplit.fleet
    assert caps.stream == jcaps.stream and split.stream == jsplit.stream
    assert caps.stream and not split.stream and not caps.serve
    assert dataclasses.asdict(split)["penalty_grids"] is False

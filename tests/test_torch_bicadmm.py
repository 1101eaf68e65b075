"""Whole-slice parity: the port's reference engine (repro_torch.core.BiCADMM)
against the JAX package's (repro.core.BiCADMM) on the CPU, same numpy data.

Bounds (those of tests/test_xsolver.py, since reductions reassociate across
frameworks): the same SolveStatus and support, ``z`` within rtol/atol 1e-4,
``coef`` within 1e-3, iteration counts within 2. The FISTA depth is cut to
20 steps in both packages to keep the CPU fits short. The tolerance is the
default 1e-4: at 1e-5 these instances sit on their f32 residual floor,
where rounding noise alone moves the stopping iteration by a few steps.
Both instance kinds share one shape, so one JAX solver per x_solver serves
both and compiles once.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro_torch import convert, runtime
from repro_torch.core import BiCADMM, BiCADMMConfig
from repro_torch.data import (SyntheticSpec, make_graded_regression,
                              make_sparse_regression)

KW = dict(gamma=10.0, rho_c=1.0, alpha=0.5, max_iter=300, tol=1e-4,
          zt_iters=20)
SPEC = SyntheticSpec(2, 40, 60, sparsity_level=0.75, noise=1e-3)  # m < n


def _data(kind):
    if kind == "graded":       # orthonormal design: exact, unique support
        As, bs, _ = make_graded_regression(2, SPEC)
    else:                      # Gaussian
        As, bs, _ = make_sparse_regression(1, SPEC)
    return SPEC, As, bs


@functools.lru_cache(maxsize=None)
def _jax_solver(x_solver, max_iter=KW["max_iter"]):
    kw = {**KW, "max_iter": max_iter}
    return JaxBiCADMM("squared", JaxConfig(kappa=SPEC.kappa,
                                           x_solver=x_solver, **kw))


def _assert_same(port, jres):
    assert int(port.status) == int(jres.status)
    np.testing.assert_array_equal(port.support.numpy(),
                                  np.asarray(jres.support))
    np.testing.assert_allclose(port.z.numpy(), np.asarray(jres.z),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(port.iters) - int(jres.iters)) <= 2


@pytest.mark.parametrize("kind", ["gaussian", "graded"])
@pytest.mark.parametrize("x_solver", ["dense", "woodbury", "pcg"])
def test_fit_matches_jax(x_solver, kind):
    spec, As, bs = _data(kind)
    kw = dict(kappa=spec.kappa, x_solver=x_solver, **KW)
    jres = _jax_solver(x_solver).fit(jnp.asarray(As), jnp.asarray(bs))
    port = BiCADMM("squared", BiCADMMConfig(**kw)).fit(torch.as_tensor(As),
                                                       torch.as_tensor(bs))
    _assert_same(port, jres)
    assert port.coef.shape == (spec.n_features, 1)


def test_warm_start_carried_from_jax_continues_to_the_jax_result():
    spec, As, bs = _data("gaussian")
    kw = dict(kappa=spec.kappa, x_solver="woodbury", **KW)
    jA, jb = jnp.asarray(As), jnp.asarray(bs)
    short = _jax_solver("woodbury", max_iter=5)
    st = short.run_from(jA, jb, short.init_state(jA, jb)).state
    carried = {k: (None if v is None else np.asarray(v))
               for k, v in st._asdict().items()}
    jres = _jax_solver("woodbury").run_from(jA, jb, st)
    state = convert.state_from_numpy(carried, "cpu")
    port = BiCADMM("squared", BiCADMMConfig(**kw)).run_from(
        torch.as_tensor(As), torch.as_tensor(bs), state)
    _assert_same(port, jres)
    back = convert.state_to_numpy(port.state)
    assert set(back) == set(carried)
    out = convert.result_to_numpy(port)
    np.testing.assert_array_equal(out["support"], port.support.numpy())


def test_bracketing_rounds_do_not_change_the_fit(monkeypatch):
    """rounds=2 (what the card runs, here through the plain ladder
    statistics) against the CPU default rounds=0: the projections are
    exact either way, so the fits agree to the same bounds. The CPU row of
    the rounds table is pinned to 2 for the second fit."""
    spec, As, bs = _data("graded")
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    cfg = BiCADMMConfig(kappa=spec.kappa, x_solver="woodbury", **KW)
    r0 = BiCADMM("squared", cfg).fit(A, b)
    monkeypatch.setitem(runtime._LADDER_ROUNDS, "cpu", 2)
    calls = []
    plain = runtime.kernel("ladder_stats", "cpu")
    monkeypatch.setitem(runtime._REGISTRY["ladder_stats"], "cpu",
                        lambda az, th: calls.append(1) or plain(az, th))
    r2 = BiCADMM("squared", cfg).fit(A, b)
    assert calls                      # the bracketing rounds really ran
    assert int(r0.status) == int(r2.status)
    assert torch.equal(r0.support, r2.support)
    torch.testing.assert_close(r2.z, r0.z, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(r2.coef, r0.coef, rtol=1e-3, atol=1e-3)
    assert abs(int(r0.iters) - int(r2.iters)) <= 2


def test_setup_cache_keyed_on_the_data_tensors():
    spec, As, bs = _data("gaussian")
    A, b = torch.as_tensor(As), torch.as_tensor(bs)
    solver = BiCADMM("squared", BiCADMMConfig(kappa=spec.kappa,
                                              **{**KW, "max_iter": 2}))
    first = solver._setup(A, b)
    assert solver._setup(A, b) is first
    assert solver._setup(A.clone(), b) is not first

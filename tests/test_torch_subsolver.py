"""The feature-split sub-solver (the paper's Algorithm 2) of the port against
the JAX package's, on the CPU, same numpy data at float32.

* ``block_matvec_auto`` / ``block_rmatvec_auto`` (the CPU rows) against
  ``repro.kernels.ops.block_matvec`` / ``block_rmatvec`` on the padded
  blocks: rtol/atol 1e-5 (the f32 kernel bound of the JAX package is
  1e-4 / 1e-5; these are the same sums in another order).
* ``subsolver_run`` after 25 inner iterations on a ragged instance
  (n = 62, M = 4): x and the inner state within rtol/atol 1e-4.
* Whole fits through ``BiCADMM``, the three new estimators and a warm
  state carried from JAX: ROADMAP's solver parity — the same status and
  support, coef within 1e-3, iterations within 2.

The fit cases share one shape so each JAX solver compiles once, and run
20 FISTA steps, as tests/test_torch_bicadmm.py does. The squared and
logistic fits run to convergence; the softmax fit (which does not converge
within 300 iterations here) and the estimators stop at a fixed iteration
budget, so their parity is that of the iterates after the same number of
outer iterations.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import subsolver as jsub
from repro.core.losses import get_loss as jget_loss
from repro.kernels import ops as jops
from repro_torch import api, convert
from repro_torch.core import BiCADMM, BiCADMMConfig, get_loss, subsolver
from repro_torch.data import (SyntheticSpec, make_sparse_classification,
                              make_sparse_regression, make_sparse_softmax)
from repro_torch.kernels import ops

SPEC = SyntheticSpec(2, 40, 62, sparsity_level=0.75, noise=1e-3)  # ragged
KW = dict(gamma=10.0, rho_c=1.0, alpha=0.5, tol=1e-4, zt_iters=20)
# (loss, n_classes, n_feature_blocks, max_iter) of the whole-fit cases
CASES = {"squared": ("squared", 1, 4, 300),
         "logistic": ("logistic", 1, 4, 300),
         "softmax": ("softmax", 3, 3, 40)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ------------------------------------------------------ block products --
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("N,m,n,M", [(2, 30, 62, 4), (2, 30, 64, 4),
                                     (1, 7, 5, 4)])
def test_block_products_match_jax_on_padded_blocks(N, m, n, M, K):
    rng = np.random.default_rng(n * 10 + K)
    nb = -(-n // M)
    a = rng.standard_normal((N, m, n)).astype(np.float32)
    x = rng.standard_normal((N, M, nb, K)).astype(np.float32)
    x.reshape(N, M * nb, K)[:, n:] = 0.0         # the zero padding
    y = rng.standard_normal((N, M, m, K)).astype(np.float32)
    got = ops.block_matvec_auto(torch.as_tensor(a), torch.as_tensor(x), M)
    got_t = ops.block_rmatvec_auto(torch.as_tensor(a), torch.as_tensor(y), M)
    assert tuple(got.shape) == (N, M, m, K)
    assert tuple(got_t.shape) == (N, M, nb, K)
    for z in range(N):
        a_pad, _ = jsub.pad_features(jnp.asarray(a[z]), M)
        blocks = jnp.moveaxis(a_pad.reshape(m, M, nb), 1, 0)
        _close(got[z], jops.block_matvec(blocks, jnp.asarray(x[z])), 1e-5)
        _close(got_t[z], jops.block_rmatvec(blocks, jnp.asarray(y[z])), 1e-5)
    # the adjoint's padded rows are exactly 0
    assert not got_t.reshape(N, M * nb, K)[:, n:].any()


# ------------------------------------------------------------ sub-solver --
def _loss_pair(name, C):
    return get_loss(name, C), jget_loss(name, C)


@pytest.mark.parametrize("case", sorted(CASES))
def test_subsolver_run_matches_jax(case):
    name, C = CASES[case][:2]
    N, m, n, M = 2, 40, 62, 4
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((N, m, n)) / np.sqrt(m)).astype(np.float32)
    if name == "softmax":
        b = rng.integers(0, C, (N, m))
    elif name == "logistic":
        b = np.where(rng.random((N, m)) < 0.5, -1.0, 1.0).astype(np.float32)
    else:
        b = rng.standard_normal((N, m)).astype(np.float32)
    q = rng.standard_normal((N, n, C)).astype(np.float32)
    sigma, rho_c, rho_l = 0.05, 1.0, 1.0
    tl, jl = _loss_pair(name, C)
    f = subsolver.subsolver_setup(torch.as_tensor(A), sigma, rho_c, rho_l, M)
    st = subsolver.subsolver_init(f, C, m)
    x, st = subsolver.subsolver_run(tl, f, torch.as_tensor(b),
                                    torch.as_tensor(q), st, 25)
    # the padded rows of x stay exactly 0, as the JAX zero padding keeps them
    assert not st.x_blocks.reshape(N, -1, C)[:, n:].any()

    @jax.jit
    def one(A, b, q):
        jf = jsub.subsolver_setup(A, sigma, rho_c, rho_l, M)
        return jsub.subsolver_run(jl, jf, b, q,
                                  jsub.subsolver_init(jf, C, m), 25)
    for z in range(N):
        jx, jst = one(jnp.asarray(A[z]), jnp.asarray(b[z]),
                      jnp.asarray(q[z]))
        _close(x[z], jx, 1e-4)
        _close(st.x_blocks[z], jst.x_blocks, 1e-4)
        _close(st.nu[z], jst.nu, 1e-4)
        _close(st.omega_bar[z], jst.omega_bar, 1e-4)


def test_setup_reads_the_blocks_in_place():
    """The factors hold the caller's data tensor itself (no padded or
    blocked copy), and the padded rows of the factor are sqrt(c) I."""
    A = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 9, 10)).astype(np.float32))
    f = subsolver.subsolver_setup(A, 0.25, 1.0, 1.0, 4)     # nb = 3
    assert f.A is A and f.nb == 3
    tail = f.chol[:, 3, 1:, 1:]          # block 3 holds column 9 only
    torch.testing.assert_close(tail, 1.25 ** 0.5 * torch.eye(2).expand(
        2, 2, 2))


# ------------------------------------------------------------ whole fits --
def _data(name, C=1):
    if name == "softmax":
        spec = SyntheticSpec(2, 40, 62, sparsity_level=0.75, noise=1e-3,
                             n_classes=C)
        As, bs, x_true = make_sparse_softmax(4, spec)
        return As, bs, int((x_true != 0).sum())
    gen = make_sparse_classification if name == "logistic" else \
        make_sparse_regression
    As, bs, _ = gen(1, SPEC)
    return As, bs, SPEC.kappa


def _config(cls, case, max_iter=None):
    name, C, M, iters = CASES[case]
    _, _, kappa = _data(name, C)
    return cls(kappa=kappa, n_feature_blocks=M, **KW,
               max_iter=iters if max_iter is None else max_iter)


@functools.lru_cache(maxsize=None)
def _jax_solver(case, max_iter=None):
    name, C = CASES[case][:2]
    return JaxBiCADMM(name, _config(JaxConfig, case, max_iter), n_classes=C)


def _port_solver(case):
    name, C = CASES[case][:2]
    return BiCADMM(name, _config(BiCADMMConfig, case), n_classes=C)


def _assert_same(port, jres):
    assert int(port.status) == int(jres.status)
    np.testing.assert_array_equal(port.support.numpy(),
                                  np.asarray(jres.support))
    np.testing.assert_allclose(port.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(port.iters) - int(jres.iters)) <= 2


def test_feature_split_warm_state_carried_from_jax():
    As, bs, _ = _data("squared")
    jA, jb = jnp.asarray(As), jnp.asarray(bs)
    short = _jax_solver("squared", max_iter=5)
    st = short.run_from(jA, jb, short.init_state(jA, jb)).state
    # the JAX SubsolverState itself (numpy leaves: run_from donates st)
    carried = {k: (jax.tree.map(np.asarray, v) if k == "inner"
                   else np.asarray(v)) for k, v in st._asdict().items()}
    jres = _jax_solver("squared").run_from(jA, jb, st)
    state = convert.state_from_numpy(carried, "cpu")
    assert state.inner.nu.shape == (2, 40, 1)
    port = _port_solver("squared").run_from(torch.as_tensor(As),
                                            torch.as_tensor(bs), state)
    _assert_same(port, jres)
    back = convert.state_to_numpy(port.state)
    assert sorted(back["inner"]) == ["nu", "omega_bar", "x_blocks"]
    again = convert.state_from_numpy(back, "cpu")
    assert torch.equal(again.inner.x_blocks, port.state.inner.x_blocks)


# ------------------------------------------------------------ estimators --
ESTIMATORS = {
    "logistic": (dict(), api.SparseLogisticRegression,
                 japi.SparseLogisticRegression),
    "svm_plain": (dict(hinge="plain"), api.SparseSVM, japi.SparseSVM),
    "softmax": (dict(n_classes=3), api.SparseSoftmaxRegression,
                japi.SparseSoftmaxRegression),
}


@pytest.mark.parametrize("which", sorted(ESTIMATORS))
def test_classifier_estimators_match_jax(which):
    extra, cls, jcls = ESTIMATORS[which]
    name = "softmax" if which == "softmax" else "logistic"
    As, bs, kappa = _data(name, extra.get("n_classes", 1))
    kw = dict(kappa=kappa, gamma=10.0, rho_c=1.0, tol=1e-4, zt_iters=20,
              max_iter=20, n_feature_blocks=4, **extra)
    jest = jcls(**kw).fit(jnp.asarray(As), jnp.asarray(bs))
    est = cls(device="cpu", **kw).fit(As, bs)
    assert int(est.result_.status) == int(jest.result_.status)
    np.testing.assert_array_equal(est.support_.numpy(),
                                  np.asarray(jest.support_))
    np.testing.assert_allclose(est.coef_.numpy(), np.asarray(jest.coef_),
                               rtol=1e-3, atol=1e-3)
    assert abs(est.n_iter_ - jest.n_iter_) <= 2
    X_new = np.random.default_rng(0).standard_normal((9, 62)).astype(
        np.float32)
    np.testing.assert_allclose(
        est.decision_function(X_new).numpy(),
        np.asarray(jest.decision_function(jnp.asarray(X_new))),
        rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(est.predict(As).numpy(),
                                  np.asarray(jest.predict(jnp.asarray(As))))
    assert est.score(As, bs) == pytest.approx(
        jest.score(jnp.asarray(As), jnp.asarray(bs)), abs=1e-6)

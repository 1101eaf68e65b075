"""The port's hyperparameter paths of the classifiers (logistic, smoothed
and plain hinge, softmax; repro_torch.core.path and the estimators'
``fit_path``) against the JAX package's, on the CPU, same numpy data. They
sit in a file of their own, apart from tests/test_torch_path.py, because
they are the slowest of the path tests: under ``--dist loadfile`` a file
never splits across workers.

Per grid point the bounds of tests/test_torch_path.py (``_assert_points``):
the same SolveStatus and support, ``coef`` within 1e-3, iteration counts
within 2; the paths are cut to 30-60 iterations a point to bound the CPU
time.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import BiCADMM as JaxBiCADMM
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import fit_path as jax_fit_path
from repro_torch import api
from repro_torch.core import BiCADMM, BiCADMMConfig, fit_path
from repro_torch.data import (SyntheticSpec, make_graded_classification,
                              make_sparse_softmax)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_path import CLS_KW, CLS_SPEC, _assert_points  # noqa: E402


# the plain hinge's prox is exact only in the feature split (Newton-CG on
# its step-function gradient is ill-posed), so it sweeps there
@pytest.mark.parametrize("loss,kappas,extra", [
    ("logistic", [6, 4, 3], dict(max_iter=60)),
    ("smoothed_hinge", [6, 4], dict(max_iter=60)),
    ("hinge", [6, 4], dict(max_iter=30, n_feature_blocks=2))])
def test_margin_loss_paths_match_jax(loss, kappas, extra):
    As, bs, _ = make_graded_classification(2, CLS_SPEC)
    kw = dict(kappa=6, **extra, **CLS_KW)
    jpath = jax_fit_path(JaxBiCADMM(loss, JaxConfig(**kw)), jnp.asarray(As),
                         jnp.asarray(bs), kappas)
    path = fit_path(BiCADMM(loss, BiCADMMConfig(**kw)), torch.as_tensor(As),
                    torch.as_tensor(bs), kappas)
    _assert_points(path, jpath, z_tol=None)
    assert bool((path.cardinality <= torch.as_tensor(kappas)).all())


def test_softmax_path_matches_jax():
    spec = SyntheticSpec(2, 80, 12, sparsity_level=0.7, noise=0.0,
                         n_classes=3)
    As, bs, x_true = make_sparse_softmax(5, spec)
    kap = int((x_true != 0).sum())
    kappas = [kap, max(kap - 3, 2)]
    kw = dict(kappa=kap, max_iter=40, **{**CLS_KW, "tol": 5e-4})
    jpath = jax_fit_path(JaxBiCADMM("softmax", JaxConfig(**kw), n_classes=3),
                         jnp.asarray(As), jnp.asarray(bs), kappas)
    path = fit_path(BiCADMM("softmax", BiCADMMConfig(**kw), n_classes=3),
                    torch.as_tensor(As), torch.as_tensor(bs), kappas)
    _assert_points(path, jpath, z_tol=None)
    assert path.coef.shape == (2, 12, 3) and path.x.shape == (2, 36)


def test_classifier_estimator_paths_match_jax():
    As, bs, _ = make_graded_classification(2, CLS_SPEC)
    kw = dict(kappa=6, gamma=50.0, rho_c=0.5, tol=3e-4, zt_iters=20,
              max_iter=60)
    est = api.SparseLogisticRegression(device="cpu", **kw)
    jest = japi.SparseLogisticRegression(**kw)
    path = est.fit_path(As, bs, [6, 4])
    jpath = jest.fit_path(jnp.asarray(As), jnp.asarray(bs), [6, 4])
    _assert_points(path, jpath, z_tol=None)
    assert est.engine_ == "reference" and est.n_iter_ == int(path.iters[-1])
    np.testing.assert_array_equal(est.predict(As).numpy(),
                                  np.asarray(jest.predict(jnp.asarray(As))))

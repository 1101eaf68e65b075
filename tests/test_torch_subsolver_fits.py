"""Whole feature-split fits of the port (Algorithm 2 inside the outer
Bi-cADMM loop, repro_torch.core.subsolver) against the JAX package's, on
the CPU, same numpy data: squared, logistic, the plain hinge and 3-class
softmax. They sit in a file of their own, apart from
tests/test_torch_subsolver.py, because they are its slowest tests: under
``--dist loadfile`` a file never splits across workers.

Bounds of tests/test_torch_subsolver.py (``_assert_same``): the same
SolveStatus and support, ``coef`` within 1e-3, iterations within 2.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_subsolver import (CASES, SPEC, _assert_same,  # noqa: E402
                                  _data, _jax_solver, _port_solver)


@pytest.mark.parametrize("case", sorted(CASES))
def test_feature_split_fit_matches_jax(case):
    name, C = CASES[case][:2]
    As, bs, _ = _data(name, C)
    jres = _jax_solver(case).fit(jnp.asarray(As), jnp.asarray(bs))
    port = _port_solver(case).fit(torch.as_tensor(As), torch.as_tensor(bs))
    _assert_same(port, jres)
    assert port.coef.shape == (SPEC.n_features, C)
    assert port.state.inner.x_blocks.shape[:2] == (2, CASES[case][2])

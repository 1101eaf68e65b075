"""The port's projections (repro_torch.core.bilinear) against the JAX
package's (repro.core.bilinear) on the same numpy inputs.

The cases follow tests/test_ladder.py: random vectors, tie clusters, the
apex and inside cases, t0 <= 0, tiny scale, fractional and over-budget
kappa. The CPU fits run ``rounds=0``; ``rounds=2`` runs the bracketing
rounds through the plain ladder statistics here (the card runs the kernel).
Tolerance: the JAX ladder tests' own, atol 1e-5 on the projections
(1e-36 at 1e-30 scale), and exact equality for hard thresholding. The JAX
functions run under ``jax.jit``, as the JAX solver runs them; that also
compiles each shape once instead of dispatching every loop step.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bilinear as jbl
from repro_torch.core import bilinear as tbl

J_PROJECT = jax.jit(jbl.project_l1_epigraph)
J_PROJECT_SORT = jax.jit(jbl.project_l1_epigraph_sort)
J_SUPPORT = jax.jit(jbl.support_skappa_ladder)
J_S_UPDATE = jax.jit(jbl.s_update)
J_HARD = jax.jit(jbl.hard_threshold, static_argnums=1)
J_HARD_SORT = jax.jit(jbl.hard_threshold_sort, static_argnums=1)


def _vec(seed, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


def _ties(seed, n_vals, reps):
    vals = np.random.default_rng(seed).standard_normal(n_vals)
    return np.repeat(vals, reps).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_case(fn_name, case):
    """The JAX result of one case, computed once for both ``rounds``."""
    if fn_name == "project":
        _, z0, t0 = CASES[case]
        zj, tj = J_PROJECT(jnp.asarray(z0), jnp.float32(t0))
        return np.asarray(zj), float(tj)
    z, kappa = SUPPORT[case]
    uj, sj = J_SUPPORT(jnp.asarray(z), kappa)
    return float(uj), np.asarray(sj)


def _project_both(z0, t0, rounds, case=None):
    if case is None:
        zj, tj = J_PROJECT(jnp.asarray(z0), jnp.float32(t0))
    else:
        zj, tj = _jax_case("project", case)
    zt, tt = tbl.project_l1_epigraph(torch.as_tensor(z0),
                                     torch.tensor(t0, dtype=torch.float32),
                                     rounds=rounds)
    return (np.asarray(zj), float(tj)), (zt.numpy(), float(tt))


CASES = [("random", _vec(0, 300), 1.7), ("random", _vec(1, 2), -0.5),
         ("random", _vec(2, 513), 7.0), ("ties", _ties(3, 4, 30), 0.4),
         ("ties", _ties(4, 1, 40), -1.0), ("apex", _vec(5, 3) * 0.1, -10.0),
         ("t0=0", _vec(6, 50), 0.0), ("inside", np.float32([0.5, -0.25]), 2.0)]


@pytest.mark.parametrize("rounds", [0, 2])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_project_l1_epigraph_matches_jax(case, rounds):
    _, z0, t0 = CASES[case]
    (zj, tj), (zt, tt) = _project_both(z0, t0, rounds, case)
    np.testing.assert_allclose(zt, zj, atol=1e-5)
    assert abs(tt - tj) < 1e-5
    assert np.abs(zt).sum() <= tt + 1e-5          # feasible


def test_project_l1_epigraph_tiny_scale():
    z0 = _vec(7, 80, 1e-30)
    for rounds in (0, 2):
        (zj, tj), (zt, tt) = _project_both(z0, 1e-31, rounds)
        np.testing.assert_allclose(zt, zj, atol=1e-36)
        assert abs(tt - tj) < 1e-36


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 513)])
def test_sort_oracle_matches_jax_sort_oracle(seed, n):
    z0 = _vec(seed, n)
    zj, tj = J_PROJECT_SORT(jnp.asarray(z0), 0.7)
    zt, tt = tbl.project_l1_epigraph_sort(torch.as_tensor(z0), 0.7)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
    assert abs(float(tt) - float(tj)) < 1e-5


SUPPORT = [(_vec(0, 200), 20.0), (_vec(1, 60), 7.5), (_vec(2, 30), 45.0),
           (_vec(3, 100), 0.5),
           (np.float32([0.5] * 6 + [0.2] * 4), 3.0),       # tie straddles
           (np.float32([3.0, -2.0, 1.0, 0.5]), 2.5)]


@pytest.mark.parametrize("rounds", [0, 2])
@pytest.mark.parametrize("case", range(len(SUPPORT)))
def test_support_skappa_ladder_matches_jax(case, rounds):
    z, kappa = SUPPORT[case]
    uj, sj = _jax_case("support", case)
    ut, st = tbl.support_skappa_ladder(torch.as_tensor(z), kappa,
                                       rounds=rounds)
    assert abs(float(ut) - float(uj)) < 1e-5 * max(1.0, abs(float(uj)))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    us, _ = tbl.support_skappa_sort(torch.as_tensor(z), kappa)
    assert abs(float(ut) - float(us)) < 1e-4 * max(1.0, abs(float(us)))


@pytest.mark.parametrize("rounds", [0, 2])
@pytest.mark.parametrize("seed,n,kappa", [(0, 120, 12.0), (1, 40, 30.0),
                                          (2, 8, 1.0)])
def test_s_update_matches_jax(seed, n, kappa, rounds):
    z = _vec(seed, n)
    sj = J_S_UPDATE(jnp.asarray(z), 1.7, 0.3, kappa)
    st = tbl.s_update(torch.as_tensor(z), 1.7, 0.3, kappa, rounds=rounds)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    ss = tbl.s_update(torch.as_tensor(z), 1.7, 0.3, kappa, method="sort")
    np.testing.assert_allclose(ss.numpy(), np.asarray(sj), atol=1e-5)


@pytest.mark.parametrize("z,kappa", [
    (np.float32([0.5, -0.5, 0.5, 0.2, -0.2]), 2),      # ties: lower index
    (np.float32([0.5, -0.5, 0.5, 0.2, -0.2]), 2.5),
    (np.float32([0.5, -0.5, 0.5, 0.2, -0.2]), 4),
    (np.float32([0.5, -0.5, 0.5, 0.2, -0.2]), 7),
    (np.float32([1.0, 1.0, 1.0, 1.0]), 1),
    (_vec(8, 100), 17), (_vec(9, 100), 0)])
def test_hard_threshold_matches_jax_including_ties(z, kappa):
    want = np.asarray(J_HARD(jnp.asarray(z), kappa))
    np.testing.assert_array_equal(
        tbl.hard_threshold(torch.as_tensor(z), kappa).numpy(), want)
    np.testing.assert_array_equal(
        tbl.hard_threshold_sort(torch.as_tensor(z), kappa).numpy(),
        np.asarray(J_HARD_SORT(jnp.asarray(z), kappa)))


def test_bilinear_residual_matches_jax():
    z, s = _vec(10, 50), _vec(11, 50)
    gj = float(jbl.g(jnp.asarray(z), jnp.asarray(s), 0.3))
    gt = float(tbl.g(torch.as_tensor(z), torch.as_tensor(s), 0.3))
    assert abs(gt - gj) < 1e-5

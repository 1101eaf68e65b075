"""The port's x-update engines (repro_torch.core.prox) against the JAX
package's (repro.core.prox) on the same numpy inputs.

One prox solve per backend — dense Cholesky, Woodbury dual, Jacobi-PCG —
with the nodes stacked on a leading axis in the port and one JAX call per
node, at m < n and m > n. Tolerance: rtol/atol 1e-4, the bound
tests/test_xsolver.py holds the JAX backends to against each other.
``NodeProxEngine.choose`` must pick the JAX package's backend on a grid of
shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro_torch.core import prox as tprox

SIGMA, RHO_C = 0.5, 1.0


def _problem(N, m, n, seed=0):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((N, m, n)) / np.sqrt(m)).astype(np.float32)
    b = rng.standard_normal((N, m)).astype(np.float32)
    q = rng.standard_normal((N, n)).astype(np.float32)
    x0 = rng.standard_normal((N, n)).astype(np.float32)
    return A, b, q, x0


def _jax_solve(kind, A, b, q, x0):
    out = []
    for i in range(A.shape[0]):
        Ai, bi = jnp.asarray(A[i]), jnp.asarray(b[i])
        if kind == "dense":
            f = jprox.ridge_setup(Ai, bi, SIGMA, RHO_C)
        elif kind == "woodbury":
            f = jprox.woodbury_setup(Ai, bi, SIGMA, RHO_C)
        else:
            f = jprox.cg_setup(Ai, bi, 200, 1e-6)
        out.append(np.asarray(jprox.x_solve(f, jnp.asarray(q[i]), RHO_C,
                                            SIGMA, jnp.asarray(x0[i]))))
    return np.stack(out)


@pytest.mark.parametrize("kind", ["dense", "woodbury", "pcg"])
@pytest.mark.parametrize("m,n", [(30, 90), (90, 30)])
def test_prox_matches_jax(kind, m, n):
    A, b, q, x0 = _problem(2, m, n)
    eng = tprox.NodeProxEngine(kind)
    f = eng.setup(torch.as_tensor(A), torch.as_tensor(b), SIGMA, RHO_C)
    got = eng.solve(f, torch.as_tensor(q), RHO_C, SIGMA,
                    torch.as_tensor(x0)).numpy()
    np.testing.assert_allclose(got, _jax_solve(kind, A, b, q, x0),
                               rtol=1e-4, atol=1e-4)


def test_pcg_stops_each_node_on_its_own():
    """Nodes converge at different CG steps; a finished node is frozen, as
    the JAX package's vmapped while_loop freezes it."""
    A, b, q, x0 = _problem(3, 40, 25, seed=1)
    A[1] *= 5.0                  # a worse-conditioned node
    f = tprox.cg_setup(torch.as_tensor(A), torch.as_tensor(b), 7, 1e-6)
    got = tprox.pcg_prox(f, torch.as_tensor(q), RHO_C, SIGMA,
                         torch.as_tensor(x0)).numpy()
    for i in range(3):
        fj = jprox.cg_setup(jnp.asarray(A[i]), jnp.asarray(b[i]), 7, 1e-6)
        want = jprox.pcg_prox(fj, jnp.asarray(q[i]), RHO_C, SIGMA,
                              jnp.asarray(x0[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_col_sumsq_matches_jax():
    A, *_ = _problem(1, 20, 33)
    np.testing.assert_allclose(tprox.col_sumsq(torch.as_tensor(A[0])).numpy(),
                               np.asarray(jprox.col_sumsq(jnp.asarray(A[0]))),
                               rtol=1e-6)


def test_choose_matches_jax_backend_policy():
    grid = [1, 100, 2047, 2048, 2049, 8191, 8192, 8193, 10_000, 100_000]
    for m in grid:
        for n in grid:
            for xs in ("auto", "dense", "woodbury", "pcg"):
                assert (tprox.NodeProxEngine.choose(m, n, x_solver=xs).kind
                        == jprox.NodeProxEngine.choose(m, n,
                                                       x_solver=xs).kind)
    assert (tprox.DENSE_MAX_N, tprox.WOODBURY_MAX_M) == (
        jprox.DENSE_MAX_N, jprox.WOODBURY_MAX_M)
    with pytest.raises(ValueError):
        tprox.NodeProxEngine.choose(8, 8, x_solver="qr")

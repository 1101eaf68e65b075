"""The port's x-update engines (repro_torch.core.prox) against the JAX
package's (repro.core.prox) on the same numpy inputs.

One prox solve per backend — dense Cholesky, Woodbury dual, Jacobi-PCG —
with the nodes stacked on a leading axis in the port and one JAX call per
node, at m < n and m > n. Tolerance: rtol/atol 1e-4, the bound
tests/test_xsolver.py holds the JAX backends to against each other.
``NodeProxEngine.choose`` must pick the JAX package's backend on a grid of
shapes. The spectral factors (``dynamic=True``: ``ridge_prox_eigh``,
``woodbury_prox_eigh`` with its refinement pass) are held to the same
rtol 1e-4 at several (sigma, rho_c) shifts from one set-up, and
``direct_prox`` to the closed form and to Newton-CG.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prox as jprox
from repro_torch.core import prox as tprox
from repro_torch.kernels import ops

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
                for dyn in (False, True):
                    got = tprox.NodeProxEngine.choose(m, n, x_solver=xs,
                                                      dynamic=dyn)
                    want = jprox.NodeProxEngine.choose(m, n, x_solver=xs,
                                                       dynamic=dyn)
                    assert (got.kind, got.dynamic) == (want.kind,
                                                       want.dynamic)
    assert (tprox.DENSE_MAX_N, tprox.WOODBURY_MAX_M) == (
        jprox.DENSE_MAX_N, jprox.WOODBURY_MAX_M)
    with pytest.raises(ValueError):
        tprox.NodeProxEngine.choose(8, 8, x_solver="qr")


SHIFTS = [(0.5, 1.0), (0.05, 4.0), (2.0, 0.25), (1e-3, 1e-2)]


@pytest.mark.parametrize("kind", ["dense", "woodbury"])
@pytest.mark.parametrize("m,n", [(30, 90), (90, 30)])
def test_spectral_prox_matches_jax_at_every_shift(kind, m, n):
    A, b, q, x0 = _problem(2, m, n, seed=3)
    eng = tprox.NodeProxEngine.choose(m, n, x_solver=kind, dynamic=True)
    assert eng.dynamic and eng.kind == kind
    f = eng.setup(torch.as_tensor(A), torch.as_tensor(b), 9.0, 9.0)
    assert isinstance(f, tprox.EighRidgeFactors if kind == "dense"
                      else tprox.WoodburyEighFactors)
    setup = (jprox.ridge_setup_eigh if kind == "dense"
             else jprox.woodbury_setup_eigh)
    jf = [setup(jnp.asarray(A[i]), jnp.asarray(b[i])) for i in range(2)]
    for sigma, rho_c in SHIFTS:
        got = eng.solve(f, torch.as_tensor(q), rho_c, sigma).numpy()
        want = np.stack([np.asarray(jprox.x_solve(jf[i], jnp.asarray(q[i]),
                                                  rho_c, sigma))
                         for i in range(2)])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"sigma={sigma}, rho_c={rho_c}")
        # the same prox as the static Cholesky factors at this shift
        static = tprox.NodeProxEngine(kind).setup(
            torch.as_tensor(A), torch.as_tensor(b), sigma, rho_c)
        np.testing.assert_allclose(
            got, tprox.x_solve(static, torch.as_tensor(q), rho_c,
                               sigma).numpy(), rtol=1e-4, atol=1e-4 * scale)


def test_woodbury_refinement_is_the_normal_matvec_residual():
    """On the CPU the refinement's A^T (A x0) + c x0 through normal_matvec
    is the JAX package's matvec / rmatvec composition, sum for sum."""
    A, b, q, _ = _problem(2, 30, 90, seed=4)
    f = tprox.woodbury_setup_eigh(torch.as_tensor(A), torch.as_tensor(b))
    x0 = torch.as_tensor(q)
    c = 0.5 + 1.0
    composed = (ops.rmatvec_auto(f.A, ops.matvec_auto(f.A, x0)) + c * x0)
    assert torch.equal(ops.normal_matvec_auto(f.A, x0, c), composed)


def test_direct_prox_dispatches_like_jax():
    from repro.core import losses as jlosses
    from repro_torch.core import losses as tlosses
    A, b, q, _ = _problem(2, 30, 20, seed=5)
    ta, tb, tq = (torch.as_tensor(v) for v in (A, b, q))
    ridge = tprox.ridge_setup(ta, tb, SIGMA, RHO_C)
    got = tprox.direct_prox(tlosses.get_loss("squared"), ta, tb, tq, SIGMA,
                            RHO_C, ridge)
    np.testing.assert_array_equal(
        got.numpy(), tprox.ridge_prox_factorized(ridge, tq, RHO_C).numpy())
    with pytest.raises(ValueError, match="ridge_setup"):
        tprox.direct_prox(tlosses.get_loss("squared"), ta, tb, tq, SIGMA,
                          RHO_C)
    yb = np.sign(b).astype(np.float32)
    got = tprox.direct_prox(tlosses.get_loss("logistic"), ta,
                            torch.as_tensor(yb), tq, SIGMA, RHO_C).numpy()
    for i in range(2):
        want = jprox.direct_prox(jlosses.get_loss("logistic"),
                                 jnp.asarray(A[i]), jnp.asarray(yb[i]),
                                 jnp.asarray(q[i]), SIGMA, RHO_C)
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

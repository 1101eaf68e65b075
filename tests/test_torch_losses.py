"""The port's losses and Newton-CG prox (repro_torch.core.losses / prox)
against the JAX package's (repro.core.losses / prox) on the same numpy
inputs, at float32.

Tolerances: value, grad and the closed-form proxes rtol 1e-5 / atol 1e-5
(the same elementwise f32 arithmetic in both packages); the Newton loops of
the logistic and softmax prox rtol/atol 1e-5 after their fixed 25 / 20
steps; ``newton_cg_prox`` rtol/atol 1e-4, the bound tests/test_xsolver.py
holds the JAX x-update backends to, since the CG sums reassociate. The
oracles take a leading node axis in the port and run once per node in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.core import prox as jprox
from repro_torch.core import losses, prox

NAMES = ["squared", "logistic", "hinge", "smoothed_hinge", "softmax3"]


def _inputs(name, N=2, m=37, seed=0):
    rng = np.random.default_rng(seed)
    C = 3 if name.startswith("softmax") else 1
    shape = (N, m, C) if C > 1 else (N, m)
    pred = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    q = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    if name == "squared":
        b = rng.standard_normal((N, m)).astype(np.float32)
    elif C > 1:
        b = rng.integers(0, C, (N, m))
    else:
        b = np.where(rng.random((N, m)) < 0.5, -1.0, 1.0).astype(np.float32)
    return pred, q, b


def _pair(name):
    if name.startswith("softmax"):
        return losses.get_loss("softmax", 3), jlosses.get_loss("softmax", 3)
    return losses.get_loss(name), jlosses.get_loss(name)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("name", NAMES)
def test_loss_oracles_match_jax(name):
    tl, jl = _pair(name)
    assert tl.name == jl.name and tl.n_classes == jl.n_classes
    pred, q, b = _inputs(name)
    tp, tq, tb = map(torch.as_tensor, (pred, q, b))
    for z in range(pred.shape[0]):
        jp, jq, jb = jnp.asarray(pred[z]), jnp.asarray(q[z]), jnp.asarray(b[z])
        _close(tl.value(tp[z], tb[z]), jl.value(jp, jb))
        _close(tl.grad(tp[z], tb[z]), jl.grad(jp, jb))
        _close(tl.decision(tp[z]), jl.decision(jp))
        np.testing.assert_array_equal(tl.predict(tp[z]).numpy(),
                                      np.asarray(jl.predict(jp)))
        for c in (0.25, 1.0, 4.0):      # (21)'s c = rho_l / M and others
            _close(tl.prox_omega(tq, tb, c)[z], jl.prox_omega(jq, jb, c))


@pytest.mark.parametrize("name", ["logistic", "smoothed_hinge", "softmax3"])
def test_newton_cg_prox_matches_jax(name):
    """All nodes at once in the port, one JAX call per node."""
    rng = np.random.default_rng(7)
    N, m, n = 2, 30, 20
    tl, jl = _pair(name)
    A = (rng.standard_normal((N, m, n)) / np.sqrt(m)).astype(np.float32)
    _, _, b = _inputs(name, N, m, seed=1)
    qshape = (N, n, 3) if tl.n_classes > 1 else (N, n)
    q = rng.standard_normal(qshape).astype(np.float32)
    got = prox.newton_cg_prox(tl, torch.as_tensor(A), torch.as_tensor(b),
                              torch.as_tensor(q), 0.5, 1.0, newton_iters=12)
    one = jax.jit(lambda A, b, q: jprox.newton_cg_prox(
        jl, A, b, q, 0.5, 1.0, newton_iters=12))
    for z in range(N):
        want = one(jnp.asarray(A[z]), jnp.asarray(b[z]), jnp.asarray(q[z]))
        _close(got[z], want, tol=1e-4)


def test_cg_stops_each_system_on_its_own():
    """A batch of two SPD systems, one solved in a single step: the batched
    CG freezes it and solves the other, each to the tolerance."""
    rng = np.random.default_rng(3)
    B = rng.standard_normal((6, 6)).astype(np.float32)
    H = torch.as_tensor(np.stack([np.eye(6, dtype=np.float32),
                                  B @ B.T + np.eye(6, dtype=np.float32)]))
    rhs = torch.as_tensor(rng.standard_normal((2, 6)).astype(np.float32))
    x = prox._cg(lambda p: (H @ p[..., None])[..., 0], rhs, 50)
    want = torch.linalg.solve(H, rhs)
    torch.testing.assert_close(x, want, rtol=1e-4, atol=1e-4)


def test_get_loss_names_and_errors():
    assert losses.get_loss("softmax", 4).n_classes == 4
    assert losses.get_loss("softmax3").n_classes == \
        jlosses.get_loss("softmax3").n_classes
    with pytest.raises(KeyError):
        losses.get_loss("poisson")

"""The port's ``precision="fp64_polish"`` (the (7b) projection's polish in
f64) against the JAX package's, on the CPU, same numpy data.

The JAX package needs its x64 mode for the polish (tests/conftest.py turns
it off), so its side runs under ``jax.enable_x64(True)`` on float32 inputs;
under it the JAX solver state keeps its float32 leaves (only the iteration
counter widens to int64), so both packages run the documented semantics.

* The projection: the port's composed path and the kernels' plain versions
  (solo and lanes) against ``repro.core.bilinear.project_l1_epigraph(
  polish_dtype=float64)``: z, t and theta within rtol 1e-6 (atol 1e-6 x
  max |z0|), the f64 fixpoint rounded to f32 once on both sides; the
  polish's KKT residual |sum soft(z0, theta) - (t0 + theta)|, formed in
  f64, no larger than the f32 polish's.
* Fits through ``api.solve``, the estimators and ``fit_many`` (lanes):
  ROADMAP's solver parity, the same status and support, coef within 1e-3,
  iterations within 2.
* ``runtime.escalation_ladder`` is JAX's with x64 on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import runtime as jruntime
from repro.core import bilinear as jbilinear
from repro_torch import api, runtime
from repro_torch.core import BiCADMMConfig, bilinear
from repro_torch.data import SyntheticSpec, make_sparse_regression
from repro_torch.kernels import ref

SPEC = SyntheticSpec(2, 30, 40, sparsity_level=0.75, noise=1e-3)
KW = dict(tol=1e-4, zt_iters=20, max_iter=300)   # SolverOptions
GAMMA = 10.0


def _vectors(seed, n=40, lanes=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if lanes is None else (lanes, n)
    z = rng.standard_normal(shape).astype(np.float32)
    t0 = (0.5 * np.abs(z).sum(-1)).astype(np.float32)
    return z, t0


def _jax_proj(z, t0, rounds):
    with jax.enable_x64(True):
        zj, tj = jbilinear.project_l1_epigraph(
            jnp.asarray(z), jnp.asarray(t0), rounds=rounds,
            polish_dtype="float64")
        return np.asarray(zj), np.asarray(tj)


def _kkt_residual(z0, t0, z, t):
    """|sum |z| - t| of a projection (z, t) of (z0, t0) outside the inside
    and apex cases, in f64 (the active constraint of the KKT system)."""
    return abs(float(np.abs(np.asarray(z, np.float64)).sum())
               - float(np.float64(t)))


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 7), (2, 300)])
def test_composed_projection_matches_jax(seed, n):
    z, t0 = _vectors(seed, n)
    jz, jt = _jax_proj(z, t0, rounds=0)
    pz, pt = bilinear.project_l1_epigraph(torch.as_tensor(z),
                                          torch.as_tensor(t0),
                                          polish_dtype=torch.float64)
    scale = float(np.abs(z).max())
    np.testing.assert_allclose(pz.numpy(), jz, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-6)
    assert pz.dtype == torch.float32
    f32z, f32t = bilinear.project_l1_epigraph(torch.as_tensor(z),
                                              torch.as_tensor(t0))
    assert (_kkt_residual(z, t0, pz, pt)
            <= _kkt_residual(z, t0, f32z, f32t) + 1e-12)


@pytest.mark.parametrize("rounds", [0, 2])
def test_plain_versions_of_the_polish_kernels_match_jax(rounds):
    """``ref.l1_epigraph_proj_ref`` / ``_lanes_ref`` with ``polish64`` (the
    f64-polish instantiations' plain versions): per row, JAX's projection
    at the same bracketing rounds; theta is the f64 fixpoint rounded once."""
    z, t0 = _vectors(3, n=50, lanes=4)
    zl, tl, thl, kl = ref.l1_epigraph_proj_lanes_ref(
        torch.as_tensor(z), torch.as_tensor(t0), rounds=rounds, stats=True,
        polish64=True)
    for b in range(4):
        jz, jt = _jax_proj(z[b], t0[b], rounds=rounds)
        np.testing.assert_allclose(zl[b].numpy(), jz, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(z[b]).max()))
        np.testing.assert_allclose(float(tl[b]), float(jt), rtol=1e-6)
        solo = ref.l1_epigraph_proj_ref(torch.as_tensor(z[b]),
                                        torch.as_tensor(t0[b]),
                                        rounds=rounds, stats=True,
                                        polish64=True)
        assert torch.equal(solo[0], zl[b]) and solo[3] == int(kl[b])
        assert thl.dtype == torch.float32


def test_lane_composed_path_equals_the_solo_one():
    z, t0 = _vectors(4, n=30, lanes=5)
    zl, tl = bilinear.project_l1_epigraph(torch.as_tensor(z),
                                          torch.as_tensor(t0),
                                          polish_dtype="float64")
    for b in range(5):
        zs, ts = bilinear.project_l1_epigraph(torch.as_tensor(z[b]),
                                              torch.as_tensor(t0[b]),
                                              polish_dtype="float64")
        assert torch.equal(zs, zl[b]) and torch.equal(ts, tl[b])
    with pytest.raises(ValueError, match="float64"):
        bilinear.project_l1_epigraph(torch.as_tensor(z[0]),
                                     torch.as_tensor(t0[0]),
                                     polish_dtype=torch.float16)


def test_escalation_ladder_is_the_jax_ladder_with_x64_on():
    with jax.enable_x64(True):
        for name in ("bf16", "fp16", "fp32", "fp64_polish"):
            assert runtime.escalation_ladder(name) == \
                jruntime.escalation_ladder(name)
    assert runtime.escalation_ladder("fp32") == ["fp64_polish"]
    assert runtime.escalation_ladder("bf16") == ["fp32", "fp64_polish"]
    assert runtime.escalation_ladder("fp64_polish") == []
    assert BiCADMMConfig(kappa=3, precision="fp64_polish").precision \
        .kkt_polish == "float64"
    with pytest.raises(runtime.CapabilityError):
        BiCADMMConfig(kappa=3, precision="bf16", n_feature_blocks=2)


def _data():
    As, bs, _ = make_sparse_regression(3, SPEC)
    return As, bs


@pytest.fixture(scope="module")
def jax_fits():
    """The JAX package's fp64_polish fits, once for the module: solve
    (dense and Woodbury) and fit_many over 3 lanes."""
    As, bs = _data()
    out = {}
    with jax.enable_x64(True):
        for x_solver in ("dense", "woodbury"):
            opts = japi.SolverOptions(precision="fp64_polish",
                                      x_solver=x_solver, **KW)
            out[x_solver] = japi.solve(
                japi.SparseProblem("squared", kappa=SPEC.kappa,
                                   gamma=GAMMA),
                jnp.asarray(As), jnp.asarray(bs), options=opts)
        Xs = np.stack([As[0], As[1], As[0][::-1].copy()])
        ys = np.stack([bs[0], bs[1], bs[0][::-1].copy()])
        out["fleet"] = japi.fit_many(
            japi.SparseProblem("squared", kappa=SPEC.kappa,
                               gamma=GAMMA),
            jnp.asarray(Xs), jnp.asarray(ys), kappas=[8, 6, 10],
            options=japi.SolverOptions(precision="fp64_polish", **KW))
        out["fleet_data"] = (Xs, ys)
    return out


def _assert_same(port, jres):
    assert int(port.status) == int(jres.status)
    np.testing.assert_array_equal(port.support.numpy(),
                                  np.asarray(jres.support))
    np.testing.assert_allclose(port.coef.numpy(), np.asarray(jres.coef),
                               rtol=1e-3, atol=1e-3)
    assert abs(int(port.iters) - int(jres.iters)) <= 2


@pytest.mark.parametrize("x_solver", ["dense", "woodbury"])
def test_solve_and_estimator_fits_match_jax(jax_fits, x_solver):
    As, bs = _data()
    opts = api.SolverOptions(precision="fp64_polish", x_solver=x_solver,
                             device="cpu", **KW)
    prob = api.SparseProblem("squared", kappa=SPEC.kappa, gamma=GAMMA)
    res = api.solve(prob, As, bs, options=opts)
    _assert_same(res, jax_fits[x_solver])
    est = api.SparseLinearRegression(kappa=SPEC.kappa, gamma=GAMMA,
                                     options=opts).fit(As, bs)
    assert torch.equal(est.result_.coef, res.coef)
    assert est.result_.state.z.dtype == torch.float32


def test_fit_many_lanes_match_jax(jax_fits):
    Xs, ys = jax_fits["fleet_data"]
    fleet = api.fit_many(
        api.SparseProblem("squared", kappa=SPEC.kappa, gamma=GAMMA),
        Xs, ys, kappas=[8, 6, 10],
        options=api.SolverOptions(precision="fp64_polish", device="cpu",
                                  **KW))
    jfleet = jax_fits["fleet"]
    for i in range(3):
        _assert_same(fleet[i], jfleet[i])

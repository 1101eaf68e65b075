"""Divergence detection, fault injection and the recovery ladder of the port
(repro_torch.faults, repro_torch.core.recovery, the api's ``recover`` and
``SolverOptions(recovery=)``) against the JAX package's, on the CPU, same
numpy data. The engine-level cases of tests/test_faults.py, mirrored.

* A fault injected at iteration k ends the solve DIVERGED after the same
  number of iterations as in JAX (within 2), solo and on a fleet lane.
* The same injected fault gives the same ``FitResult.recovery`` log in
  both packages: stage, detail and status per rung, iterations within 2,
  through ``solve(recovery=)``, ``recover`` and the estimator's ``fit``;
  the final result's status and support agree and coef is within 1e-3.
  Where the ladder reaches its precision rungs the JAX side runs under
  ``jax.enable_x64(True)``: the port's ladder always offers fp64_polish
  (torch has f64), which the JAX ladder offers only with x64 on.
* Honesty on hostile inputs, the degenerate ladder roots and the pure
  units (status codes, the probe, the policy, the hooks) on the port.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import faults as jfaults
from repro.core.recovery import RecoveryPolicy as JaxPolicy
from repro.core.results import classify_status as jclassify
from repro.core.results import mark_aborted as jmark_aborted
from repro_torch import api, convert, faults
from repro_torch.core import SolveStatus, bilinear, recovery
from repro_torch.core.results import (classify_status, divergence_probe,
                                      mark_aborted)

PROBLEM = dict(loss="squared", kappa=3, gamma=5.0)
OPTS = dict(max_iter=300, tol=1e-3, zt_iters=20)
DIVERGED = int(SolveStatus.DIVERGED)
CONVERGED = int(SolveStatus.CONVERGED)


def _data(seed, n=10, m=24, kappa=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n)).astype(np.float32)
    w = np.zeros(n)
    w[rng.choice(n, kappa, replace=False)] = 1.0 + rng.random(kappa)
    y = (X @ w + 0.01 * rng.standard_normal(m)).astype(np.float32)
    return X, y


def _pair(problem=None, **opts):
    """(port problem, port options on the CPU, JAX problem, JAX options)."""
    problem = dict(PROBLEM, **(problem or {}))
    popts = dict(OPTS, **opts)
    jopts = dict(popts)
    if popts.get("recovery") is not None:
        jopts["recovery"] = JaxPolicy(**dataclasses.asdict(popts["recovery"]))
    return (api.SparseProblem(**problem),
            api.SolverOptions(device="cpu", **popts),
            japi.SparseProblem(**problem), japi.SolverOptions(**jopts))


def _assert_like_jax(res, jres):
    assert int(res.status) == int(jres.status)
    assert abs(int(res.iters) - int(jres.iters)) <= 2
    if int(res.status) != DIVERGED:
        np.testing.assert_array_equal(res.support.numpy(),
                                      np.asarray(jres.support))
        np.testing.assert_allclose(res.coef.numpy(), np.asarray(jres.coef),
                                   rtol=1e-3, atol=1e-3)
    if jres.recovery is None:
        assert res.recovery is None
        return
    log, jlog = res.recovery, convert.recovery_from_numpy(
        convert.recovery_to_numpy(jres.recovery))
    assert [(a.stage, a.detail, a.status) for a in log] == \
        [(a.stage, a.detail, a.status) for a in jlog]
    assert all(abs(a.iters - b.iters) <= 2 for a, b in zip(log, jlog))


# --------------------------------------------------------------------------
# status classification and the probe: pure units
# --------------------------------------------------------------------------
def test_classify_and_mark_aborted_units():
    cases = [(40, 1e-4, 1e-4, 1e-4), (300, 1.0, 1e-4, 1e-4),
             (5, float("nan"), 1e-4, 1e-4), (7, 1e13, 1e-4, 1e-4)]
    for k, p, d, b in cases:
        got = classify_status(torch.tensor(k), torch.tensor(p),
                              torch.tensor(d), torch.tensor(b), tol=1e-3,
                              divergence_tol=1e12)
        want = jclassify(jnp.int32(k), jnp.float32(p), jnp.float32(d),
                         jnp.float32(b), tol=1e-3, divergence_tol=1e12)
        assert int(got) == int(want)
    status = mark_aborted(torch.tensor([1, 1, 0], dtype=torch.int32),
                          torch.tensor([0, 3, 50]),
                          torch.tensor([0, 3, 500]), 300)
    want = jmark_aborted(jnp.asarray([1, 1, 0], jnp.int32),
                         jnp.asarray([0, 3, 50]), jnp.asarray([0, 3, 500]),
                         300)
    assert status.tolist() == np.asarray(want).tolist() == [
        int(SolveStatus.ABORTED), int(SolveStatus.ABORTED), CONVERGED]


def test_divergence_probe_ignores_the_inf_init():
    class St:
        k = torch.tensor(0)
        p_r = torch.tensor(float("inf"))
        d_r = torch.tensor(float("inf"))
        b_r = torch.tensor(float("inf"))
    assert not bool(divergence_probe(St, 1e12))
    St.k = torch.tensor(1)
    assert bool(divergence_probe(St, 1e12))


def test_divergence_tol_must_be_positive_and_policy_validates():
    with pytest.raises(ValueError):
        api.SolverOptions(divergence_tol=0.0)
    with pytest.raises(ValueError):
        api.RecoveryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        api.RecoveryPolicy(rho_scale=1.0)
    with pytest.raises(ValueError):
        api.RecoveryPolicy(backoff_s=-1.0)
    with pytest.raises(TypeError):
        api.SolverOptions(recovery="a policy")


# --------------------------------------------------------------------------
# in-loop detection
# --------------------------------------------------------------------------
def test_healthy_solve_is_converged_and_unrecovered():
    X, y = _data(0)
    prob, opts, jprob, jopts = _pair()
    res = api.solve(prob, X, y, options=opts)
    jres = japi.solve(jprob, X, y, options=jopts)
    assert res.status_name == "CONVERGED" and res.converged
    _assert_like_jax(res, jres)


HOOKS = {"nan_x": (faults.nan_x(3), jfaults.nan_x(3)),
         "inf_x": (faults.inf_x(3), jfaults.inf_x(3)),
         "scale_dual": (faults.scale_dual(2, scale=1e30),
                        jfaults.scale_dual(2, scale=1e30))}


@pytest.mark.parametrize("which", sorted(HOOKS))
def test_injected_fault_exits_the_loop_like_jax(which):
    """The probe aborts within a few iterations, not a crawl to max_iter,
    after as many iterations as in JAX."""
    X, y = _data(0)
    prob, opts, jprob, jopts = _pair()
    hook, jhook = HOOKS[which]
    with faults.inject(hook) as inj:
        res = api.solve(prob, X, y, options=opts)
    with jfaults.inject(jhook):
        jres = japi.solve(jprob, X, y, options=jopts)
    assert len(inj.hooked) == 1
    assert int(res.status) == DIVERGED and int(res.iters) < 10
    _assert_like_jax(res, jres)


def test_fleet_lane_fault_stays_in_its_lane():
    rng = np.random.default_rng(5)
    Xs = rng.standard_normal((3, 24, 10)).astype(np.float32)
    w = np.zeros(10, np.float32)
    w[:3] = 1.5
    ys = (Xs @ w).astype(np.float32)
    prob, opts, jprob, jopts = _pair()
    with faults.inject(faults.nan_x(3, lane=1)):
        fleet = api.fit_many(prob, Xs, ys, options=opts)
    with jfaults.inject(jfaults.nan_x(3, lane=1)):
        jfleet = japi.fit_many(jprob, Xs, ys, options=jopts)
    assert fleet.status.tolist() == [CONVERGED, DIVERGED, CONVERGED]
    for i in range(3):
        _assert_like_jax(fleet[i], jfleet[i])


# --------------------------------------------------------------------------
# the recovery ladder, rung by rung, each the genuine fix
# --------------------------------------------------------------------------
def test_ladder_retry_rung_recovers_a_one_shot_fault():
    X, y = _data(1)
    prob, opts, jprob, jopts = _pair(recovery=api.RecoveryPolicy())
    with faults.inject(faults.nan_x(3), limit=1):
        res = api.solve(prob, X, y, options=opts)
    with jfaults.inject(jfaults.nan_x(3), limit=1):
        jres = japi.solve(jprob, X, y, options=jopts)
    (attempt,) = res.recovery
    assert attempt.stage == "retry" and attempt.status == CONVERGED
    _assert_like_jax(res, jres)


def test_rho_restart_rung_is_the_genuine_fix():
    """Fault keyed on rho_c < 5: the first solve and the retry are
    poisoned, the rho-restarted solver (rho_c 10) is not."""
    X, y = _data(1)
    prob, opts, jprob, jopts = _pair(
        problem=dict(rho_c=1.0),
        recovery=api.RecoveryPolicy(rho_scale=10.0))
    with faults.inject(faults.nan_x(2),
                       where=lambda s: float(s.cfg.rho_c) < 5.0):
        res = api.solve(prob, X, y, options=opts)
    with jfaults.inject(jfaults.nan_x(2),
                        where=lambda s: float(s.cfg.rho_c) < 5.0):
        jres = japi.solve(jprob, X, y, options=jopts)
    assert [a.stage for a in res.recovery] == ["retry", "rho_restart"]
    assert res.recovery[0].status == DIVERGED
    assert res.recovery[1].detail == "rho_c=10"
    _assert_like_jax(res, jres)


def test_precision_rung_is_the_genuine_fix():
    """bf16 data, the fault keyed on it: retry and rho restart stay bf16
    and fail; the fp32 rung escapes. The JAX side under x64, where its
    ladder offers the same rungs as the port's."""
    X, y = _data(2)
    prob, opts, jprob, jopts = _pair(precision="bf16",
                                     recovery=api.RecoveryPolicy())
    where = (lambda s: s.cfg.precision.data == "bfloat16")
    with faults.inject(faults.nan_x(2), where=where):
        res = api.solve(prob, X, y, options=opts)
    with jax.enable_x64(True), jfaults.inject(jfaults.nan_x(2), where=where):
        jres = japi.solve(jprob, X, y, options=jopts)
    assert [(a.stage, a.detail) for a in res.recovery] == [
        ("retry", "same configuration"), ("rho_restart", "rho_c=10"),
        ("precision", "fp32")]
    _assert_like_jax(res, jres)


def test_x_solver_rung_is_the_genuine_fix_after_the_fp64_polish():
    """PCG poisoned: retry, rho restart and the fp64 polish (still PCG)
    fail; the fallback to the dense factorization escapes."""
    X, y = _data(3)
    prob, opts, jprob, jopts = _pair(x_solver="pcg",
                                     recovery=api.RecoveryPolicy())
    where = (lambda s: s.cfg.x_solver == "pcg")
    with faults.inject(faults.nan_x(2), where=where):
        res = api.solve(prob, X, y, options=opts)
    with jax.enable_x64(True), jfaults.inject(jfaults.nan_x(2), where=where):
        jres = japi.solve(jprob, X, y, options=jopts)
    assert [(a.stage, a.detail) for a in res.recovery] == [
        ("retry", "same configuration"), ("rho_restart", "rho_c=10"),
        ("precision", "fp64_polish"), ("x_solver", "dense")]
    assert res.recovery[-1].status == CONVERGED
    _assert_like_jax(res, jres)


def test_ladder_exhaustion_stays_diverged_with_full_log():
    X, y = _data(1)
    prob, opts, jprob, jopts = _pair(
        recovery=api.RecoveryPolicy(max_attempts=2))
    with faults.inject(faults.nan_x(2)):
        res = api.solve(prob, X, y, options=opts)
    with jfaults.inject(jfaults.nan_x(2)):
        jres = japi.solve(jprob, X, y, options=jopts)
    assert int(res.status) == DIVERGED and len(res.recovery) == 2
    assert all(a.status == DIVERGED for a in res.recovery)
    _assert_like_jax(res, jres)


def test_public_recover_entry_point_and_estimator_fit():
    X, y = _data(1)
    prob, opts, jprob, jopts = _pair()
    with faults.inject(faults.nan_x(3), limit=1):
        failed = api.solve(prob, X, y, options=opts)
        assert int(failed.status) == DIVERGED
        res = api.recover(prob, X, y, options=opts, failed=failed)
    with jfaults.inject(jfaults.nan_x(3), limit=1):
        jfailed = japi.solve(jprob, X, y, options=jopts)
        jres = japi.recover(jprob, X, y, options=jopts, failed=jfailed)
    assert int(res.status) == CONVERGED and len(res.recovery) == 1
    _assert_like_jax(res, jres)
    # the port's estimator builds its solver when it is made, the JAX one
    # at its first fit: each inside the injection
    with faults.inject(faults.nan_x(3), limit=1):
        est = api.SparseLinearRegression(
            kappa=3, gamma=5.0, device="cpu", recovery=api.RecoveryPolicy(),
            **OPTS).fit(X, y)
    with jfaults.inject(jfaults.nan_x(3), limit=1):
        jest = japi.SparseLinearRegression(
            kappa=3, gamma=5.0, recovery=JaxPolicy(), **OPTS).fit(X, y)
    assert [a.stage for a in est.result_.recovery] == ["retry"]
    _assert_like_jax(est.result_, jest.result_)


# --------------------------------------------------------------------------
# honesty on hostile inputs; boundaries
# --------------------------------------------------------------------------
def test_solve_rejects_bad_data_up_front():
    X, y = _data(2)
    prob = api.SparseProblem(**PROBLEM)
    opts = api.SolverOptions(device="cpu")
    bad = np.array(X)
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        api.solve(prob, bad, y, options=opts)
    with pytest.raises(ValueError, match="non-finite"):
        api.solve(prob, X, np.where(np.arange(len(y)) == 0, np.inf, y),
                  options=opts)
    with pytest.raises(ValueError, match="targets"):
        api.solve(prob, X, y[:-3], options=opts)
    with pytest.raises(ValueError, match="empty"):
        api.solve(prob, X[:0], y[:0], options=opts)
    with pytest.raises(ValueError, match="non-finite"):
        api.SparseLinearRegression(kappa=3, device="cpu").fit(bad, y)


def _assert_honest(res):
    assert res.status is not None
    if int(res.status) == CONVERGED:
        assert bool(torch.isfinite(res.coef).all()), \
            "CONVERGED with non-finite coefficients"


@pytest.mark.parametrize("case", ["zero_variance", "kappa_ge_n",
                                  "denormal", "huge_scale"])
def test_extreme_inputs_never_lie(case):
    X, y = _data(13)
    kappa = 3
    if case == "zero_variance":
        X[:, 0] = 1.0
    elif case == "kappa_ge_n":
        kappa = X.shape[1]
    elif case == "denormal":
        X, y = (X * 1e-38).astype(np.float32), (y * 1e-38).astype(np.float32)
    else:
        X, y = (X * 1e18).astype(np.float32), (y * 1e18).astype(np.float32)
    res = api.solve(api.SparseProblem("squared", kappa=kappa, gamma=5.0),
                    X, y, options=api.SolverOptions(device="cpu",
                                                     max_iter=100, tol=1e-3,
                                                     zt_iters=20))
    _assert_honest(res)


@pytest.mark.parametrize("polish_dtype", [None, torch.float64])
def test_ladder_refine_degenerate_inputs_stay_finite(polish_dtype):
    for az in (np.zeros(8), np.full(8, 1e-38), np.full(8, 1e18),
               np.array([0.0] * 7 + [1.0])):
        theta = bilinear.ladder_refine(torch.tensor(az, dtype=torch.float32),
                                       torch.tensor(0.5),
                                       polish_dtype=polish_dtype)
        assert bool(torch.isfinite(theta)) and theta.dtype == torch.float32


@pytest.mark.parametrize("seed,scale", [(3, "unit"), (17, "denormal"),
                                        (29, "large"), (101, "unit")])
def test_solve_status_is_honest(seed, scale):
    X, y = _data(seed)
    factor = {"unit": 1.0, "denormal": 1e-38, "large": 1e12}[scale]
    res = api.solve(api.SparseProblem(**PROBLEM),
                    (X * factor).astype(np.float32),
                    (y * factor).astype(np.float32),
                    options=api.SolverOptions(device="cpu", max_iter=60,
                                              tol=1e-3, zt_iters=20))
    _assert_honest(res)


# --------------------------------------------------------------------------
# the harness itself
# --------------------------------------------------------------------------
def test_inject_where_limit_and_nesting():
    cfg = type("Cfg", (), {"rho_c": 1.0})
    solvers = [type("S", (), {"cfg": cfg})() for _ in range(3)]
    assert faults.active_hook(solvers[0]) is None
    outer, inner = faults.nan_x(1), faults.inf_x(1)
    with faults.inject(outer, limit=2) as o:
        with faults.inject(inner, where=lambda s: s is solvers[0]) as i:
            assert faults.active_hook(solvers[0]) is inner
            assert faults.active_hook(solvers[1]) is outer
        assert faults.active_hook(solvers[2]) is outer
        assert faults.active_hook(solvers[0]) is None      # limit reached
    assert o.hooked == solvers[1:] and i.hooked == solvers[:1]
    assert faults.active_hook(solvers[1]) is None


def test_hooks_poison_only_their_iteration_and_lane():
    from repro_torch.core import BiCADMMState
    z = torch.ones(3, 4)
    st = BiCADMMState(torch.ones(3, 2, 4), torch.ones(3, 2, 4), z, z[:, 0],
                      z, z[:, 0], torch.tensor([2, 2, 1], dtype=torch.int32),
                      z[:, 0], z[:, 0], z[:, 0])
    out = faults.nan_x(2, lane=1)(st)
    assert torch.isnan(out.x[1]).all() and torch.isnan(out.z[1]).all()
    assert torch.isfinite(out.x[[0, 2]]).all()
    out = faults.scale_dual(2, scale=10.0)(st)
    assert out.u[:2].eq(10.0).all() and out.u[2].eq(1.0).all()
    clean = recovery.sanitize_state(faults.inf_x(2)(st))
    assert torch.isfinite(clean.x).all() and clean.x[0].eq(0).all()
    assert torch.equal(clean.k, st.k)


def test_failing_and_deadline_storm():
    class Box:
        def ping(self):
            return "pong"

    box = Box()
    with faults.failing(box, "ping", RuntimeError("boom"), times=2):
        for _ in range(2):
            with pytest.raises(RuntimeError, match="boom"):
                box.ping()
        assert box.ping() == "pong"
    assert box.ping() == "pong"

    class Service:
        async def submit_fit(self, X, y, *, deadline):
            if deadline < 1e-3:
                raise TimeoutError("deadline")
            return "fit"

    out = asyncio.run(faults.deadline_storm(Service(), None, None, count=4))
    assert len(out) == 4 and all(isinstance(o, TimeoutError) for o in out)


def test_recovery_log_round_trips_through_numpy():
    log = (recovery.RecoveryAttempt("retry", "same configuration", 2, 3),
           recovery.RecoveryAttempt("rho_restart", "rho_c=10", 0, 41))
    arr = convert.recovery_to_numpy(log)
    assert arr.dtype.names == ("stage", "detail", "status", "iters")
    assert convert.recovery_from_numpy(arr) == log

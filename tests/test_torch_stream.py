"""The port's streaming subsystem (repro_torch.stream: the Cholesky
primitives, repro_torch.core.streaming, ``api.stream`` and the estimators'
``partial_fit``) against the JAX package's (repro.stream), on the CPU, same
numpy chunks. All of tests/test_stream.py, mirrored.

Tolerances:

* The primitives: the port's factor within rtol / atol 1e-4 of a numpy
  Cholesky of the updated matrix (1e-3 for the downdate, as the JAX
  test), and within 1e-5 of the JAX primitive's; a downdate that loses
  positive definiteness says so in both (``ok`` False).
* Streams, chunk by chunk against a JAX stream over the same chunks: the
  same regime, SolveStatus and support, coef within 1e-3, iterations
  within 2 (ROADMAP's solver parity); the maintained factor (and Gram)
  within rtol / atol 1e-4 of the JAX stream's.
* The JAX test's own contracts on the port: a stream lands on the batch
  fit over the window (the same support, coef within 1e-3: the fits run
  at tol 1e-3, where the JAX test runs at 1e-5 and 5e-5) and the
  maintained factor equals a recomputed Cholesky (2e-3, as there).

The fits run 20 FISTA steps at rho_c 4 and tol 1e-3 in both packages (the
JAX test: 120 at rho_c 1 and 1e-5), to bound the CPU time; the polished
coef depends on the support alone, so the batch contract holds at 1e-3. Each JAX stream is run
once for the module.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro import faults as jfaults
from repro.core import BiCADMMConfig as JaxConfig
from repro.core import prox as jprox
from repro.core.recovery import RecoveryPolicy as JaxPolicy
from repro.core.streaming import StreamingBiCADMM as JaxStream
from repro.stream import chol_append as jchol_append
from repro.stream import chol_downdate as jchol_downdate
from repro.stream import chol_update as jchol_update
from repro_torch import api, convert, faults
from repro_torch.core import BiCADMM, BiCADMMConfig, SolveDiverged, prox
from repro_torch.core.results import SolveStatus
from repro_torch.data import SyntheticSpec, make_sparse_classification
from repro_torch.stream import (StreamingBiCADMM, chol_append, chol_downdate,
                                chol_update, stream)

CONVERGED = int(SolveStatus.CONVERGED)
DIVERGED = int(SolveStatus.DIVERGED)
CFG = dict(gamma=10.0, rho_c=4.0, alpha=0.5, max_iter=200, tol=1e-3,
           zt_iters=20)


def _chunks(seed, n=16, kappa=4, T=4, m=12, noise=0.01):
    """T row chunks from one planted-sparse linear model."""
    rng = np.random.default_rng(seed)
    w = np.zeros(n, np.float32)
    idx = rng.choice(n, kappa, replace=False)
    w[idx] = (2.0 + rng.random(kappa)).astype(np.float32)
    out = []
    for _ in range(T):
        X = rng.standard_normal((m, n)).astype(np.float32)
        y = (X @ w + noise * rng.standard_normal(m)).astype(np.float32)
        out.append((X, y))
    return out, w


def _cfg(kappa=4, **kw):
    return BiCADMMConfig(kappa=kappa, **{**CFG, **kw})


def _jcfg(kappa=4, **kw):
    return JaxConfig(kappa=kappa, **{**CFG, **kw})


def _spd(rng, n, scale=1.0):
    A = rng.standard_normal((n + 4, n)).astype(np.float32) * scale
    return A.T @ A + np.eye(n, dtype=np.float32)


def _batch_fit(cfg, chunks):
    X = np.concatenate([c[0] for c in chunks])
    y = np.concatenate([c[1] for c in chunks])
    return BiCADMM("squared", cfg).fit(torch.as_tensor(X)[None],
                                       torch.as_tensor(y)[None])


def _factor(acc):
    return np.asarray(acc.L) if hasattr(acc, "L") else np.asarray(acc.colsq)


def _record(eng, res):
    return dict(mode=eng.mode, status=int(res.status), iters=int(res.iters),
                support=np.asarray(res.support),
                coef=np.asarray(res.coef, np.float32).ravel(),
                factor=None if eng._acc is None else np.array(
                    _factor(eng._acc)),
                recovery=res.recovery)


# every JAX stream of the module, run once: (key) -> per-chunk records
@functools.lru_cache(maxsize=None)
def _jax_stream(key):
    seed, shape, window, cfg_kw, overrides = key
    chunks, _ = _chunks(seed, **dict(shape))
    eng = JaxStream("squared", _jcfg(**dict(cfg_kw)), window=window)
    out = []
    for t, (X, y) in enumerate(chunks):
        over = dict(overrides) if t == len(chunks) - 1 else {}
        out.append(_record(eng, eng.partial_fit(X, y, **over)))
    return out, eng


def _port_stream(key):
    seed, shape, window, cfg_kw, overrides = key
    chunks, _ = _chunks(seed, **dict(shape))
    eng = StreamingBiCADMM("squared", _cfg(**dict(cfg_kw)), window=window,
                           device="cpu")
    out = []
    for t, (X, y) in enumerate(chunks):
        over = dict(overrides) if t == len(chunks) - 1 else {}
        out.append(_record(eng, eng.partial_fit(X, y, **over)))
    return out, eng, chunks


def _assert_chunk(got, want, factor_tol=1e-4):
    assert got["mode"] == want["mode"]
    assert got["status"] == want["status"]
    np.testing.assert_array_equal(got["support"], want["support"])
    np.testing.assert_allclose(got["coef"], want["coef"], rtol=1e-3,
                               atol=1e-3)
    assert abs(got["iters"] - want["iters"]) <= 2
    if want["factor"] is not None:
        np.testing.assert_allclose(got["factor"], want["factor"],
                                   rtol=factor_tol, atol=factor_tol)


def _key(seed, shape=(), window=None, cfg=(), overrides=()):
    return (seed, tuple(sorted(dict(shape).items())), window,
            tuple(sorted(dict(cfg).items())),
            tuple(sorted(dict(overrides).items())))


# --------------------------------------------------------------------------
# the Cholesky primitives: parity with recomputed factors and with JAX
# --------------------------------------------------------------------------
def test_chol_update_matches_recomputed_factor_and_jax():
    rng = np.random.default_rng(0)
    M = _spd(rng, 12)
    V = rng.standard_normal((12, 3)).astype(np.float32)
    L = np.linalg.cholesky(M)
    got = chol_update(torch.as_tensor(L), torch.as_tensor(V)).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(M + V @ V.T),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jchol_update(jnp.asarray(L), jnp.asarray(V))),
        atol=1e-5, rtol=1e-5)


def test_chol_downdate_matches_and_flags_lost_pd():
    rng = np.random.default_rng(1)
    base = _spd(rng, 10)
    V = rng.standard_normal((10, 2)).astype(np.float32)
    L = np.linalg.cholesky(base + V @ V.T)
    got, ok = chol_downdate(torch.as_tensor(L), torch.as_tensor(V))
    jgot, jok = jchol_downdate(jnp.asarray(L), jnp.asarray(V))
    assert bool(ok) and bool(jok) and ok.dtype == torch.bool
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(base),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5,
                               rtol=1e-5)
    Lb = np.linalg.cholesky(base)
    _, ok_bad = chol_downdate(torch.as_tensor(Lb), torch.as_tensor(10 * V))
    _, jok_bad = jchol_downdate(jnp.asarray(Lb), jnp.asarray(10 * V))
    assert not bool(ok_bad) and not bool(jok_bad)


def test_chol_append_matches_bordered_factor():
    rng = np.random.default_rng(2)
    n1, n2 = 9, 4
    M = _spd(rng, n1 + n2)
    L11 = np.linalg.cholesky(M[:n1, :n1])
    args = (L11, M[:n1, n1:], M[n1:, n1:])
    got = chol_append(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(M), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jchol_append(
        *map(jnp.asarray, args))), atol=1e-5, rtol=1e-5)


def test_rank1_vector_update_shape():
    rng = np.random.default_rng(3)
    M = _spd(rng, 6)
    v = rng.standard_normal(6).astype(np.float32)
    got = chol_update(torch.as_tensor(np.linalg.cholesky(M)),
                      torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.linalg.cholesky(M + np.outer(v, v)),
                               atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# streams, chunk by chunk against JAX, and against the batch fit
# --------------------------------------------------------------------------
# (the dense regime with no window runs in test_api_stream_equals_api_solve_
# and_the_jax_stream, the dense sliding window in
# test_maintained_factor_equals_recomputed_cholesky)
STREAMS = {
    "dense_window0": _key(10, dict(T=3), window=0),
    "woodbury_sliding": _key(11, dict(n=40, m=30, T=3), window=2,
                             cfg=dict(x_solver="woodbury")),
    "pcg": _key(11, dict(n=40, m=30, T=2), cfg=dict(x_solver="pcg")),
    "dynamic_penalty": _key(14, dict(T=3),
                            overrides=dict(gamma=25.0, rho_c=2.0)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_jax_chunk_by_chunk_and_the_batch_fit(name):
    key = STREAMS[name]
    got, eng, chunks = _port_stream(key)
    want, jeng = _jax_stream(key)
    for g, w in zip(got, want):
        _assert_chunk(g, w)
    assert eng.m_seen == jeng.m_seen and eng.m_window == jeng.m_window
    window = key[2]
    if window == 0:
        assert eng._chunks == []           # truly no replay rows
    kept = chunks if window in (None, 0) else chunks[-window:]
    cfg = dict(key[3])
    cfg.update(dict(key[4]))
    batch = _batch_fit(_cfg(**cfg), kept)
    res = eng.result
    np.testing.assert_array_equal(res.support.numpy(), batch.support.numpy())
    np.testing.assert_allclose(res.coef.numpy().ravel(), batch.x.numpy(),
                               atol=1e-3)


def test_maintained_factor_equals_recomputed_cholesky():
    """After a mixed absorb / evict history the dense factor is still
    chol(G_window + c I) to factor-recompute parity (and the JAX
    stream's factor to 1e-4); the fit is the batch fit on the window."""
    key = _key(13, dict(n=16, m=12, T=3), window=2)
    got, eng, chunks = _port_stream(key)
    want, jeng = _jax_stream(key)
    A = np.concatenate([c[0].numpy() for c in eng._chunks])
    G = A.T @ A
    ref = np.linalg.cholesky(G + eng._c * np.eye(A.shape[1], dtype=G.dtype))
    np.testing.assert_allclose(eng._acc.L.numpy(), ref, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(eng._acc.G.numpy(), G, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(eng._acc.G.numpy(), np.asarray(jeng._acc.G),
                               atol=1e-4, rtol=1e-4)
    for g, w in zip(got, want):
        _assert_chunk(g, w)
    assert eng.m_window == 24
    batch = _batch_fit(_cfg(), chunks[-2:])
    np.testing.assert_array_equal(eng.result.support.numpy(),
                                  batch.support.numpy())
    np.testing.assert_allclose(eng.result.coef.numpy().ravel(),
                               batch.x.numpy(), atol=1e-3)


def test_regime_transition_woodbury_to_pcg(monkeypatch):
    """Growth past the woodbury bound rebuilds the new regime's
    accumulators from the window, in both packages alike."""
    for mod in (prox, jprox):
        monkeypatch.setattr(mod, "DENSE_MAX_N", 4)
        monkeypatch.setattr(mod, "WOODBURY_MAX_M", 20)
    chunks, _ = _chunks(15, n=20, m=8, T=3)
    eng = StreamingBiCADMM("squared", _cfg(), device="cpu")
    jeng = JaxStream("squared", _jcfg())
    for X, y in chunks:
        _assert_chunk(_record(eng, eng.partial_fit(X, y)),
                      _record(jeng, jeng.partial_fit(X, y)))
    assert eng.mode == "pcg"
    batch = _batch_fit(_cfg(), chunks)
    np.testing.assert_array_equal(eng.result.support.numpy(),
                                  batch.support.numpy())


def test_direct_regime_streaming_recovers_the_planted_model():
    """Logistic streams warm-start ``run_from`` on the replay window; the
    JAX test's contract is recovery quality (status, support F1, training
    accuracy), and each chunk's fit is held to the JAX stream's."""
    spec = SyntheticSpec(1, 180, 16, sparsity_level=0.75, noise=0.0)
    As, bs, x_true = make_sparse_classification(3, spec)
    X, y = As.reshape(-1, 16), bs.reshape(-1)
    kw = dict(kappa=spec.kappa, gamma=50.0, rho_c=0.5, max_iter=150,
              tol=3e-4, zt_iters=20)
    eng = StreamingBiCADMM("logistic", BiCADMMConfig(**kw), device="cpu")
    jeng = JaxStream("logistic", JaxConfig(**kw))
    for Xc, yc in zip(np.array_split(X, 3), np.array_split(y, 3)):
        res = eng.partial_fit(Xc, yc)
        _assert_chunk(_record(eng, res), _record(jeng, jeng.partial_fit(
            Xc, yc)))
    assert eng.mode == "direct" and int(res.status) == CONVERGED
    got = res.support.numpy()
    f1 = 2 * np.sum(got & (x_true != 0)) / (got.sum() + (x_true != 0).sum())
    assert f1 >= 0.8, f1
    acc = float(np.mean(np.sign(X @ res.coef.numpy().ravel()) == y))
    assert acc > 0.9, acc


# --------------------------------------------------------------------------
# drift probe + fault routing
# --------------------------------------------------------------------------
def test_drift_probe_reprojects_on_distribution_shift():
    rng = np.random.default_rng(16)
    n, kap, m = 24, 4, 40
    w1 = np.zeros(n, np.float32)
    w1[:kap] = 3.0
    w2 = np.zeros(n, np.float32)
    w2[-kap:] = 3.0
    X1, X2 = (rng.standard_normal((m, n)).astype(np.float32)
              for _ in range(2))
    eng = StreamingBiCADMM("squared", _cfg(kappa=kap), window=1,
                           drift_tol=0.5, device="cpu")
    jeng = JaxStream("squared", _jcfg(kappa=kap), window=1, drift_tol=0.5)
    for X, w in ((X1, w1), (X2, w2)):
        y = (X @ w).astype(np.float32)
        _assert_chunk(_record(eng, eng.partial_fit(X, y)),
                      _record(jeng, jeng.partial_fit(X, y)))
    assert eng.drift_reprojections == jeng.drift_reprojections == 1
    np.testing.assert_array_equal(eng.result.support.numpy(), w2 != 0)


def test_poisoned_accumulator_recovers_via_refactorize_rung():
    chunks, _ = _chunks(17, T=3)
    eng = StreamingBiCADMM("squared", _cfg(), device="cpu")
    jeng = JaxStream("squared", _jcfg())
    for X, y in chunks[:-1]:
        eng.partial_fit(X, y)
        jeng.partial_fit(X, y)
    atb = eng._acc.Atb.clone()
    atb[0] = float("nan")
    eng._acc = dataclasses.replace(eng._acc, Atb=atb)
    eng._fcache = None
    jeng._acc = dataclasses.replace(jeng._acc,
                                    Atb=jeng._acc.Atb.at[0].set(jnp.nan))
    jeng._fcache = None
    res = eng.partial_fit(*chunks[-1])
    jres = jeng.partial_fit(*chunks[-1])
    assert eng.refactorizations == jeng.refactorizations == 1
    assert [(a.stage, a.detail, a.status) for a in res.recovery] == \
        [(a.stage, a.detail, a.status) for a in jres.recovery] == \
        [("refactorize", "non-finite streaming accumulator", CONVERGED)]
    _assert_chunk(_record(eng, res), _record(jeng, jres))
    batch = _batch_fit(_cfg(), chunks)
    np.testing.assert_array_equal(res.support.numpy(), batch.support.numpy())


def test_poisoned_window_fails_closed():
    chunks, _ = _chunks(18, T=2)
    eng = StreamingBiCADMM("squared", _cfg(), device="cpu")
    eng.partial_fit(*chunks[0])
    X_bad = chunks[1][0].copy()
    X_bad[0, 0] = np.nan
    with pytest.raises(SolveDiverged, match="window itself is poisoned"):
        eng.partial_fit(X_bad, chunks[1][1])


def test_window_zero_requires_dense_and_feature_split_is_rejected():
    eng = StreamingBiCADMM("squared", _cfg(x_solver="woodbury"), window=0,
                           device="cpu")
    chunks, _ = _chunks(19, n=40, m=8, T=1)
    with pytest.raises(ValueError, match="only valid in the dense"):
        eng.partial_fit(*chunks[0])
    with pytest.raises(ValueError, match="n_feature_blocks=1"):
        StreamingBiCADMM("squared", _cfg(n_feature_blocks=4), device="cpu")


def test_diverged_refit_escalates_through_the_recovery_ladder():
    """A stream whose solvers are poisoned while rho_c < 5: the refit and
    the engine's refactorize rung stay DIVERGED; the api's ladder (retry,
    then the rho restart) brings it back, logged as in JAX."""
    chunks, _ = _chunks(24, T=2)
    problem = dict(loss="squared", kappa=4, gamma=10.0, rho_c=4.0)
    kw = dict(max_iter=200, tol=1e-3, zt_iters=20)
    where = (lambda s: float(s.cfg.rho_c) < 5.0)
    with faults.inject(faults.nan_x(2), where=where):
        s = stream(api.SparseProblem(**problem), options=api.SolverOptions(
            device="cpu", recovery=api.RecoveryPolicy(), **kw))
        for X, y in chunks:
            res = s.partial_fit(X, y)
    with jfaults.inject(jfaults.nan_x(2), where=where):
        js = japi.stream(japi.SparseProblem(**problem),
                         options=japi.SolverOptions(recovery=JaxPolicy(),
                                                    **kw))
        for X, y in chunks:
            jres = js.partial_fit(X, y)
    assert int(res.status) == int(jres.status) == CONVERGED
    log = [(a.stage, a.detail, a.status) for a in res.recovery]
    assert log == [(a.stage, a.detail, a.status) for a in jres.recovery]
    assert log[0][0] == "refactorize" and log[-1][0] == "rho_restart"
    np.testing.assert_array_equal(res.support.numpy(),
                                  np.asarray(jres.support))


# --------------------------------------------------------------------------
# precision: accumulators + resumable state stay pinned f32
# --------------------------------------------------------------------------
@pytest.mark.parametrize("preset,data_dt", [("bf16", torch.bfloat16),
                                            ("fp16", torch.float16)])
def test_reduced_precision_state_stays_f32(preset, data_dt):
    chunks, _ = _chunks(20, n=16, m=16, T=3)
    eng = StreamingBiCADMM("squared", _cfg(tol=1e-3, precision=preset),
                           device="cpu")
    jeng = JaxStream("squared", _jcfg(tol=1e-3, precision=preset))
    for X, y in chunks:
        res = eng.partial_fit(X, y)
        jres = jeng.partial_fit(X, y)
        assert eng._chunks[0][0].dtype == data_dt
        assert all(getattr(eng._acc, f.name).dtype == torch.float32
                   for f in dataclasses.fields(eng._acc))
        assert res.state.z.dtype == res.state.x.dtype == torch.float32
        assert int(res.status) == int(jres.status)
        np.testing.assert_array_equal(res.support.numpy(),
                                      np.asarray(jres.support))
    A_win, y_win = eng._window_data()
    out = eng.solver.run_from(A_win[None], y_win[None], res.state)
    assert out.state.z.dtype == torch.float32


# --------------------------------------------------------------------------
# the API layer: stream(), estimators, capability gate, conversion
# --------------------------------------------------------------------------
def test_api_stream_equals_api_solve_and_the_jax_stream():
    chunks, _ = _chunks(21, T=3)
    kw = dict(max_iter=200, tol=1e-3, zt_iters=20)
    problem = api.SparseProblem(loss="squared", kappa=4, gamma=10.0,
                                rho_c=4.0)
    options = api.SolverOptions(device="cpu", **kw)
    s = stream(problem, options=options)
    js = japi.stream(japi.SparseProblem(loss="squared", kappa=4, gamma=10.0,
                                        rho_c=4.0),
                     options=japi.SolverOptions(**kw))
    for X, y in chunks:
        res = s.partial_fit(X, y)
        jres = js.partial_fit(X, y)
    assert s.mode == js.mode == "dense"
    assert s.m_seen == sum(X.shape[0] for X, _ in chunks)
    _assert_chunk(_record(s.engine, res), _record(js.engine, jres))
    X_all = np.concatenate([c[0] for c in chunks])
    y_all = np.concatenate([c[1] for c in chunks])
    batch = api.solve(problem, X_all, y_all, options=options)
    np.testing.assert_array_equal(res.support.numpy(), batch.support.numpy())
    np.testing.assert_allclose(res.coef.numpy(), batch.coef.numpy(),
                               atol=1e-3)


def test_capabilities_stream_gate():
    assert api.engine_capabilities("reference").stream
    split = api.SolverOptions(device="cpu", n_feature_blocks=2)
    assert not api.engine_capabilities("reference", split).stream
    with pytest.raises(api.CapabilityError, match="cannot stream"):
        api.stream(api.SparseProblem(loss="squared", kappa=4),
                   options=split)


def test_estimator_partial_fit_matches_fit():
    chunks, _ = _chunks(22, T=3)
    X_all = np.concatenate([c[0] for c in chunks])
    y_all = np.concatenate([c[1] for c in chunks])
    kw = dict(kappa=4, gamma=10.0, rho_c=4.0, max_iter=200, tol=1e-3,
              zt_iters=20)
    inc = api.SparseLinearRegression(device="cpu", **kw)
    for X, y in chunks:
        inc.partial_fit(X, y)
    assert inc.engine_ == "streaming"
    full = api.SparseLinearRegression(device="cpu", **kw).fit(X_all, y_all)
    np.testing.assert_allclose(inc.coef_.numpy(), full.coef_.numpy(),
                               atol=1e-3)
    assert inc.score(X_all, y_all) > 0.99
    inc.fit(X_all, y_all)               # a full fit resets the open stream
    assert inc._stream is None and inc.engine_ == "reference"


def test_estimator_partial_fit_window_honored():
    chunks, _ = _chunks(23, T=3, m=10)
    est = api.SparseLinearRegression(kappa=4, gamma=10.0, rho_c=4.0,
                                     device="cpu", zt_iters=20, tol=1e-3)
    for X, y in chunks:
        est.partial_fit(X, y, window=2)
    assert est._stream.engine.m_window == 20


def test_port_stream_continues_a_jax_stream():
    """A JAX stream's snapshot after two chunks (accumulators, replay
    window, state; through repro_torch.convert) seeds a port stream, which
    then takes the third chunk as the JAX stream does."""
    chunks, _ = _chunks(25, T=3)
    jeng = JaxStream("squared", _jcfg(), window=2)
    for X, y in chunks[:2]:
        jeng.partial_fit(X, y)
    acc = convert.accum_to_numpy(jeng._acc)
    assert sorted(acc) == ["Atb", "G", "L", "yty"]
    state = {k: np.asarray(v) for k, v in jeng.result.state._asdict().items()
             if k != "inner"}
    eng = convert.seed_stream(
        StreamingBiCADMM("squared", _cfg(), window=2, device="cpu"),
        mode=jeng.mode, acc=acc, state=state, m_seen=jeng.m_seen,
        chunks=[(np.asarray(X), np.asarray(y)) for X, y in jeng._chunks])
    back = convert.accum_to_numpy(eng._acc)
    assert all(np.array_equal(back[k], acc[k]) for k in acc)
    _assert_chunk(_record(eng, eng.partial_fit(*chunks[2])),
                  _record(jeng, jeng.partial_fit(*chunks[2])))
    assert eng.m_seen == jeng.m_seen and eng.m_window == jeng.m_window
    with pytest.raises(ValueError, match="accumulator"):
        convert.accum_from_numpy({"G": acc["G"]}, "cpu")

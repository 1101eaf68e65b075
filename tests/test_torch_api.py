"""The port's estimator front-end (repro_torch.api) against the JAX
package's (repro.api), and the port's boundaries: what is not ported
raises CapabilityError up front, nothing runs on the CPU unless asked,
and neither repro_torch nor chip_smoke.py imports jax or repro. The
sharded engine's options run and negotiate on a (1, 1) DeviceMesh of a
world-size-1 gloo group (tests/test_torch_sharded.py holds the engine
against JAX).

Fit tolerances are those of tests/test_torch_bicadmm.py: same support,
coef within 1e-3, iterations within 2; predictions within 1e-3 and R^2
within 1e-4.
"""
import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro.api as japi
from repro_torch import api, runtime
from repro_torch.core import losses
from repro_torch.data import SyntheticSpec, make_sparse_regression

ROOT = Path(__file__).resolve().parents[1]
KW = dict(gamma=10.0, rho_c=1.0, tol=1e-4, zt_iters=20)


def _data():
    spec = SyntheticSpec(2, 30, 60, sparsity_level=0.75, noise=1e-3)
    As, bs, _ = make_sparse_regression(3, spec)
    return spec, As, bs


@pytest.mark.parametrize("layout", ["stacked", "flat"])
def test_linear_regression_fit_predict_score_match_jax(layout):
    spec, As, bs = _data()
    X, y = (As, bs) if layout == "stacked" else (As.reshape(-1, 60),
                                                 bs.reshape(-1))
    jest = japi.SparseLinearRegression(kappa=spec.kappa, **KW).fit(
        jnp.asarray(X), jnp.asarray(y))
    est = api.SparseLinearRegression(kappa=spec.kappa, device="cpu",
                                     **KW).fit(X, y)
    assert est.device.type == "cpu" and est.engine_ == "reference"
    np.testing.assert_array_equal(est.support_.numpy(),
                                  np.asarray(jest.support_))
    np.testing.assert_allclose(est.coef_.numpy(), np.asarray(jest.coef_),
                               rtol=1e-3, atol=1e-3)
    assert abs(est.n_iter_ - jest.n_iter_) <= 2
    X_new = np.random.default_rng(0).standard_normal((7, 60)).astype(
        np.float32)
    np.testing.assert_allclose(est.predict(X_new).numpy(),
                               np.asarray(jest.predict(jnp.asarray(X_new))),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(est.decision_function(X_new).numpy(),
                               est.predict(X_new).numpy())
    assert abs(est.score(X, y) - jest.score(jnp.asarray(X),
                                            jnp.asarray(y))) < 1e-4


def test_solve_and_warm_state_round_trip():
    spec, As, bs = _data()
    prob = api.SparseProblem("squared", kappa=spec.kappa, gamma=10.0)
    opts = api.SolverOptions(device="cpu", tol=1e-4, zt_iters=20)
    res = api.solve(prob, As, bs, options=opts)
    assert res.status_name in ("CONVERGED", "MAX_ITER")
    again = api.solve(prob, As, bs, options=opts, state=res.state)
    assert torch.equal(again.support, res.support)
    assert int(again.iters) <= int(res.iters)


def test_entry_points_need_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: api.SparseLinearRegression(kappa=3),
                 lambda: api.SparseLinearRegression(kappa=3, device="cuda"),
                 lambda: api.solve(api.SparseProblem("squared", kappa=3),
                                   np.ones((4, 3), np.float32),
                                   np.ones(4, np.float32))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert runtime.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        runtime.resolve_device("mps")


# the feature split and the reduced presets are ported; the reference
# engine's feature split under a reduced preset (which fails in the JAX
# package itself) still raises up front
UNPORTED_OPTIONS = {"feature_blocks": dict(n_feature_blocks=2,
                                           precision="bf16"),
                    "bf16": dict(precision="bf16", force_feature_split=True),
                    "fp16": dict(precision="fp16", n_feature_blocks=4)}


@pytest.mark.parametrize("name", sorted(UNPORTED_OPTIONS))
def test_unported_options_raise_capability_error(name):
    with pytest.raises(api.CapabilityError):
        api.SparseLinearRegression(kappa=3, device="cpu",
                                   **UNPORTED_OPTIONS[name])


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1) DeviceMesh on a world-size-1 gloo group."""
    if not dist.is_initialized():
        store = tmp_path_factory.mktemp("gloo") / "store"
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=0, world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("nodes", "feat"))


# the options that raised CapabilityError before the sharded engine was
# ported: each now runs, on the engine it negotiates
SHARDED_OPTIONS = {"engine": (dict(engine="sharded"), "sharded"),
                   "mesh": ({}, "reference"),    # one rank: reference
                   "feature_split": (dict(force_feature_split=True,
                                          engine="sharded"), "sharded")}


@pytest.mark.parametrize("name", sorted(SHARDED_OPTIONS))
def test_sharded_options_run_and_negotiate(mesh, name):
    opts, engine = SHARDED_OPTIONS[name]
    spec, As, bs = _data()
    est = api.SparseLinearRegression(kappa=spec.kappa, device="cpu",
                                     mesh=mesh, max_iter=5, zt_iters=10,
                                     **opts).fit(As, bs)
    assert est.engine_ == engine == est.capabilities_.engine
    assert est.capabilities_.distributed is (engine == "sharded")
    assert est.coef_.shape == (60,) and est.n_iter_ == 5
    assert api.select_engine(est.options, n_samples=60,
                             n_features=60) == engine


def test_unported_models_and_entry_points_raise_capability_error():
    """Every model is ported (each loss resolves), and so are the path,
    the grid and per-solve overrides: they run, for the classifiers and the
    feature split too (kappa only there: a gamma / rho_c override or grid
    raises ValueError, as in the JAX package). Streaming fits
    (``partial_fit``) and recovery run too. What the models still lack —
    serving — raises CapabilityError up front; the fleet and streaming
    refuse the feature split. The sharded engine's capabilities are the
    JAX package's."""
    for name in ("logistic", "hinge", "smoothed_hinge"):
        assert losses.get_loss(name).name == name
    assert losses.get_loss("softmax", 3).n_classes == 3
    X = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    y = np.sign(X[:, 0] + 0.1).astype(np.float32)
    kw = dict(device="cpu", max_iter=3, zt_iters=4)
    for est in (api.SparseLinearRegression(kappa=2, **kw),
                api.SparseLogisticRegression(kappa=2, **kw),
                api.SparseSVM(kappa=2, n_feature_blocks=2, **kw),
                api.SparseSoftmaxRegression(kappa=2, n_classes=3, **kw)):
        yy = (X[:, 0] > 0).astype(np.int64) if est.problem.n_classes > 1 \
            else y
        for method in (est.fit_path, est.fit_grid):
            path = method(X, yy, [2, 1])
            assert path.coef.shape[0] == 2 and est.n_iter_ == int(
                path.iters[-1])
        if est.options.n_feature_blocks > 1:
            with pytest.raises(api.CapabilityError):
                est.partial_fit(X, yy)
        else:
            assert est.partial_fit(X, yy).engine_ == "streaming"
    with pytest.raises(api.CapabilityError):
        api.fit_many(api.SparseProblem("logistic", kappa=3), X[None], y[None],
                     options=api.SolverOptions(n_feature_blocks=2, **kw))
    with pytest.raises(api.CapabilityError):
        api.serve(api.SparseProblem("squared", kappa=3), X, y)
    with pytest.raises(api.CapabilityError):
        api.stream(api.SparseProblem("squared", kappa=3),
                   options=api.SolverOptions(n_feature_blocks=2, **kw))
    assert api.recover(api.SparseProblem("squared", kappa=2), X, y,
                       options=api.SolverOptions(**kw)).recovery[0].stage \
        == "retry"
    for fn in (api.solve_path, api.solve_grid):
        path = fn(api.SparseProblem("squared", kappa=2), X, y, [2, 1],
                  options=api.SolverOptions(**kw), gammas=[1.0, 2.0])
        assert path.strategy in ("warm-scan", "vmap")
    As, bs = torch.as_tensor(X)[None], torch.as_tensor(y)[None]
    for split in (False, True):
        opts = api.SolverOptions(n_feature_blocks=2 if split else 1, **kw)
        adapter = api._ReferenceAdapter(api.SparseProblem("squared",
                                                          kappa=2), opts)
        assert adapter.caps.per_solve_overrides
        assert adapter.caps.dynamic_penalties is not split
        assert adapter.fit(As, bs, kappa=1).support.sum() <= 1
        for over in (dict(gamma=2.0), dict(rho_c=2.0)):
            if split:
                with pytest.raises(ValueError, match="feature-split"):
                    adapter.fit(As, bs, **over)
            else:
                assert adapter.fit(As, bs, **over).status is not None
    caps = api.engine_capabilities("sharded")
    assert caps.distributed and caps.grid_strategy == "cold-scan"
    assert caps.precisions == ("float32", "bfloat16")
    assert not (caps.fleet or caps.stream or caps.per_solve_overrides)
    with pytest.raises(ValueError, match="unknown engine"):
        api.engine_capabilities("mesh")


def test_validate_data_rejects_bad_input():
    with pytest.raises(ValueError, match="non-finite"):
        api.SparseLinearRegression(kappa=2, device="cpu").fit(
            np.full((4, 3), np.nan, np.float32), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="targets"):
        api.SparseLinearRegression(kappa=2, device="cpu").fit(
            np.ones((4, 3), np.float32), np.ones(5, np.float32))


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path} imports {bad}"
    code = ("import sys, repro_torch.api, repro_torch.convert, "
            "repro_torch.data, repro_torch.models, repro_torch.configs; "
            "repro_torch.configs.get_config('qwen3-8b'); "
            "sys.path.insert(0, %r); import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad; print('ok')"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_parity_fits_are_the_three_banded_fits():
    """chip_smoke.parity_fits (phase 8, and the probe's --parity): Woodbury
    at n = 2,500, the feature split at n = 250, squared and logistic, the
    Woodbury fit's data through the PCG x-update, that data in bf16
    through Woodbury, in fp16 through PCG and Woodbury, and through
    Woodbury under fp64_polish; numpy data from seed 1, tol 1e-4 within
    300 iterations."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fits = smoke.parity_fits()
    assert [f[0] for f in fits] == [
        "parity", "parity_split_squared", "parity_split_logistic",
        "parity_pcg", "parity_woodbury_bf16", "parity_pcg_fp16",
        "parity_woodbury_fp16", "parity_woodbury_fp64"]
    assert [f[2] for f in fits] == [api.SparseLinearRegression,
                                    api.SparseLinearRegression,
                                    api.SparseLogisticRegression,
                                    *[api.SparseLinearRegression] * 5]
    assert [f[4].shape for f in fits] == [(2, 200, 2_500), (2, 200, 250),
                                          (2, 200, 250),
                                          *[(2, 200, 2_500)] * 5]
    assert fits[0][3]["x_solver"] == "woodbury"
    assert all(f[3]["n_feature_blocks"] == 4 for f in fits[1:3])
    assert [(f[3]["x_solver"], f[3].get("precision", "fp32"))
            for f in fits[3:]] == [("pcg", "fp32"), ("woodbury", "bf16"),
                                   ("pcg", "fp16"), ("woodbury", "fp16"),
                                   ("woodbury", "fp64_polish")]
    for f in fits[3:]:
        np.testing.assert_array_equal(f[4], fits[0][4])
        assert {k: v for k, v in f[3].items()
                if k not in ("x_solver", "precision")} == {
            k: v for k, v in fits[0][3].items() if k != "x_solver"}
    assert all(f[3]["tol"] == 1e-4 and f[3]["max_iter"] == 300
               for f in fits)
    spec = SyntheticSpec(2, 200, 2_500, sparsity_level=0.98, noise=1e-3)
    np.testing.assert_array_equal(fits[0][4],
                                  make_sparse_regression(1, spec)[0])


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    """No CUDA device, or chip_smoke.py alone in a directory: a non-zero
    exit and no result line."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    procs = [subprocess.Popen([sys.executable, str(script)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              cwd=script.parent, env=env)
             for script in (ROOT / "chip_smoke.py", alone)]
    for proc in procs:                  # both run at once
        stdout, _ = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in stdout

"""The port's estimator front-end (repro_torch.api) against the JAX
package's (repro.api), and the port's boundaries: what is not ported
raises CapabilityError up front, nothing runs on the CPU unless asked,
and neither repro_torch nor chip_smoke.py imports jax or repro.

Fit tolerances are those of tests/test_torch_bicadmm.py: same support,
coef within 1e-3, iterations within 2; predictions within 1e-3 and R^2
within 1e-4.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


UNPORTED_OPTIONS = {"engine": dict(engine="sharded"),
                    "mesh": dict(mesh="a mesh"),
                    "feature_blocks": dict(n_feature_blocks=2),
                    "feature_split": dict(force_feature_split=True),
                    "projection": dict(projection="sort"),
                    "bf16": dict(precision="bf16"),
                    "fp16": dict(precision="fp16"),
                    "fp64_polish": dict(precision="fp64_polish"),
                    "recovery": dict(recovery="a policy")}


@pytest.mark.parametrize("name", sorted(UNPORTED_OPTIONS))
def test_unported_options_raise_capability_error(name):
    with pytest.raises(api.CapabilityError):
        api.SparseLinearRegression(kappa=3, device="cpu",
                                   **UNPORTED_OPTIONS[name])


def test_unported_models_and_entry_points_raise_capability_error():
    for cls in (api.SparseLogisticRegression, api.SparseSVM,
                api.SparseSoftmaxRegression):
        with pytest.raises(api.CapabilityError):
            cls(kappa=3, device="cpu")
    for name in ("logistic", "hinge", "smoothed_hinge", "softmax3"):
        with pytest.raises(api.CapabilityError):
            losses.get_loss(name)
    est = api.SparseLinearRegression(kappa=3, device="cpu")
    X, y = np.ones((4, 3), np.float32), np.ones(4, np.float32)
    for method in (est.fit_path, est.fit_grid, est.partial_fit):
        with pytest.raises(api.CapabilityError):
            method(X, y)
    for fn in (api.solve_path, api.solve_grid, api.fit_many, api.serve,
               api.stream, api.recover):
        with pytest.raises(api.CapabilityError):
            fn(api.SparseProblem("squared", kappa=3), X, y)
    adapter = api._ReferenceAdapter(api.SparseProblem("squared", kappa=3),
                                    api.SolverOptions(device="cpu"))
    for over in (dict(gamma=2.0), dict(rho_c=2.0)):
        with pytest.raises(api.CapabilityError):
            adapter.fit(torch.ones(1, 4, 3), torch.ones(1, 4), **over)
    with pytest.raises(api.CapabilityError):
        api.engine_capabilities("sharded")


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
            "repro_torch.data; sys.path.insert(0, %r); import chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad; print('ok')"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


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

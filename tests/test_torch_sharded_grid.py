"""The port's sharded engine on a multi-rank grid against the JAX
package's ``ShardedBiCADMM`` on a multi-device mesh, on the CPU.

The port's side: 4 spawned ranks on a gloo group (a ``file://`` store),
each running every case on its own (2, 2) DeviceMesh (or (2, 1, 2) with
``nodes_axis=("pod", "data")``); the JAX side: a subprocess with 4 host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, set
before JAX is imported, as tests/test_sharded.py does) on a (2, 2) /
(2, 1, 2) mesh of Auto axes. Both read the same numpy data from one file.

Cases: the squared loss in ``ladder_exact``, ``exact`` and ``cg``, the
logistic loss, and the (2, 1, 2) grid, each a fixed 15 outer iterations
(tol 0; 20 FISTA steps, 10 inner iterations) so the time is bounded. Every
psum adds two terms, so its order cannot move a result; the terms
themselves are each package's own sums. Bounds: the same iterations and
support, z within 2e-4 (5e-3 logistic: tests/test_sharded.py's), and every
rank's result equal to rank 0's bit for bit. Rank 0 also checks
``api.select_engine``'s shape rules on the (2, 2) mesh
(tests/test_api.py's multi-device case).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from queue import Empty

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import api
from repro_torch.core import BiCADMMConfig
from repro_torch.core.sharded import ShardedBiCADMM
from repro_torch.data import (SyntheticSpec, make_sparse_classification,
                              make_sparse_regression)

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
SPEC = SyntheticSpec(2, 60, 31, sparsity_level=0.75, noise=1e-3)  # ragged
CLS = SyntheticSpec(2, 100, 31, sparsity_level=0.75, noise=0.0)
KW = dict(gamma=10.0, rho_c=1.0, alpha=0.5, max_iter=15, tol=0.0,
          inner_iters=10, zt_iters=20)
GRID = ((2, 2), ("nodes", "feat"), "nodes")
POD = ((2, 1, 2), ("pod", "data", "feat"), ("pod", "data"))
# name: (loss, data, mesh, config overrides, engine options)
CASES = {
    "ladder_exact": ("squared", "reg", GRID, {}, {}),
    "exact": ("squared", "reg", GRID, {}, dict(projection="exact")),
    "cg": ("squared", "reg", GRID, dict(gamma=0.5, cg_iters=60),
           dict(x_update="cg")),
    "logistic": ("logistic", "cls", GRID, dict(gamma=50.0, rho_c=0.5), {}),
    "pod": ("squared", "reg", POD, {}, {}),
}
Z_TOL = {"logistic": 5e-3}

_JAX_SIDE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.core import BiCADMMConfig
    from repro.core.sharded import ShardedBiCADMM
    cases = json.loads(sys.argv[2])
    data = np.load(sys.argv[1])
    out = {}
    for name, (loss, key, (shape, names, nodes), cfg, engine) in \\
            cases.items():
        mesh = jax.make_mesh(tuple(shape), tuple(names),
                             axis_types=(AxisType.Auto,) * len(shape))
        nodes = tuple(nodes) if isinstance(nodes, list) else nodes
        res = ShardedBiCADMM(loss, BiCADMMConfig(**cfg), mesh,
                             nodes_axis=nodes, **engine).fit(
            jnp.asarray(data[key + "_A"]), jnp.asarray(data[key + "_b"]))
        out[name] = {"iters": int(res.iters),
                     "z": np.asarray(res.z).tolist(),
                     "support": np.asarray(res.support).tolist()}
    print(json.dumps(out))
""")


def _data() -> dict:
    As, bs, _ = make_sparse_regression(1, SPEC)
    Ac, bc, _ = make_sparse_classification(3, CLS)
    return {"reg_A": As.reshape(-1, 31), "reg_b": bs.reshape(-1),
            "cls_A": Ac.reshape(-1, 31), "cls_b": bc.reshape(-1)}


def _config(name: str) -> dict:
    loss, key, _, over, _ = CASES[name]
    spec = SPEC if key == "reg" else CLS
    return dict(KW, kappa=spec.kappa, **over)


def _rank(rank: int, store: str, data_path: str, queue) -> None:
    """One rank: every case on its own mesh; rank 0 also answers
    select_engine on the (2, 2) mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        data = np.load(data_path)
        out = {}
        for name, (loss, key, (shape, names, nodes), _, engine) in \
                CASES.items():
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            res = ShardedBiCADMM(loss, BiCADMMConfig(**_config(name)), mesh,
                                 nodes_axis=nodes, device="cpu",
                                 **engine).fit(
                torch.as_tensor(data[key + "_A"]),
                torch.as_tensor(data[key + "_b"]))
            out[name] = {"iters": int(res.iters), "z": res.z.numpy(),
                         "support": res.support.numpy(),
                         "x": res.state.x.numpy()}
            if name == "ladder_exact":
                opts = api.SolverOptions(mesh=mesh, device="cpu")
                out["select"] = [
                    api.select_engine(opts, n_samples=100, n_features=40),
                    api.select_engine(opts, n_samples=101, n_features=40),
                    api.select_engine(opts, n_samples=100, n_features=1),
                    api.select_engine(opts)]
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """({rank: the port's results}, the JAX subprocess's results): the
    JAX subprocess runs beside the spawned ranks."""
    tmp = tmp_path_factory.mktemp("grid")
    data_path = str(tmp / "data.npz")
    np.savez(data_path, **_data())
    cases = {name: (loss, key, list(mesh), _config(name), engine)
             for name, (loss, key, mesh, _, engine) in CASES.items()}
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, data_path, json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        queue = mp.get_context("spawn").Queue()
        ranks = mp.spawn(_rank, args=(str(tmp / "store"), data_path, queue),
                         nprocs=WORLD, join=False)
        port = {}
        while len(port) < WORLD:       # read as they come: a rank's put
            try:                       # may not fit the pipe's buffer
                rank, out = queue.get(timeout=1)
                port[rank] = out
            except Empty:
                ranks.join(timeout=0)  # raises when a rank failed
        while not ranks.join():
            pass
        out, err = jax_side.communicate(timeout=600)
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
    assert jax_side.returncode == 0, err[-3000:]
    return port, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_matches_jax_sharded(grids, case):
    port, want = grids
    got, ref = port[0][case], want[case]
    assert got["iters"] == ref["iters"] == KW["max_iter"]
    np.testing.assert_array_equal(got["support"], np.asarray(ref["support"]))
    np.testing.assert_allclose(got["z"], np.asarray(ref["z"]), rtol=0,
                               atol=Z_TOL.get(case, 2e-4))
    assert got["x"].shape == (2, 32, 1)       # (N, n_pad, K)
    for rank in range(1, WORLD):              # one replicated answer
        for key in ("z", "support", "x"):
            assert np.array_equal(port[rank][case][key], got[key]), \
                (rank, key)


def test_select_engine_shape_rules_on_a_grid(grids):
    assert grids[0][0]["select"] == ["sharded", "reference", "reference",
                                     "sharded"]

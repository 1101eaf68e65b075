"""The one-launch projections' plain versions (``repro_torch.kernels.ref``:
``l1_epigraph_proj_ref``, ``skappa_support_ref``), the plan that picks
their launch, and their registry rows, on the CPU.

The plain versions are what ``csrc/ladder_proj.cu`` computes: the composed
``bilinear`` projections at ``rounds=2`` (what the card runs), with the
sums over one threshold accumulated in f64 and rounded once. Here they are
held against the JAX package's ``project_l1_epigraph`` /
``support_skappa_ladder`` at ``rounds=2`` (under ``jax.jit`` on the CPU,
with the JAX package's plain ladder statistics) and against the sort
oracles, on the same numpy inputs.

Tolerance: theta, z, t and u_max within rtol 1e-5 and an atol of 1e-6 x
max |z| (two f32 fixpoints reached through sums of different order lie a
few ulps apart); s* equal to the JAX s* exactly, since it depends on
counts alone. The card tests (tests/test_torch_cuda.py) hold the kernels
to the same bounds against these plain versions.
"""
import functools
import importlib.util
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bilinear as jbl
from repro_torch import runtime
from repro_torch.core import bilinear as tbl
from repro_torch.kernels import bisect_proj, ops, ref

J_PROJECT2 = jax.jit(functools.partial(jbl.project_l1_epigraph, rounds=2))
J_PROJECT_SORT = jax.jit(jbl.project_l1_epigraph_sort)
J_SUPPORT2 = jax.jit(functools.partial(jbl.support_skappa_ladder, rounds=2))
J_SUPPORT_SORT = jax.jit(jbl.support_skappa_sort)
SOURCE = (Path(bisect_proj.__file__).resolve().parent.parent / "csrc"
          / "ladder_proj.cu")


def _vec(seed, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


def _ties(seed, n_vals, reps):
    vals = np.random.default_rng(seed).standard_normal(n_vals)
    return np.repeat(vals, reps).astype(np.float32)


def _close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-6 * scale)


L1_CASES = {
    "random300": (_vec(0, 300), 1.7),
    "random513": (_vec(2, 513), 7.0),
    "inside": (np.float32([0.5, -0.25]), 2.0),
    "apex": (_vec(5, 3) * np.float32(0.1), -10.0),
    "ties": (_ties(3, 4, 30), 0.4),
    "ties_one_value": (_ties(4, 1, 40), -1.0),
    "zeros_inside": (np.zeros(40, np.float32), 0.5),
    "zeros_apex": (np.zeros(40, np.float32), -0.5),
    "zeros_t0=0": (np.zeros(40, np.float32), 0.0),
    "n=1": (np.float32([2.0]), 0.5),
    "n=1_negative": (np.float32([-3.0]), -1.0),
    "t0=0": (_vec(6, 50), 0.0),
    "tiny": (_vec(7, 80, 1e-30), 1e-31),
}


@pytest.mark.parametrize("case", sorted(L1_CASES))
def test_l1_plain_matches_jax_and_sort_oracles(case):
    z0, t0 = L1_CASES[case]
    z, t, theta, _ = ref.l1_epigraph_proj_ref(
        torch.as_tensor(z0), torch.tensor(t0, dtype=torch.float32),
        stats=True)
    scale = float(np.abs(z0).max())
    zj, tj = J_PROJECT2(jnp.asarray(z0), jnp.float32(t0))
    zs, ts = J_PROJECT_SORT(jnp.asarray(z0), jnp.float32(t0))
    z64, t64 = tbl.project_l1_epigraph_sort(torch.as_tensor(z0).double(),
                                            torch.tensor(t0).double())
    for want_z, want_t in ((zj, tj), (zs, ts), (z64, t64)):
        _close(z.numpy(), np.asarray(want_z), scale)
        _close(float(t), float(want_t), scale)
    if float(z64.abs().sum()) > 0:        # theta of the f64 oracle, exactly
        _close(float(theta), float(t64) - float(np.float32(t0)), scale)
    assert float(z.abs().double().sum()) <= float(t) * (1 + 1e-6) \
        + 1e-6 * scale                                            # feasible


SKAPPA_CASES = {
    "random": (_vec(0, 200), 20.0),
    "fractional": (_vec(1, 60), 7.5),
    "kappa>=n": (_vec(2, 30), 45.0),
    "kappa=0.5": (_vec(3, 100), 0.5),
    "kappa>=nnz": (np.where(np.arange(50) % 5 == 0, _vec(4, 50), 0.0)
                   .astype(np.float32), 15.0),
    "tie_straddles": (np.float32([0.5] * 6 + [0.2] * 4), 3.0),
    "ties_fractional": (_ties(5, 5, 20), 33.25),
    "zeros": (np.zeros(40, np.float32), 3.0),
    "n=1": (np.float32([-2.0]), 0.5),
    "n=1_kappa>=n": (np.float32([-2.0]), 2.0),
    "few": (np.float32([3.0, -2.0, 1.0, 0.5]), 2.5),
}


@pytest.mark.parametrize("case", sorted(SKAPPA_CASES))
def test_skappa_plain_matches_jax_and_sort_oracles(case):
    z, kappa = SKAPPA_CASES[case]
    u, s = ref.skappa_support_ref(torch.as_tensor(z), kappa)
    scale = float(np.abs(z).max())
    uj, sj = J_SUPPORT2(jnp.asarray(z), kappa)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    _close(float(u), float(uj), scale)
    us, _ = J_SUPPORT_SORT(jnp.asarray(z), kappa)
    _close(float(u), float(us), scale)
    u64, _ = tbl.support_skappa_sort(torch.as_tensor(z).double(), kappa)
    _close(float(u), float(u64), scale)
    kap32 = float(torch.tensor(kappa, dtype=torch.float32))
    assert float(s.abs().double().sum()) <= kap32 * (1 + 1e-6)
    assert float(s.abs().max()) <= 1.0


@pytest.mark.parametrize("seed,n", [(10, 1_000), (11, 2_500)])
def test_plain_versions_at_the_solver_shapes(seed, n):
    """The dense and parity fits' widths, against JAX at rounds=2 and the
    port's composed path at rounds=0 (what the CPU fits run)."""
    z0 = _vec(seed, n, 0.3)
    t0 = np.float32(0.2 * np.abs(z0).sum())
    z, t, _, k = ref.l1_epigraph_proj_ref(torch.as_tensor(z0), float(t0),
                                          stats=True)
    zj, tj = J_PROJECT2(jnp.asarray(z0), t0)
    zc, tc = tbl.project_l1_epigraph(torch.as_tensor(z0), float(t0),
                                     rounds=0)
    scale = float(np.abs(z0).max())
    for want_z, want_t in ((zj, tj), (zc, tc)):
        _close(z.numpy(), np.asarray(want_z), scale)
        _close(float(t), float(want_t), scale)
    assert 1 <= k <= 8                # the rounds leave the polish a few steps
    kappa = n / 5
    u, s, k = ref.skappa_support_ref(torch.as_tensor(z0), kappa, stats=True)
    uj, sj = J_SUPPORT2(jnp.asarray(z0), kappa)
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    _close(float(u), float(uj), scale)
    assert 1 <= k <= 8


def test_polish_and_search_stop_at_the_cap():
    z0 = _vec(12, 500)
    _, t_full, th_full, k_full = ref.l1_epigraph_proj_ref(
        torch.as_tensor(z0), 1.0, rounds=0, stats=True)
    _, t_one, th_one, k_one = ref.l1_epigraph_proj_ref(
        torch.as_tensor(z0), 1.0, rounds=0, cap=1, stats=True)
    assert k_full > 1 and k_one == 1
    assert float(th_one) < float(th_full)      # the polish climbs to its root
    assert torch.equal(t_full, torch.tensor(1.0) + th_full)
    _, _, k = ref.skappa_support_ref(torch.as_tensor(z0), 50.0, rounds=0,
                                     cap=2, stats=True)
    assert k <= 2
    # inside and apex: theta is selected away (0), so no step is taken
    for t0 in (9.0, -9.0):
        _, _, theta, k = ref.l1_epigraph_proj_ref(torch.ones(4), t0,
                                                  stats=True)
        assert float(theta) == 0.0 and k == 0


# ---------------------------------------------------------------- plan --
def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("name,value", [
    ("kThreads", bisect_proj.THREADS), ("kRungs", bisect_proj.RUNGS),
    ("kMaxPerCta", bisect_proj.MAX_PER_CTA),
    ("kMaxCtas", bisect_proj.MAX_CTAS)])
def test_constants_mirror_the_source(name, value):
    assert _constant(name) == value
    assert bisect_proj.RUNGS == tbl.LADDER_B == ref.LADDER_RUNGS
    assert ref.LADDER_CAP == tbl.NEWTON_CAP


def test_probe_labels_every_stamp_of_the_source():
    """tools/ladder_proj_probe.py --trace names the source's Stamp codes
    (a -DLADDER_PROJ_TRACE build's phases) in their order."""
    body = re.search(r"enum Stamp \{([^}]*)\}", SOURCE.read_text()).group(1)
    codes = [c.strip() for c in body.split(",") if c.strip()]
    path = SOURCE.parents[3] / "tools" / "ladder_proj_probe.py"
    spec = importlib.util.spec_from_file_location("ladder_proj_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert codes[0] == "kStart" and codes[13] == "kEnd"
    assert codes[14] == "kLaneStart" and codes[-1] == "kLaneEnd"
    assert len(probe.STAMPS) == len(codes)


@pytest.mark.parametrize("ctas,n_from", bisect_proj.CLUSTER_FROM)
def test_plan_takes_each_cluster_size_from_its_boundary(ctas, n_from):
    assert bisect_proj.plan(n_from) == bisect_proj.Plan(True, ctas)
    assert bisect_proj.plan(n_from - 1).ctas < ctas


@pytest.mark.parametrize("n", [1, 127, 1_000, 2_500, 4_000, 10_000, 12_000,
                               bisect_proj.MAX_PER_CTA,
                               bisect_proj.MAX_PER_CTA + 1,
                               bisect_proj.MAX_N])
def test_plan_one_launch_holds_every_slice(n):
    p = bisect_proj.plan(n)
    assert p.one_launch and p.ctas in (1, 2, 4, 8)
    assert math.ceil(n / p.ctas) <= bisect_proj.MAX_PER_CTA


def test_plan_past_the_one_launch_limit_and_refusals():
    assert bisect_proj.MAX_N == 409_600
    assert bisect_proj.plan(bisect_proj.MAX_N + 1) == bisect_proj.Plan(False,
                                                                       0)
    assert not bisect_proj.plan(10 ** 7).one_launch
    with pytest.raises(ValueError):
        bisect_proj.plan(0)


# ------------------------------------------------------------ dispatch --
def test_registry_rows_and_cpu_wrappers():
    assert runtime.kernel("l1_epigraph_proj", "cpu") is ref.l1_epigraph_proj_ref
    assert runtime.kernel("skappa_support", "cpu") is ref.skappa_support_ref
    assert runtime.kernel("l1_epigraph_proj",
                          "cuda") is bisect_proj.l1_epigraph_proj
    assert runtime.kernel("skappa_support", "cuda") is bisect_proj.skappa_support
    assert {"l1_epigraph_proj", "skappa_support"} <= set(ops.KERNELS)
    z = torch.as_tensor(_vec(13, 70))
    ops.reset_launch_counts()
    for got, want in ((bisect_proj.l1_epigraph_proj(z, 0.5),
                       ref.l1_epigraph_proj_ref(z, 0.5)),
                      (ops.skappa_support_auto(z, 9.0, rounds=2, cap=64),
                       ref.skappa_support_ref(z, 9.0))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        bisect_proj.l1_epigraph_proj(meta, 0.0)
    with pytest.raises(ValueError):
        bisect_proj.skappa_support(meta, 1.0)


def test_cpu_and_injected_reductions_keep_the_composed_path(monkeypatch):
    """Only an f32 CUDA vector with the default reductions and B = 128 is
    one launch; the CPU path (rounds 0) and injected reductions (the hook
    of a distributed engine) run the composed code."""
    z = torch.as_tensor(_vec(14, 64))
    custom = tbl.DEFAULT_OPS._replace(sum_fn=lambda x: torch.sum(x))
    assert not tbl._one_launch(z, tbl.DEFAULT_OPS, tbl.LADDER_B)
    called = []
    monkeypatch.setitem(runtime._REGISTRY["l1_epigraph_proj"], "cpu",
                        lambda *a, **k: called.append(1))
    monkeypatch.setitem(runtime._REGISTRY["skappa_support"], "cpu",
                        lambda *a, **k: called.append(1))
    zc, tc = tbl.project_l1_epigraph(z, 0.3)
    zo, to = tbl.project_l1_epigraph(z, 0.3, ops=custom)
    tbl.support_skappa_ladder(z, 5.0)
    assert not called
    assert torch.equal(zc, zo) and torch.equal(tc, to)

"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel's plain version (the ``"cpu"`` registry row) is held
against the JAX Pallas kernel run in interpret mode, as tests/test_kernels.py
runs it, on the same numpy inputs: rtol 1e-4 / atol 1e-5, the JAX package's
own f32 kernel bound. The dispatch rules are checked here too. The CUDA
kernels themselves are held against their plain versions in
tests/test_torch_cuda.py, on a machine with a card.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import runtime
from repro_torch.kernels import (bisect_proj, block_matvec, gram, matvec,
                                 ops, ref)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


# ------------------------------------------------------------ ladder --
@pytest.mark.parametrize("n,B,kind", [
    (100, 8, "sorted"), (1025, 128, "sorted"), (3000, 128, "unsorted"),
    (129, 1, "sorted"), (3, 3, "unsorted"), (500, 64, "ties"),
])
def test_ladder_stats_plain_matches_pallas(n, B, kind):
    rng = np.random.default_rng(n + B)
    az = np.abs(rng.standard_normal(n)).astype(np.float32)
    if kind == "ties":   # tie clusters, rungs sitting exactly on data values
        az = np.repeat(az[: n // 25], 25)
        thetas = np.sort(rng.choice(az, B)).astype(np.float32)
    elif kind == "unsorted":
        thetas = rng.uniform(0.0, 2.0, B).astype(np.float32)
    else:
        thetas = np.linspace(0.0, 2.0, B, dtype=np.float32)
    got = ops.ladder_stats_auto(torch.as_tensor(az), torch.as_tensor(thetas))
    want = jops.ladder_stats(jnp.asarray(az), jnp.asarray(thetas),
                             interpret=True)
    assert tuple(got.shape) == (2, B)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# -------------------------------------------------------------- gram --
@pytest.mark.parametrize("m,n", [(64, 32), (100, 17), (8, 300)])
def test_gram_plain_matches_pallas(m, n):
    a = np.random.default_rng(m * 1000 + n).standard_normal(
        (m, n)).astype(np.float32)
    got = ops.gram_auto(torch.as_tensor(a))
    want = jops.gram(jnp.asarray(a), block_m=64, block_n=128, interpret=True)
    _close(got, want, atol=1e-4)


def test_gram_xy_transposed_strided_input():
    """A A^T through the transposed (strided) view, per node, as the
    Woodbury setup asks for it."""
    a = np.random.default_rng(0).standard_normal((3, 40, 70)).astype(
        np.float32)
    at = torch.as_tensor(a).mT
    assert not at.is_contiguous()
    got = ops.gram_auto(at)
    for z in range(3):
        want = jops.gram_xy(jnp.asarray(a[z].T), jnp.asarray(a[z].T),
                            block_m=64, block_n=32, interpret=True)
        _close(got[z], want, atol=1e-4)


# ------------------------------------------------------------ matvec --
@pytest.mark.parametrize("m,n", [(64, 32), (100, 17), (8, 300)])
@pytest.mark.parametrize("k", [None, 3])
def test_matvec_rmatvec_plain_match_pallas_per_node(m, n, k):
    rng = np.random.default_rng(m + n)
    N = 2
    a = rng.standard_normal((N, m, n)).astype(np.float32)
    x = rng.standard_normal((N, n) if k is None else (N, n, k)).astype(
        np.float32)
    y = rng.standard_normal((N, m) if k is None else (N, m, k)).astype(
        np.float32)
    got = ops.matvec_auto(torch.as_tensor(a), torch.as_tensor(x))
    got_t = ops.rmatvec_auto(torch.as_tensor(a), torch.as_tensor(y))
    assert tuple(got.shape) == x.shape[:1] + (m,) + x.shape[2:]
    for z in range(N):
        _close(got[z], jops.matvec(jnp.asarray(a[z]), jnp.asarray(x[z]),
                                   block_m=64, block_n=128, interpret=True),
               atol=1e-4)
        _close(got_t[z], jops.rmatvec(jnp.asarray(a[z]), jnp.asarray(y[z]),
                                      block_m=64, block_n=128,
                                      interpret=True), atol=1e-4)


@pytest.mark.parametrize("shift_kind", ["scalar", "vector"])
def test_normal_matvec_plain_matches_pallas(shift_kind):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((70, 45)).astype(np.float32)
    p = rng.standard_normal(45).astype(np.float32)
    shift = (1.5 if shift_kind == "scalar"
             else (np.abs(rng.standard_normal(45)) + 0.1).astype(np.float32))
    got = ops.normal_matvec_auto(torch.as_tensor(a), torch.as_tensor(p),
                                 shift if shift_kind == "scalar"
                                 else torch.as_tensor(shift))
    want = jops.normal_matvec(jnp.asarray(a), jnp.asarray(p),
                              jnp.asarray(shift), interpret=True)
    _close(got, want, atol=1e-3)
    # the composition of the port's two wrappers is the same function
    _close(matvec.normal_matvec(torch.as_tensor(a), torch.as_tensor(p),
                                torch.as_tensor(shift)), got)


# ---------------------------------------------------------- dispatch --
def test_cpu_tensor_takes_the_cpu_row():
    table = runtime.kernel_table()
    assert set(ops.KERNELS) <= set(table)
    for name in (*ops.KERNELS, "normal_matvec"):
        assert set(table[name]) == {"cuda", "cpu"}
    assert runtime.kernel("ladder_stats", "cpu") is ref.ladder_stats_ref
    assert runtime.kernel("normal_matvec", "cpu") is ref.normal_matvec_ref
    ops.reset_launch_counts()
    a = torch.ones(4, 3)
    ops.matvec_auto(a, torch.ones(3))
    ops.gram_auto(a)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_cuda_row_is_the_kernel_wrapper():
    assert runtime.kernel("ladder_stats", "cuda") is bisect_proj.ladder_stats
    assert runtime.kernel("normal_matvec", "cuda") is matvec.normal_matvec
    wrappers = {"gram": gram.gram, "matvec": matvec.matvec,
                "rmatvec": matvec.rmatvec,
                "block_matvec": block_matvec.block_matvec,
                "block_rmatvec": block_matvec.block_rmatvec}
    for name, wrapper in wrappers.items():
        assert runtime.kernel(name, "cuda").__defaults__[-1] is wrapper


def test_cuda_never_resolves_to_a_plain_row():
    with pytest.raises(ValueError):
        runtime.register_kernel("gram", "default", ref.gram_ref)
    with pytest.raises(KeyError):
        runtime.kernel("gram", "default")
    plain = {ref.gram_ref, ref.matvec_ref, ref.rmatvec_ref,
             ref.normal_matvec_ref, ref.ladder_stats_ref,
             ref.block_matvec_ref, ref.block_rmatvec_ref}
    for name, rows in runtime.kernel_table().items():
        fn = rows["cuda"]
        assert fn not in plain
        assert (fn.__defaults__ or (None,))[-1] not in plain, name
    # a tensor on neither device reaches no plain version either
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        bisect_proj.ladder_stats(meta, meta)


def test_import_needs_neither_nvcc_nor_triton():
    code = ("import sys, shutil; import repro_torch.kernels, repro_torch.api; "
            "assert 'triton' not in sys.modules; "
            "assert 'jax' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PATH": "", "PYTHONPATH": ":".join(
                             p for p in sys.path if p)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

"""The choices the ``gram`` wrapper makes before it launches its kernel.

``repro_torch.kernels.gram`` decides in Python whether its two operands are
one (then ``csrc/gram.cu`` computes only the tiles on and above the diagonal
and mirrors them) and how the operands' shapes and strides reach the C
entry point (up to two batch axes, so the feature split's (N, M, m, nb)
block view of A is one launch). Both are pure functions of the operands'
metadata, checked here on the CPU; CPU tensors still take the plain
version, held against the JAX package's Gram on the same numpy inputs
(rtol 1e-4 / atol 1e-5, the JAX package's f32 kernel bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build, gram, ops, ref


def test_same_operand_is_identity_of_memory_not_of_values():
    a = torch.arange(24.0).reshape(2, 3, 4)
    assert gram.same_operand(a, a)
    assert gram.same_operand(a.mT, a.mT)          # one view, made twice
    assert gram.same_operand(a[:, 1:], a[:, 1:])
    assert not gram.same_operand(a, a.clone())    # equal values, other memory
    assert not gram.same_operand(a, a.mT)         # transposed view
    assert not gram.same_operand(a[:, 1:], a[:, :2])   # another start
    assert not gram.same_operand(a[:, :2], a[:, :3])   # another shape
    assert not gram.same_operand(a, a.double())        # another type
    # same start and shape, other strides
    b = torch.arange(16.0)
    assert not gram.same_operand(b.as_strided((2, 2), (2, 1)),
                                 b.as_strided((2, 2), (1, 2)))


def test_launch_args_of_one_node_and_of_a_transposed_view():
    a = torch.zeros(800, 1000)
    assert gram.launch_args(a, a) == (1, 1, 800, 1000, 1000,
                                      0, 0, 1000, 1, 0, 0, 1000, 1, 1)
    A = torch.zeros(8, 800, 10_000)
    X = A.mT                                     # A A^T: k has unit stride
    assert gram.launch_args(X, A.mT) == (1, 8, 10_000, 800, 800,
                                         0, 8_000_000, 1, 10_000,
                                         0, 8_000_000, 1, 10_000, 1)


def test_launch_args_of_the_feature_split_block_view():
    """(N, M, m, nb) blocks of a contiguous (N, m, n) A: node stride m n,
    block stride nb, k stride n, column stride 1 — no copy."""
    N, m, n, M = 8, 25_000, 4_000, 4
    A = torch.empty(N, m, n)
    view = A.unflatten(-1, (M, n // M)).permute(0, 2, 1, 3)
    assert gram.launch_args(view, view) == (N, M, m, n // M, n // M,
                                            m * n, n // M, n, 1,
                                            m * n, n // M, n, 1, 1)


def test_launch_args_of_two_operands_take_the_general_path():
    x, y = torch.zeros(3, 50, 7), torch.zeros(3, 50, 9)
    assert gram.launch_args(x, y)[-1] == 0
    assert gram.launch_args(x, x.clone())[-1] == 0
    assert gram.launch_args(x, x)[-1] == 1


@pytest.mark.parametrize("x,y", [
    (torch.zeros(5), torch.zeros(5)),                   # no column axis
    (torch.zeros(1, 1, 1, 4, 3), torch.zeros(1, 1, 1, 4, 3)),  # 3 batch axes
    (torch.zeros(4, 3), torch.zeros(5, 3)),             # m differs
    (torch.zeros(2, 4, 3), torch.zeros(3, 4, 3)),       # batch differs
    (torch.zeros(2, 4, 3), torch.zeros(4, 3)),          # ranks differ
    (torch.zeros(65_536, 1, 1, 1), torch.zeros(65_536, 1, 1, 1)),  # grid
])
def test_launch_args_refuse_what_the_kernel_does_not_take(x, y):
    with pytest.raises(ValueError, match="gram_xy"):
        gram.launch_args(x, y)


@pytest.mark.parametrize("shape", [(2, 60, 40), (70, 33), (1, 5, 130),
                                   (2, 3, 20, 9)])
def test_cpu_tensors_take_the_plain_version(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[:-1] + (7,)).astype(np.float32)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    ops.reset_launch_counts()
    got = gram.gram(at)
    got_xy = gram.gram_xy(at, bt)
    assert ops.launch_counts()["gram"] == 0 and not build.LAUNCHES["gram"]
    torch.testing.assert_close(got, ref.gram_ref(at), rtol=0, atol=0)
    torch.testing.assert_close(got_xy, ref.gram_xy_ref(at, bt), rtol=0,
                               atol=0)
    two_d = a.reshape(-1, *a.shape[-2:])[0]
    want = jops.gram(jnp.asarray(two_d), block_m=64, block_n=128,
                     interpret=True)
    np.testing.assert_allclose(np.asarray(gram.gram(torch.as_tensor(two_d))),
                               np.asarray(want), rtol=1e-4, atol=1e-5)

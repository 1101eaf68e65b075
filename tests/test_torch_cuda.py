"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; they carry the ``cuda`` marker
and skip where there is no card. Run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
They import only ``torch`` and ``repro_torch``. Tolerance: rtol 1e-4 and
an atol of 1e-5 per unit of the summed magnitudes, since the kernels sum
in another order than the plain versions.
"""
import pytest
import torch

from repro_torch.kernels import bisect_proj, gram, matvec, ops, ref

RTOL = 1e-4


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, scale):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(10_000, 128), (10_001, 7), (3, 200)])
def test_cuda_ladder_stats(cuda_gen, n, B):
    az = torch.rand(n, device="cuda", generator=cuda_gen)
    th = torch.rand(B, device="cuda", generator=cuda_gen)
    got = bisect_proj.ladder_stats(az, th)
    want = ref.ladder_stats_ref(az, th)
    _close(got[0], want[0], float(az.sum()))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 130, 517), (1, 64, 64), (2, 17, 1)])
def test_cuda_gram(cuda_gen, shape):
    a = torch.randn(shape, device="cuda", generator=cuda_gen)
    for x in (a, a.mT, a[0]):
        _close(gram.gram(x), ref.gram_ref(x), x.shape[-2])
    b = torch.randn(shape[:-1] + (9,), device="cuda", generator=cuda_gen)
    _close(gram.gram_xy(a, b), ref.gram_xy_ref(a, b), shape[-2])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [None, 1, 3, 6])
@pytest.mark.parametrize("shape", [(3, 130, 517), (1, 300, 16), (2, 5, 3)])
def test_cuda_matvec_rmatvec(cuda_gen, shape, k):
    N, m, n = shape
    a = torch.randn(shape, device="cuda", generator=cuda_gen)
    x = torch.randn((N, n) if k is None else (N, n, k), device="cuda",
                    generator=cuda_gen)
    y = torch.randn((N, m) if k is None else (N, m, k), device="cuda",
                    generator=cuda_gen)
    _close(matvec.matvec(a, x), ref.matvec_ref(a, x), n)
    _close(matvec.rmatvec(a, y), ref.rmatvec_ref(a, y), m)
    _close(matvec.matvec(a[0], x[0]), ref.matvec_ref(a[0], x[0]), n)
    _close(matvec.rmatvec(a[0], y[0]), ref.rmatvec_ref(a[0], y[0]), m)
    shift = torch.rand(n, device="cuda", generator=cuda_gen)
    p = x[..., 0] if k is not None else x
    _close(matvec.normal_matvec(a, p, shift),
           ref.normal_matvec_ref(a, p, shift), m * n)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_gen):
    a = torch.randn(4, 6, device="cuda", generator=cuda_gen)
    with pytest.raises(ValueError):
        matvec.matvec(a.mT, torch.ones(4, device="cuda"))   # not row-major
    with pytest.raises(ValueError):
        matvec.matvec(a.double(), torch.ones(6, device="cuda").double())
    with pytest.raises(ValueError):
        bisect_proj.ladder_stats(a, torch.ones(3, device="cuda"))


@pytest.mark.cuda
def test_cuda_launch_counts_are_device_kernel_launches(cuda_gen):
    """ladder_stats issues two kernels per call, rmatvec two past one
    128-row slice and one within it, gram and matvec one."""
    a = torch.randn(2, 300, 40, device="cuda", generator=cuda_gen)
    ops.reset_launch_counts()
    bisect_proj.ladder_stats(a[0, 0].abs(), torch.rand(
        8, device="cuda", generator=cuda_gen))
    matvec.rmatvec(a, torch.ones(2, 300, device="cuda"))
    matvec.rmatvec(a[:, :100].contiguous(), torch.ones(2, 100, device="cuda"))
    matvec.matvec(a, torch.ones(2, 40, device="cuda"))
    gram.gram(a)
    assert ops.launch_counts() == {"ladder_stats": 2, "gram": 1,
                                   "matvec": 1, "rmatvec": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_reduced_precision_operands_widen_to_f32(cuda_gen, dtype):
    """bf16/fp16 gram operands are widened to f32 as they load; the plain
    version widens first too, so the f32 bound holds. The GEMVs take f32
    only in this slice and refuse the others."""
    a = torch.randn(2, 70, 45, device="cuda", generator=cuda_gen).to(dtype)
    x = torch.randn(2, 45, device="cuda", generator=cuda_gen).to(dtype)
    _close(gram.gram(a.mT), ref.gram_ref(a.mT), 45)
    _close(gram.gram(a), ref.gram_ref(a), 70)
    with pytest.raises(ValueError):
        matvec.matvec(a, x)

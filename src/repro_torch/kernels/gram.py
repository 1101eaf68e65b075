"""Tiled Gram products with f32 accumulation (counterpart of
``repro.kernels.gram``).

``gram_xy(x, y)`` is ``x^T y`` for ``(m, nx)``/``(m, ny)`` operands, or per
batch entry for operands with one or two leading batch axes (nodes, or
nodes and feature blocks); ``gram(a)`` is ``a^T a``. On CUDA tensors they
launch ``csrc/gram.cu``, which reads its operands through their strides:
``gram(A.mT)`` forms A A^T from the transposed view without copying A, and
the feature split's (N, M, m, nb) block view of A is one launch. When both
operands are one (:func:`same_operand`) the kernel computes only the tiles
on and above the diagonal and mirrors them. f32 operands take the CUDA-core
kernel; bf16 / fp16 ones the FP64 tensor-core kernel (exact products
summed in f64, rounded once), whose staging layouts and load path
:func:`half_path` picks. On CPU tensors they are the plain versions of
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import gram_xy_ref

_ENTRY = {torch.float32: "gram_xy_f32", torch.bfloat16: "gram_xy_bf16",
          torch.float16: "gram_xy_f16"}
_SIG = [build.P, build.P, build.P, build.I, build.I, build.I, build.I,
        build.I, *[build.L] * 8, build.I, build.P]
# the half-width entries take the path bits before the stream
_SIGNATURES = {name: _SIG if dt == torch.float32
               else [*_SIG[:-1], build.I, build.P]
               for dt, name in _ENTRY.items()}
# Mirrors of csrc/gram.cu's path bits (tests/test_torch_gram.py reads them
# from the source): X's k axis has unit stride, Y's does, 16-byte copies.
XK, YK, VEC = 1, 2, 4


def gram(a: torch.Tensor) -> torch.Tensor:
    """a^T a in f32; a (m, n), (N, m, n) or (N, M, m, n)."""
    return gram_xy(a, a)


def gram_xy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x^T y in f32; (m, nx), (m, ny) -> (nx, ny), with up to two leading
    batch axes shared by both."""
    if x.device.type == "cpu":
        return gram_xy_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gram_xy: no kernel for device {x.device}")
    return _launch(x, y)


def same_operand(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Whether x and y are one operand: the same tensor, or views of the same
    memory with the same start, shape, strides and type. An equal copy is
    another operand."""
    return x is y or (x.device == y.device and x.dtype == y.dtype
                      and x.data_ptr() == y.data_ptr()
                      and x.shape == y.shape and x.stride() == y.stride())


def launch_args(x: torch.Tensor, y: torch.Tensor) -> tuple[int, ...]:
    """The integer arguments of the C entry point for x^T y: (n_outer,
    n_inner, m, nx, ny, the four strides of x and of y as (outer, inner, k,
    column), symmetric). Raises ``ValueError`` on operands it does not
    take."""
    if x.ndim not in (2, 3, 4) or y.ndim != x.ndim:
        raise ValueError("gram_xy: operands must both be (m, n) with up to "
                         f"two leading batch axes, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if x.shape[:-1] != y.shape[:-1]:
        raise ValueError(f"gram_xy: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} do not share (batch..., m)")
    lead = 4 - x.ndim               # missing batch axes: size 1, stride 0
    n_outer, n_inner, m = (1,) * lead + tuple(x.shape[:-1])
    sx = (0,) * lead + x.stride()
    sy = (0,) * lead + y.stride()
    nx, ny = x.shape[-1], y.shape[-1]
    if (max(m, nx, ny) >= 2 ** 31 or n_outer * n_inner > 65_535
            or min(sx + sy) < 0):
        raise ValueError("gram_xy: sizes must fit int32 and the kernel's "
                         "grid, and strides must be nonnegative")
    return (n_outer, n_inner, m, nx, ny, *sx, *sy, int(same_operand(x, y)))


def half_path(x: torch.Tensor, y: torch.Tensor) -> int:
    """The path bits of the bf16 / fp16 kernel for x^T y (a pure function
    of shapes, strides and alignment): XK / YK when an operand's k axis has
    unit stride (it is staged [column][k], else [k][column]); VEC when both
    operands' unit-stride axes can be copied 16 bytes (8 elements) at a
    time: its other strides multiples of 8, its extent a multiple of 8 and
    its first element 16-byte aligned. Otherwise slices go through
    registers."""
    args = launch_args(x, y)
    m, nx, ny = args[2:5]
    path, vec = 0, True
    for bit, t, n, (so, sb, sk, sc) in ((XK, x, nx, args[5:9]),
                                        (YK, y, ny, args[9:13])):
        kf = sk == 1 and sc != 1
        if kf:
            path |= bit
        unit, ext, others = (sk, m, (so, sb, sc)) if kf else (sc, n,
                                                               (so, sb, sk))
        vec = vec and (unit == 1 and ext % 8 == 0
                       and all(s % 8 == 0 for s in others)
                       and t.data_ptr() % 16 == 0)
    return path | (VEC if vec else 0)


def _launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    build.require_cuda("gram_xy", x, y)
    if x.dtype not in _ENTRY or y.dtype != x.dtype:
        raise ValueError(f"gram_xy: the kernel takes one of {list(_ENTRY)} "
                         f"for both operands, got {x.dtype}, {y.dtype}")
    args = launch_args(x, y)
    out = torch.empty((*x.shape[:-2], x.shape[-1], y.shape[-1]),
                      dtype=torch.float32, device=x.device)
    if out.numel():
        lib = build.library("gram", _SIGNATURES)
        path = () if x.dtype == torch.float32 else (half_path(x, y),)
        rc = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), *args, *path,
            build.stream(x))
        build.check(rc, "gram_xy")
        build.count_launches("gram", _ENTRY[x.dtype].rsplit("_", 1)[1], 1)
    return out

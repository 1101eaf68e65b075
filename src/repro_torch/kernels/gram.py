"""Tiled Gram products with f32 accumulation (counterpart of
``repro.kernels.gram``).

``gram_xy(x, y)`` is ``x^T y`` for ``(m, nx)``/``(m, ny)`` operands, or per
node for ``(N, m, nx)``/``(N, m, ny)``; ``gram(a)`` is ``a^T a``. On CUDA
tensors they launch ``csrc/gram.cu``, which reads its operands through
their strides: ``gram(A.mT)`` forms A A^T from the transposed view without
copying A. On CPU tensors they are the plain versions of
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import gram_xy_ref

_ENTRY = {torch.float32: "gram_xy_f32", torch.bfloat16: "gram_xy_bf16",
          torch.float16: "gram_xy_f16"}
_SIG = [build.P, build.P, build.P, build.I, build.I, build.I, build.I,
        build.L, build.L, build.L, build.L, build.L, build.L, build.P]
_SIGNATURES = {name: _SIG for name in _ENTRY.values()}


def gram(a: torch.Tensor) -> torch.Tensor:
    """a^T a in f32; a (m, n) or (N, m, n)."""
    return gram_xy(a, a)


def gram_xy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x^T y in f32; (m, nx), (m, ny) -> (nx, ny), with an optional
    leading node axis on both."""
    if x.device.type == "cpu":
        return gram_xy_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"gram_xy: no kernel for device {x.device}")
    return _launch(x, y)


def _launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    build.require_cuda("gram_xy", x, y)
    if x.ndim not in (2, 3) or y.ndim != x.ndim:
        raise ValueError("gram_xy: operands must both be (m, n) or "
                         f"(N, m, n), got {tuple(x.shape)}, {tuple(y.shape)}")
    if x.dtype not in _ENTRY or y.dtype != x.dtype:
        raise ValueError(f"gram_xy: the kernel takes one of {list(_ENTRY)} "
                         f"for both operands, got {x.dtype}, {y.dtype}")
    batched = x.ndim == 3
    xb = x if batched else x[None]
    yb = y if batched else y[None]
    nb, m, nx = xb.shape
    if yb.shape[0] != nb or yb.shape[1] != m:
        raise ValueError(f"gram_xy: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} do not share (N, m)")
    ny = yb.shape[2]
    if max(m, nx, ny) >= 2 ** 31 or min(xb.stride() + yb.stride()) < 0:
        raise ValueError("gram_xy: sizes must fit int32 and strides must "
                         "be nonnegative")
    out = torch.empty((nb, nx, ny), dtype=torch.float32, device=x.device)
    if out.numel():
        lib = build.library("gram", _SIGNATURES)
        rc = getattr(lib, _ENTRY[x.dtype])(
            xb.data_ptr(), yb.data_ptr(), out.data_ptr(), nb, m, nx, ny,
            *xb.stride(), *yb.stride(), build.stream(x))
        build.check(rc, "gram_xy")
        build.LAUNCHES["gram"] += 1
    return out if batched else out[0]

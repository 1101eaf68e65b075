"""Matrix-vector products for the matrix-free x-update engines
(counterpart of ``repro.kernels.matvec``).

``matvec(a, x)`` is ``a @ x`` and ``rmatvec(a, y)`` is ``a^T @ y``, in f32:

* ``a`` (m, n) with ``x`` (n,) / (n, K) and ``y`` (m,) / (m, K), or
* ``a`` (N, m, n) with ``x`` (N, n) / (N, n, K) and ``y`` (N, m) / (N, m, K)
  — one product per node, in one launch.

On CUDA tensors they launch ``csrc/matvec.cu``; on CPU tensors they are the
plain versions. ``normal_matvec`` is the composition of the two, with the
intermediate cast of ``w`` to ``a.dtype`` that the JAX package makes
(``repro/kernels/matvec.py:186``).
"""
from __future__ import annotations

import torch

from . import build
from .ref import matvec_ref, rmatvec_ref

_SIGNATURES = {
    "matvec_f32": [build.P, build.P, build.P, build.I, build.I, build.I,
                   build.I, build.I, build.P],
    "rmatvec_f32": [build.P, build.P, build.P, build.P, build.I, build.I,
                    build.I, build.I, build.P],
    "rmatvec_rows_per_slice": [],
}


def matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w = a @ x in f32 (shapes in the module docstring)."""
    if a.device.type == "cpu":
        return matvec_ref(a, x)
    if a.device.type != "cuda":
        raise ValueError(f"matvec: no kernel for device {a.device}")
    return _launch(a, x, adjoint=False)


def rmatvec(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """g = a^T @ y in f32 (shapes in the module docstring)."""
    if a.device.type == "cpu":
        return rmatvec_ref(a, y)
    if a.device.type != "cuda":
        raise ValueError(f"rmatvec: no kernel for device {a.device}")
    return _launch(a, y, adjoint=True)


def normal_matvec(a: torch.Tensor, p: torch.Tensor, shift) -> torch.Tensor:
    """(A^T A + diag(shift)) p: w = A p, cast to a.dtype, then A^T w plus
    the shifted axpy, cast to a.dtype. ``shift`` is a scalar or an (n,)
    vector (broadcast over a leading node axis)."""
    w = matvec(a, p)
    g = rmatvec(a, w.to(a.dtype))
    return (g + shift * p.to(torch.float32)).to(a.dtype)


def _launch(a: torch.Tensor, v: torch.Tensor, *, adjoint: bool) -> torch.Tensor:
    name = "rmatvec" if adjoint else "matvec"
    build.require_cuda(name, a, v)
    if a.ndim not in (2, 3):
        raise ValueError(f"{name}: a must be (m, n) or (N, m, n), got "
                         f"{tuple(a.shape)}")
    if a.dtype != torch.float32 or v.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32 operands, got "
                         f"{a.dtype}, {v.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: a must be contiguous (row-major); the "
                         "wrapper does not copy the data matrix")
    one = v.ndim == a.ndim - 1
    if not one and v.ndim != a.ndim:
        raise ValueError(f"{name}: operand of shape {tuple(v.shape)} does "
                         f"not fit a of shape {tuple(a.shape)}")
    ab = a if a.ndim == 3 else a[None]
    vb = v[..., None] if one else v
    vb = vb if a.ndim == 3 else vb[None]
    N, m, n = ab.shape
    inner = m if adjoint else n
    if vb.shape[0] != N or vb.shape[1] != inner:
        raise ValueError(f"{name}: operand of shape {tuple(v.shape)} does "
                         f"not fit a of shape {tuple(a.shape)}")
    K = vb.shape[2]
    if max(m, n, K) >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit int32")
    vb = vb.contiguous()           # the small operand only, never a
    lib = build.library("matvec", _SIGNATURES)
    outer = n if adjoint else m
    out = torch.empty((N, outer, K), dtype=torch.float32, device=a.device)
    if out.numel():
        if adjoint:
            slices = -(-m // lib.rmatvec_rows_per_slice())
            part = torch.empty((slices, N, n, K) if slices > 1 else (0,),
                               dtype=torch.float32, device=a.device)
            rc = lib.rmatvec_f32(ab.data_ptr(), vb.data_ptr(),
                                 part.data_ptr(), out.data_ptr(), N, m, n, K,
                                 build.stream(a))
            launches = 1 + (slices > 1)     # rmatvec_kernel (+ sum_slices)
        else:
            vec = int(K == 1 and n % 4 == 0 and ab.data_ptr() % 16 == 0
                      and vb.data_ptr() % 16 == 0)
            rc = lib.matvec_f32(ab.data_ptr(), vb.data_ptr(), out.data_ptr(),
                                N, m, n, K, vec, build.stream(a))
            launches = 1
        build.check(rc, name)
        build.LAUNCHES[name] += launches
    if a.ndim == 2:
        out = out[0]
    return out[..., 0] if one else out

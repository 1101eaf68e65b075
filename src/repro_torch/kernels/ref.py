"""Plain PyTorch versions of every ported kernel — the CPU rows of the
registry and the oracles the CUDA kernels are held against
(counterpart of ``repro.kernels.ref``).

Each accepts an optional leading node axis: ``a`` of shape ``(m, n)`` or
``(N, m, n)`` with operands shaped to match.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def gram_ref(a: torch.Tensor) -> torch.Tensor:
    """A^T A in f32."""
    af = a.to(f32)
    return af.mT @ af


def gram_xy_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """X^T Y in f32."""
    return x.to(f32).mT @ y.to(f32)


def ladder_stats_ref(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """(2, B): [sum max(az - theta, 0); count(az > theta)]."""
    diff = az.to(f32)[:, None] - thetas.to(f32)[None, :]
    return torch.stack([torch.clamp_min(diff, 0.0).sum(0),
                        (diff > 0).to(f32).sum(0)])


def _vec_as_mat(a: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``v`` with a trailing right-hand-side axis (and whether it had none):
    a 1-D operand of a 2-D ``a``, or a 2-D operand of a 3-D ``a``."""
    one = v.ndim == a.ndim - 1
    return (v[..., None] if one else v), one


def matvec_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a @ x in f32; x is (n,) / (n, K) for 2-D a, (N, n) / (N, n, K) for
    3-D a."""
    x2, one = _vec_as_mat(a, x)
    out = a.to(f32) @ x2.to(f32)
    return out[..., 0] if one else out


def rmatvec_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a^T @ y in f32 (operand shapes as in :func:`matvec_ref`)."""
    y2, one = _vec_as_mat(a, y)
    out = a.to(f32).mT @ y2.to(f32)
    return out[..., 0] if one else out


def normal_matvec_ref(a: torch.Tensor, p: torch.Tensor, shift) -> torch.Tensor:
    """(A^T A + diag(shift)) p in f32, cast back to a.dtype."""
    pf = p.to(f32)
    w = matvec_ref(a, pf)
    return (rmatvec_ref(a, w) + shift * pf).to(a.dtype)

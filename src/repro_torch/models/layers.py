"""Shared neural building blocks (counterpart of ``repro.models.layers``).

Weights are drawn from a ``torch.Generator`` on the device they live on:
a dense (d_in, d_out) map is an ``nn.Linear`` without bias, whose weight is
stored (d_out, d_in) and drawn N(0, 1/d_in) in f32, then cast; embedding
tables are N(0, 1). The two frameworks draw different numbers from one
seed, so a test that compares them converts the JAX package's parameters
(:func:`repro_torch.convert.lm_params_from_jax`). With ``generator=None``
the weights are left unset for such a converter to fill.

Norms and RoPE compute in f32 and cast back, as the JAX package does; the
RoPE angle is always f32 (a bf16 angle at position 2,000 is off by whole
radians).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

f32 = torch.float32


# ------------------------------------------------------------------- init --
def _normal(shape, generator, device, dtype, scale: float) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=device, dtype=f32)
    return x.mul_(scale).to(dtype)


def dense_init(generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> nn.Linear:
    """x @ W for W of shape (d_in, d_out), as an ``nn.Linear`` (weight
    (d_out, d_in)) drawn N(0, scale^2), scale = 1/sqrt(d_in) by default."""
    lin = nn.Linear(d_in, d_out, bias=False, device="meta", dtype=dtype)
    lin = lin.to_empty(device=device).requires_grad_(False)
    if generator is not None:
        scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
        lin.weight.copy_(_normal((d_out, d_in), generator, device, dtype,
                                 scale))
    return lin


def embed_init(generator, vocab: int, d: int, dtype, device) -> torch.Tensor:
    """A (vocab, d) table drawn N(0, 1) (unset with ``generator=None``)."""
    if generator is None:
        return torch.empty((vocab, d), dtype=dtype, device=device)
    return _normal((vocab, d), generator, device, dtype, 1.0)


def norm_init(d: int, dtype, device) -> nn.Parameter:
    """An RMS-norm weight w, applied as (1 + w): zeros."""
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                        requires_grad=False)


# ------------------------------------------------------------------- norms --
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + w) over the last axis, in f32, cast to x.dtype."""
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.to(f32))).to(x.dtype)


# -------------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, theta: float,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., head_dim/2), angles in f32."""
    exps = torch.arange(0, head_dim, 2, dtype=f32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions.to(f32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x (..., S, H, Dh) by cos/sin (..., S, Dh/2),
    broadcast over heads."""
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ SwiGLU --
class MLP(nn.Module):
    """SwiGLU: w_down(silu(w_gate(x)) * w_up(x))."""

    def __init__(self, d: int, f: int, *, generator, dtype, device):
        super().__init__()
        self.w_gate = dense_init(generator, d, f, dtype, device)
        self.w_up = dense_init(generator, d, f, dtype, device)
        self.w_down = dense_init(generator, f, d, dtype, device)


def mlp_init(generator, d: int, f: int, dtype, device) -> MLP:
    return MLP(d, f, generator=generator, dtype=dtype, device=device)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    return p.w_down(F.silu(p.w_gate(x)) * p.w_up(x))

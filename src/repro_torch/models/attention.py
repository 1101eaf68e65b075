"""Grouped-query self-attention: full, flash and decode (counterpart of
``repro.models.attention``).

``attention(impl="flash")`` — the counterpart of the JAX package's
``impl="pallas"``, and what ``"auto"`` means here — and the prefill's
``attention_with_cache`` run the causal self-attention through
:func:`repro_torch.kernels.ops.flash_attention`, which launches the
hand-written CUDA kernel on the card. ``impl="full"`` is the plain
``_sdpa_full``. One-token decoding stays plain PyTorch: an einsum and a
softmax over the cache written so far, as the JAX package computes it
outside any kernel. Each function takes the RoPE table ``rope`` (cos, sin
of :func:`rope_table`) from its caller, which computes it once for every
layer, or computes it itself when given none. The sharding constraints of
the JAX module are the
identity without a mesh and are left out; the memory-chunked
``_sdpa_chunked`` comes with the training path.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from .layers import apply_rope, dense_init, norm_init, rms_norm, rope_freqs

NEG_INF = -1e30
f32 = torch.float32


class Attention(nn.Module):
    """wq, wk, wv, wo, and the per-head q/k norms when ``cfg.qk_norm``."""

    def __init__(self, cfg: ModelConfig, *, generator, dtype, device):
        super().__init__()
        D, Hq, Hkv, Dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim)
        self.wq = dense_init(generator, D, Hq * Dh, dtype, device)
        self.wk = dense_init(generator, D, Hkv * Dh, dtype, device)
        self.wv = dense_init(generator, D, Hkv * Dh, dtype, device)
        self.wo = dense_init(generator, Hq * Dh, D, dtype, device)
        if cfg.qk_norm:
            self.q_norm = norm_init(Dh, dtype, device)
            self.k_norm = norm_init(Dh, dtype, device)


def attn_init(generator, cfg: ModelConfig, dtype, device) -> Attention:
    return Attention(cfg, generator=generator, dtype=dtype, device=device)


def rope_table(cfg: ModelConfig, positions: torch.Tensor):
    """cos, sin of ``positions`` (B or 1, S) at the model's head dim."""
    return rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, positions)


def _project_qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, rope):
    """q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh); qk-norm before RoPE."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = p.wq(x).view(B, S, Hq, Dh)
    k = p.wk(x).view(B, S, Hkv, Dh)
    v = p.wv(x).view(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm)
        k = rms_norm(k, p.k_norm)
    cos, sin = rope
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _repeat_kv(k: torch.Tensor, Hq: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, Hq, Dh), each KV head repeated for its
    group of query heads."""
    G = Hq // k.shape[2]
    return k if G == 1 else k.repeat_interleave(G, dim=2)


def _sdpa_full(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh); f32
    softmax, weights cast to q.dtype before the product with v."""
    B, Sq, Hq, Dh = q.shape
    k = _repeat_kv(k, Hq)
    v = _repeat_kv(v, Hq)
    scale = 1.0 / math.sqrt(Dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(f32) * scale
    if causal:
        Sk = k.shape[1]
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        mask = qpos >= torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _causal_attention(q, k, v, impl: str) -> torch.Tensor:
    if impl in ("flash", "auto"):
        return kops.flash_attention(q, k, v, causal=True)
    if impl == "full":
        return _sdpa_full(q, k, v, causal=True)
    raise ValueError(f"attention impl must be 'flash', 'full' or 'auto', "
                     f"got {impl!r}")


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "auto", rope=None) -> torch.Tensor:
    """Causal self-attention over x (B, S, D); returns (B, S, D)."""
    return attention_with_cache(p, cfg, x, impl=impl, rope=rope)[0]


def attention_with_cache(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
                         impl: str = "flash", rope=None):
    """Prefill: causal self-attention as :func:`attention`, and the (k, v)
    of every position for the cache."""
    B, S, _ = x.shape
    if rope is None:
        rope = rope_table(cfg, torch.arange(S, device=x.device)[None, :])
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = _causal_attention(q, k, v, impl)
    return p.wo(out.reshape(B, S, -1)), (k, v)


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                     *, rope=None):
    """One-token decode. x (B, 1, D); cache (B, Smax, Hkv, Dh).

    Writes the new k/v at ``pos`` in place (in the cache dtype) and attends
    over ``cache[:, :pos + 1]``. Query head h reads KV head h // G without
    repeating the cache."""
    B = x.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pos = int(pos)
    if rope is None:
        rope = rope_table(cfg, torch.full((1, 1), pos, device=x.device))
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    cache_k[:, pos] = k_new[:, 0]
    cache_v[:, pos] = v_new[:, 0]
    kx = cache_k[:, :pos + 1].to(x.dtype)
    vx = cache_v[:, :pos + 1].to(x.dtype)
    qg = q.view(B, 1, Hkv, Hq // Hkv, Dh)
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kx).to(f32) * scale
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, vx).reshape(B, 1, Hq * Dh)
    return p.wo(out), cache_k, cache_v

"""The decoder-only dense LM and the hybrid (Zamba2) LM (counterparts of
the dense and hybrid parts of ``repro.models.transformer``).

A plain loop over the layers: no remat, no scan, no sharding
constraints. The dense KV cache is {"k", "v"}, each (L, B, max_seq, Hkv,
Dh) in the configuration's cache dtype; the prefill writes positions
[0, S) of a zeroed cache and a decode step writes position ``pos`` in
place, giving the values of the JAX package's functions. Each pass
computes the RoPE table once and hands it to every layer.

The hybrid LM is G = n_layers / attn_every groups of ``attn_every`` Mamba2
layers, each group followed by one attention + MLP block whose weights all
groups share. Its cache holds each Mamba2 layer's SSD state ``ssm_h``
(G, A, B, H, P, ds) in f32 and conv inputs ``ssm_conv`` (G, A, B, K-1,
conv_dim), and each shared-block application's ``k`` / ``v`` (G, B,
max_seq, Hkv, Dh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .attention import (attention, attention_with_cache, attn_init,
                        decode_attention, rope_table)
from .layers import embed_init, mlp_apply, mlp_init, norm_init, rms_norm
from .ssm import mamba_block, mamba_init, mamba_state_init, mamba_step


class Block(nn.Module):
    """norm1, attention, norm2, SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, generator, dtype, device):
        super().__init__()
        self.norm1 = norm_init(cfg.d_model, dtype, device)
        self.attn = attn_init(generator, cfg, dtype, device)
        self.norm2 = norm_init(cfg.d_model, dtype, device)
        self.mlp = mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device)


class LM(nn.Module):
    """Token embedding, the blocks, the final norm and the LM head over
    the padded vocabulary (``cfg.padded_vocab``)."""

    def __init__(self, cfg: ModelConfig, *, generator, dtype, device):
        super().__init__()
        self.blocks = nn.ModuleList(
            block_init(generator, cfg, dtype, device)
            for _ in range(cfg.n_layers))
        self.embed = nn.Parameter(
            embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                       device), requires_grad=False)
        self.final_norm = norm_init(cfg.d_model, dtype, device)
        self.lm_head = nn.Parameter(
            embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                       device), requires_grad=False)


def block_init(generator, cfg: ModelConfig, dtype, device) -> Block:
    return Block(cfg, generator=generator, dtype=dtype, device=device)


def _ffn(p: Block, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward (the dense MLP; the JAX package's MoE branch
    and its auxiliary loss come with the MoE family)."""
    return mlp_apply(p.mlp, h)


def block_apply(p: Block, cfg: ModelConfig, x: torch.Tensor, *,
                rope=None) -> torch.Tensor:
    """One block over the whole sequence (inference)."""
    x = x + attention(p.attn, cfg, rms_norm(x, p.norm1), rope=rope)
    return x + _ffn(p, cfg, rms_norm(x, p.norm2))


def lm_init(generator, cfg: ModelConfig, dtype, device) -> LM:
    return LM(cfg, generator=generator, dtype=dtype, device=device)


def _embed_tokens(p: LM, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p.embed)


def _lm_logits(p: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return rms_norm(h, p.final_norm) @ p.lm_head.T


def _prompt_rope(cfg: ModelConfig, tokens: torch.Tensor):
    return rope_table(cfg, torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :])


def lm_forward(p: LM, cfg: ModelConfig,
               tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> final-normed hidden states (B, S, D)."""
    h = _embed_tokens(p, cfg, tokens)
    rope = _prompt_rope(cfg, tokens)
    for blk in p.blocks:
        h = block_apply(blk, cfg, h, rope=rope)
    return rms_norm(h, p.final_norm)


def lm_cache_init(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                  device) -> dict[str, torch.Tensor]:
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_prefill(p: LM, cfg: ModelConfig, tokens: torch.Tensor, cache_dtype,
               max_seq: int | None = None, *, impl: str = "flash"):
    """tokens (B, S) -> the last position's logits (B, 1, padded vocab) and
    the cache of every layer's k/v at positions [0, S)."""
    h = _embed_tokens(p, cfg, tokens)
    B, S = tokens.shape
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt, {S}")
    cache = lm_cache_init(cfg, B, max_seq, cache_dtype, h.device)
    rope = _prompt_rope(cfg, tokens)
    for i, blk in enumerate(p.blocks):
        out, (k, v) = attention_with_cache(blk.attn, cfg,
                                           rms_norm(h, blk.norm1), impl=impl,
                                           rope=rope)
        h = h + out
        h = h + _ffn(blk, cfg, rms_norm(h, blk.norm2))
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return _lm_logits(p, cfg, h[:, -1:]), cache


def lm_decode_step(p: LM, cfg: ModelConfig, token: torch.Tensor, pos: int,
                   cache: dict[str, torch.Tensor]):
    """One-token decode. token (B, 1); writes position ``pos`` of every
    layer's cache in place; returns logits (B, 1, padded vocab) and the
    cache."""
    h = _embed_tokens(p, cfg, token)
    rope = rope_table(cfg, torch.full((1, 1), int(pos), device=h.device))
    for i, blk in enumerate(p.blocks):
        out, _, _ = decode_attention(blk.attn, cfg, rms_norm(h, blk.norm1),
                                     cache["k"][i], cache["v"][i], pos,
                                     rope=rope)
        h = h + out
        h = h + _ffn(blk, cfg, rms_norm(h, blk.norm2))
    return _lm_logits(p, cfg, h), cache


# ------------------------------------------------------ hybrid (Zamba2) --
class MambaLayer(nn.Module):
    """A pre-norm Mamba2 layer: ``norm`` and ``mamba``."""

    def __init__(self, cfg: ModelConfig, *, generator, dtype, device):
        super().__init__()
        self.norm = norm_init(cfg.d_model, dtype, device)
        self.mamba = mamba_init(generator, cfg, dtype, device)


class HybridLM(nn.Module):
    """Token embedding, ``groups`` (G ``nn.ModuleList``s of ``attn_every``
    Mamba2 layers), the ``shared`` attention + MLP block, the final norm
    and the LM head."""

    def __init__(self, cfg: ModelConfig, *, generator, dtype, device):
        super().__init__()
        if not cfg.attn_every or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        self.groups = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, generator=generator, dtype=dtype,
                                     device=device)
                          for _ in range(cfg.attn_every))
            for _ in range(cfg.n_layers // cfg.attn_every))
        self.embed = nn.Parameter(
            embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                       device), requires_grad=False)
        self.shared = block_init(generator, cfg, dtype, device)
        self.final_norm = norm_init(cfg.d_model, dtype, device)
        self.lm_head = nn.Parameter(
            embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                       device), requires_grad=False)


def hybrid_init(generator, cfg: ModelConfig, dtype, device) -> HybridLM:
    return HybridLM(cfg, generator=generator, dtype=dtype, device=device)


def hybrid_forward(p: HybridLM, cfg: ModelConfig,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> final-normed hidden states (B, S, D)."""
    h = _embed_tokens(p, cfg, tokens)
    rope = _prompt_rope(cfg, tokens)
    for group in p.groups:
        for layer in group:
            h = h + mamba_block(layer.mamba, cfg, rms_norm(h, layer.norm))
        h = block_apply(p.shared, cfg, h, rope=rope)
    return rms_norm(h, p.final_norm)


def hybrid_cache_init(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                      device) -> dict[str, torch.Tensor]:
    G, A = cfg.n_layers // cfg.attn_every, cfg.attn_every
    h0, conv0 = mamba_state_init(cfg, batch, dtype, device)
    kv = (G, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"ssm_h": h0.new_zeros((G, A, *h0.shape)),
            "ssm_conv": conv0.new_zeros((G, A, *conv0.shape)),
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def hybrid_prefill(p: HybridLM, cfg: ModelConfig, tokens: torch.Tensor,
                   cache_dtype, max_seq: int | None = None, *,
                   impl: str = "flash"):
    """tokens (B, S) -> the last position's logits (B, 1, padded vocab) and
    the cache: every Mamba2 layer's final state and conv inputs, and each
    shared-block application's k/v at positions [0, S). S must be at most
    128 (one SSD chunk) or a multiple of it."""
    h = _embed_tokens(p, cfg, tokens)
    B, S = tokens.shape
    max_seq = max_seq or S
    if max_seq < S:
        raise ValueError(f"max_seq {max_seq} is shorter than the prompt, {S}")
    cache = hybrid_cache_init(cfg, B, max_seq, cache_dtype, h.device)
    rope = _prompt_rope(cfg, tokens)
    shared = p.shared
    for g, group in enumerate(p.groups):
        for a, layer in enumerate(group):
            out, (ssm_h, conv) = mamba_block(
                layer.mamba, cfg, rms_norm(h, layer.norm), return_state=True)
            h = h + out
            cache["ssm_h"][g, a] = ssm_h
            cache["ssm_conv"][g, a] = conv
        out, (k, v) = attention_with_cache(shared.attn, cfg,
                                           rms_norm(h, shared.norm1),
                                           impl=impl, rope=rope)
        h = h + out
        h = h + _ffn(shared, cfg, rms_norm(h, shared.norm2))
        cache["k"][g, :, :S] = k
        cache["v"][g, :, :S] = v
    return _lm_logits(p, cfg, h[:, -1:]), cache


def hybrid_decode_step(p: HybridLM, cfg: ModelConfig, token: torch.Tensor,
                       pos: int, cache: dict[str, torch.Tensor]):
    """One-token decode. token (B, 1); updates every Mamba2 layer's state
    and writes position ``pos`` of each group's k/v, in place; returns
    logits (B, 1, padded vocab) and the cache."""
    h = _embed_tokens(p, cfg, token)
    rope = rope_table(cfg, torch.full((1, 1), int(pos), device=h.device))
    shared = p.shared
    for g, group in enumerate(p.groups):
        for a, layer in enumerate(group):
            out, (ssm_h, conv) = mamba_step(
                layer.mamba, cfg, rms_norm(h, layer.norm),
                (cache["ssm_h"][g, a], cache["ssm_conv"][g, a]))
            h = h + out
            cache["ssm_h"][g, a] = ssm_h
            cache["ssm_conv"][g, a] = conv
        out, _, _ = decode_attention(shared.attn, cfg,
                                     rms_norm(h, shared.norm1),
                                     cache["k"][g], cache["v"][g], pos,
                                     rope=rope)
        h = h + out
        h = h + _ffn(shared, cfg, rms_norm(h, shared.norm2))
    return _lm_logits(p, cfg, h), cache

"""Architecture registry: ``get_config(name)``, ``reduced_config`` and
``ARCH_NAMES`` (a copy of ``repro.configs`` as data; the port imports
nothing of the JAX package)."""
from __future__ import annotations

import dataclasses

from .base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "minitron-4b": "minitron_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-8b": "qwen3_8b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-1b": "internvl2_1b",
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
                   vocab: int = 512) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    scale = d_model / cfg.d_model
    heads = max(2, min(cfg.n_heads, 4)) if cfg.n_heads else 0
    kv = max(1, min(cfg.n_kv_heads, 2)) if cfg.n_kv_heads else 0
    if cfg.family == "hybrid":
        heads, kv = 2, 2
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        n_enc_layers=min(cfg.n_enc_layers, n_layers),
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=(d_model // heads) if heads else 0,
        d_ff=max(32, int(cfg.d_ff * scale) // 8 * 8),
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, 8),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state or cfg.family == "ssm" else cfg.ssm_head_dim,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        frontend_len=min(cfg.frontend_len, 8) if cfg.frontend else 0,
        dtype="float32",
    )


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: which (arch x shape) cells run (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k needs sub-quadratic attention; " \
                      f"{cfg.name} is full-attention (documented skip)"
    return True, ""

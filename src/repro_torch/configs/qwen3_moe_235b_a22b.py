"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-235B-A22B family; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    n_experts=128, experts_per_token=8,
    notes="MoE d_ff is per-expert intermediate size (1536).")

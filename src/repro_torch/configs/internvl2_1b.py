"""internvl2-1b — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655,
InternViT frontend stubbed, Qwen2-0.5B-style LM backbone.
[arXiv:2404.16821; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655, rope_theta=1e6,
    frontend="patch", frontend_len=256,
    notes="Vision patches arrive as precomputed embeddings "
          "(frontend stub per assignment).")

"""zamba2-2.7b — 54L Mamba2 d_model=2560 + shared attention block
(32H kv=32, d_ff=10240), vocab=32000, ssm_state=64. [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, conv_kernel=4, attn_every=6, rope_theta=1e4,
    notes="One SHARED full-attention+MLP block applied every 6 Mamba2 "
          "layers (Zamba2-style weight sharing).")

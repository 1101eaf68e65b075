"""rwkv6-1.6b (Finch) — 24L d_model=2048, attention-free, data-dependent
decay, d_ff=7168, vocab=65536. [arXiv:2404.05892; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab_size=65536, ssm_state=64, ssm_head_dim=64,
    notes="RWKV6 time-mix/channel-mix; decode state is O(1) per layer "
          "(no KV cache). long_500k exercises the recurrent path.")

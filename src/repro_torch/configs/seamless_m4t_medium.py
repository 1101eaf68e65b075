"""seamless-m4t-medium — enc-dec 12L+12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206, multimodal (audio frontend stubbed).
[arXiv:2308.11596; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=256206, rope_theta=1e4,
    frontend="audio",
    notes="Encoder-decoder backbone; audio frames arrive as precomputed "
          "embeddings (frontend stub per assignment). train_4k splits "
          "seq_len into enc/dec halves.")

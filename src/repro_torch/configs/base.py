"""Config system: model architectures and input shapes (a copy of
``repro.configs.base`` without its TPU hardware constants)."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int            # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    # --- MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2) / linear attention (rwkv6)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    # --- hybrid: one shared attention block applied every `attn_every`
    #     ssm layers (Zamba2-style shared block)
    attn_every: int = 0
    # --- encoder-decoder
    n_enc_layers: int = 0
    # --- modality frontend stub ("patch" | "audio"); embeddings are inputs
    frontend: str = ""
    frontend_len: int = 256
    # --- numerics
    dtype: str = "bfloat16"
    cache_dtype: str = ""     # KV-cache dtype; "" -> dtype (e.g. fp8:
                              # "float8_e4m3fn" halves decode HBM)
    notes: str = ""

    @property
    def resolved_cache_dtype(self) -> str:
        return self.cache_dtype or self.dtype

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style) so embedding
        and lm_head shard over any tp size up to 256; logits for padded
        ids are masked to -inf in the loss."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:          # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the long_500k shape (DESIGN.md §4)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS = 6*N*D)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        Hd = self.resolved_head_dim
        per_layer = 0
        if self.family in ("dense", "moe", "encdec", "vlm", "audio"):
            attn = D * Hd * self.n_heads + 2 * D * Hd * self.n_kv_heads \
                + Hd * self.n_heads * D
            per_layer += attn + 2 * D                       # attn + norms
            if self.family == "moe":
                per_layer += self.n_experts * 3 * D * F + D * self.n_experts
            else:
                per_layer += 3 * D * F
        if self.family in ("ssm", "hybrid"):
            di = self.d_inner
            if self.name.startswith("rwkv"):
                # time-mix: r,k,v,g,w,o projections + channel-mix
                per_layer += 5 * D * D + D * D + 2 * D * F + 2 * D
            else:  # mamba2
                nh = self.n_ssm_heads
                in_proj = D * (2 * di + 2 * self.ssm_state * 1 + nh)
                per_layer += in_proj + di * D + di * self.conv_kernel + 2 * D
        total = L * per_layer
        if self.family == "hybrid" and self.attn_every:
            attn = D * Hd * self.n_heads + 2 * D * Hd * self.n_kv_heads \
                + Hd * self.n_heads * D + 3 * D * F + 2 * D
            total += attn                                    # one shared block
        if self.family in ("encdec",):
            # decoder cross-attention (per decoder layer)
            total += self.n_layers * (2 * D * Hd * self.n_kv_heads
                                      + 2 * D * Hd * self.n_heads)
        emb = V * D * (1 if self.tie_embeddings else 2)
        return int(total + emb + D)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense_total = self.param_count() - L * (self.n_experts * 3 * D * F)
        return int(dense_total + L * self.experts_per_token * 3 * D * F)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}

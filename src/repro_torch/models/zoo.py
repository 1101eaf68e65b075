"""Model-zoo entry points of the port (counterpart of
``repro.models.zoo``), one per serving stage:

    init_params(cfg, generator=g, device=None) -> LM or HybridLM module
    init_cache(cfg, batch, max_seq, device=None) -> the cache dict
    forward(params, cfg, batch)             -> (logits (B, S, V), aux)
    prefill(params, cfg, batch, max_seq)    -> (logits_last, cache)
    decode_step(params, cfg, batch, cache)  -> (logits, cache)

``batch`` holds ``tokens`` (B, S) for forward and prefill, and ``token``
(B, 1) with ``pos`` for a decode step. The dense and hybrid (Zamba2)
families run, dispatched on ``cfg.family`` as in the JAX package; the
others raise :class:`CapabilityError` naming the ROADMAP item that ports
them. ``device=None`` means the card, as everywhere in the
port: without one the call raises unless ``device="cpu"`` is given. The
serving entry points run under ``torch.inference_mode()`` and take the
device of ``params``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import CapabilityError, resolve_device
from . import transformer as tfm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
PORTED = ("dense", "hybrid")
_LATER = {
    "vlm": "ROADMAP Queue 1 item 14.1 (the vlm patch prefix)",
    "moe": "ROADMAP Queue 1 item 14.2 (MoE)",
    "ssm": "ROADMAP Queue 1 item 14.3 (RWKV)",
    "audio": "ROADMAP Queue 1 item 14.4 (encoder-decoder)",
    "encdec": "ROADMAP Queue 1 item 14.4 (encoder-decoder)",
}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a configuration's dtype name."""
    return _DTYPES[name]


def _hybrid(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` is of the hybrid family; raises
    :class:`CapabilityError` for a family the port does not run."""
    if cfg.family not in PORTED:
        raise CapabilityError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"yet ({_LATER.get(cfg.family, 'ROADMAP Queue 1 item 14')}); "
            f"the families {PORTED} run")
    return cfg.family == "hybrid"


Model = tfm.LM | tfm.HybridLM


def _device_of(params: Model) -> torch.device:
    return params.embed.device


def _tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


# ----------------------------------------------------------------- init --
def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Model:
    """The LM's parameters in ``cfg.dtype``, drawn from ``generator``
    (which must live on ``device``)."""
    init = tfm.hybrid_init if _hybrid(cfg) else tfm.lm_init
    dev = resolve_device(device)
    with torch.no_grad():
        return init(generator, cfg, dtype_of(cfg.dtype), dev)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device=None) -> dict[str, torch.Tensor]:
    """A zeroed cache in the configuration's cache dtype (the hybrid
    family's SSD states in f32)."""
    init = tfm.hybrid_cache_init if _hybrid(cfg) else tfm.lm_cache_init
    return init(cfg, batch, max_seq, dtype_of(cfg.resolved_cache_dtype),
                resolve_device(device))


# -------------------------------------------------------------- forward --
@torch.inference_mode()
def forward_hidden(params: Model, cfg: ModelConfig, batch: dict):
    """Final-normed hidden states (B, S, D) and the auxiliary loss, 0 for
    the dense and hybrid families (a tensor, as the JAX package returns
    it)."""
    fwd = tfm.hybrid_forward if _hybrid(cfg) else tfm.lm_forward
    h = fwd(params, cfg, _tokens(batch["tokens"], _device_of(params)))
    return h, torch.zeros((), device=h.device)


@torch.inference_mode()
def forward(params: Model, cfg: ModelConfig, batch: dict):
    """Full logits (B, S, vocab_size) and the auxiliary loss."""
    h, aux = forward_hidden(params, cfg, batch)
    logits = h @ params.lm_head.T
    return logits[..., :cfg.vocab_size], aux


# ---------------------------------------------------------------- serve --
@torch.inference_mode()
def prefill(params: Model, cfg: ModelConfig, batch: dict,
            max_seq: int | None = None, *, impl: str = "flash"):
    """The prompt's last-position logits (B, 1, padded vocab) and a cache
    of ``max_seq`` positions holding the prompt's k/v (and, for the hybrid
    family, every Mamba2 layer's state after the prompt). ``impl="full"``
    runs the plain attention in place of the flash kernel."""
    run = tfm.hybrid_prefill if _hybrid(cfg) else tfm.lm_prefill
    return run(params, cfg, _tokens(batch["tokens"], _device_of(params)),
               dtype_of(cfg.resolved_cache_dtype), max_seq, impl=impl)


@torch.inference_mode()
def decode_step(params: Model, cfg: ModelConfig, batch: dict,
                cache: dict[str, torch.Tensor]):
    """One token per sequence at position ``batch["pos"]``: logits
    (B, 1, padded vocab); the cache is updated in place and returned."""
    step = tfm.hybrid_decode_step if _hybrid(cfg) else tfm.lm_decode_step
    return step(params, cfg, _tokens(batch["token"], _device_of(params)),
                int(batch["pos"]), cache)

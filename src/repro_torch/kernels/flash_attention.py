"""Causal (or full) flash attention with grouped-query heads, forward
(counterpart of ``repro.kernels.flash_attention``).

``flash_attention_flat(q, k, v)`` takes the flat head-major layout: q
(BHq, Sq, Dh) and k/v (BHkv, Sk, Dh), query row b reading KV row
b // (BHq / BHkv). On CUDA tensors it launches ``csrc/flash_attention.cu``
(one kernel per call; Dh a multiple of 16 up to 128, ``HEAD_DIMS``; f32
softmax state inside, output in q.dtype): bf16 operands on the tensor cores
(wgmma, K and V brought in by TMA; a head dim between the multiples of 64,
such as zamba2-2.7b's 80, runs the 128-column kernel on zero-filled
columns), f32 on the CUDA cores. Any other head dim, operand
type or layout raises. On CPU tensors it is the plain version of
:mod:`repro_torch.kernels.ref`. Both keep the JAX contract at its default
``block_k`` of 128: a non-causal call whose Sk is above 128 and not a
multiple of it raises ``ValueError``, though the kernels (ragged edges
masked inside) would not need it.
"""
from __future__ import annotations

import math

import torch

from . import build
from .ref import flash_attention_flat_ref

HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
BLOCK_K = 128          # the JAX function's default key block
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_SIG = [build.P, build.P, build.P, build.P, build.I, build.I, build.I,
        build.I, build.I, build.F, build.I, build.P]
_SIGNATURES = {name: _SIG for name in _ENTRY.values()}


def check_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool) -> None:
    """Raise ``ValueError`` on operands that ``flash_attention_flat`` does
    not take, on either device."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError("flash_attention: q must be (BHq, Sq, Dh) and k, v "
                         f"(BHkv, Sk, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, _, Dh = q.shape
    BHkv, Sk, _ = k.shape
    if k.shape[2] != Dh or BHkv == 0 or BH % BHkv:
        raise ValueError(f"flash_attention: {BH} query rows cannot share "
                         f"{BHkv} KV rows of head dim {k.shape[2]} (Dh {Dh})")
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if not causal and Sk % min(BLOCK_K, Sk):
        raise ValueError("non-causal path needs Sk divisible by block_k")


def flash_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Attention of q over k, v in the flat layout (module docstring)."""
    check_flat(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_flat_ref(q, k, v, causal=causal,
                                        sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, sm_scale)


def _launch(q, k, v, causal, sm_scale) -> torch.Tensor:
    build.require_cuda("flash_attention", q, k, v)
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: the kernel takes one of "
                         f"{list(_ENTRY)} for q, k and v, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    BH, Sq, Dh = q.shape
    BHkv, Sk, _ = k.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {Dh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start "
                         "16-byte aligned (the tensor-core kernel's TMA "
                         "copies need it)")
    if BH > 65_535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"flash_attention: {BH} query rows of length {Sq} "
                         "exceed the kernel's grid")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    out = torch.empty_like(q)
    if out.numel():
        lib = build.library("flash_attention", _SIGNATURES)
        rc = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq,
            Sk, Dh, BH // BHkv, float(scale), int(causal), build.stream(q))
        build.check(rc, "flash_attention")
        build.LAUNCHES["flash_attention"] += 1
    return out

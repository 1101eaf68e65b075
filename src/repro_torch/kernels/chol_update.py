"""Rank-k Cholesky updates and downdates on the card (the counterpart of
``repro.core.prox._chol_rank1`` under ``chol_update`` / ``chol_downdate``,
a ``lax.fori_loop`` in the JAX package, not a Pallas kernel).

``chol_rank_update(L, V, sign) -> (L', ok)``: L' L'^T = L L^T + sign V V^T
for a lower factor L (n, n) and V (n, k) or (n,), sign +1 (update) or -1
(downdate); ``ok`` (a 0-d bool on L's device) is False once a pivot lost
definiteness. On a CUDA f32 tensor it is ``csrc/chol_update.cu``: one
cooperative launch for up to ``MAX_K`` rotations (a larger k takes
ceil(k / MAX_K) launches, in order), the result equal to the plain version
bit for bit. On a CPU tensor it is the plain version,
:func:`repro_torch.kernels.ref.chol_rank_update_ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import chol_rank_update_ref

_SIGNATURES = {
    "chol_rank_update_f32": [build.P, build.P, build.I, build.I, build.I,
                             build.F, build.P, build.P, build.P],
}
# Mirrors of csrc/chol_update.cu's constants: rows a CTA (one a thread) and
# rotations a launch (the CTA's rows of V in shared memory)
ROWS = 64
MAX_K = 800


def chol_rank_update(L: torch.Tensor, V: torch.Tensor, sign: float):
    """(L', ok): the rank-k update (``sign`` +1) or downdate (-1) of the
    lower factor ``L`` by the columns of ``V``; L is not modified."""
    if sign not in (1.0, -1.0):
        raise ValueError(f"chol_rank_update: sign must be +1 or -1, got "
                         f"{sign!r}")
    if L.device.type == "cpu":
        return chol_rank_update_ref(L, V, float(sign))
    if L.device.type != "cuda":
        raise ValueError(f"chol_rank_update: no kernel for device "
                         f"{L.device}")
    build.require_cuda("chol_rank_update", L, V)
    n = L.shape[0]
    if L.ndim != 2 or L.shape[1] != n or V.shape[0] != n or V.ndim > 2:
        raise ValueError(f"chol_rank_update: L must be (n, n) and V (n, k) "
                         f"or (n,), got {tuple(L.shape)} and "
                         f"{tuple(V.shape)}")
    if L.dtype != torch.float32 or V.dtype != torch.float32:
        raise ValueError(f"chol_rank_update: the kernel takes float32, got "
                         f"{L.dtype} and {V.dtype}")
    V = V.reshape(n, -1).contiguous()
    k = V.shape[1]
    out = L.contiguous().clone()
    ok = torch.ones((), dtype=torch.int32, device=L.device)
    if n == 0 or k == 0:
        return out, ok.bool()
    cs = torch.empty(4 * min(k, MAX_K), dtype=torch.float32,
                     device=L.device)
    lib = build.library("chol_update", _SIGNATURES)
    for p0 in range(0, k, MAX_K):
        kc = min(MAX_K, k - p0)
        rc = lib.chol_rank_update_f32(
            out.data_ptr(), V.data_ptr() + 4 * p0, n, kc, k, float(sign),
            cs.data_ptr(), ok.data_ptr(), build.stream(L))
        build.check(rc, "chol_rank_update")
        build.LAUNCHES["chol_rank_update"] += 1
    return out, ok.bool()

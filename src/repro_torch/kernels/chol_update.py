"""Rank-k Cholesky updates and downdates on the card (the counterpart of
``repro.core.prox._chol_rank1`` under ``chol_update`` / ``chol_downdate``,
a ``lax.fori_loop`` in the JAX package, not a Pallas kernel).

``chol_rank_update(L, V, sign) -> (L', ok)``: L' L'^T = L L^T + sign V V^T
for a lower factor L (n, n) and V (n, k) or (n,), sign +1 (update) or -1
(downdate); ``ok`` (a 0-d bool on L's device) is False once a pivot lost
definiteness. On a CUDA f32 tensor it is ``csrc/chol_update.cu``: one
launch for up to ``MAX_K`` rotations (a larger k takes ceil(k / MAX_K)
launches, in order), each a (column, rotation) wavefront over tiles of
``PANEL`` rows by ``PANEL`` columns, the result equal to the plain version
bit for bit. On a CPU tensor it is the plain version,
:func:`repro_torch.kernels.ref.chol_rank_update_ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import chol_rank_update_ref

_SIGNATURES = {
    "chol_rank_update_f32": [build.P, build.P, build.I, build.I, build.I,
                             build.F, build.P, build.P, build.P, build.P,
                             build.P],
}
# Mirrors of csrc/chol_update.cu's constants: columns a panel (rows a tile,
# lanes a warp), warps of rows a CTA (and one more for the diagonal),
# rotations staged and published at a time, rotations a shared-memory ring
# holds, and rotations a launch
PANEL = 32
ROW_WARPS = 8
CHUNK = 8
RING = 64
MAX_K = 1024


def scratch_sizes(n: int, k: int) -> tuple[int, int, int]:
    """Elements of the three scratch buffers one call of ``k`` rotations
    on an (n, n) factor needs: W (f32, n x min(k, MAX_K): every row's v_p
    after the last panel applied), cs (f32, the c and s of every panel's
    columns for one launch's rotations, by the step that reads them: kc +
    PANEL - 1 rows a panel) and the flags (int32, a progress count a tile
    and the ticket)."""
    kc = min(k, MAX_K)
    nb = -(-n // PANEL)
    return n * kc, 2 * nb * (kc + PANEL - 1) * PANEL, nb * nb + 1


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
    nw, ncs, nflags = scratch_sizes(n, k)
    W = torch.empty(nw, dtype=torch.float32, device=L.device)
    cs = torch.empty(ncs, dtype=torch.float32, device=L.device)
    flags = torch.empty(nflags, dtype=torch.int32, device=L.device)
    lib = build.library("chol_update", _SIGNATURES)
    for p0 in range(0, k, MAX_K):
        kc = min(MAX_K, k - p0)
        rc = lib.chol_rank_update_f32(
            out.data_ptr(), V.data_ptr() + 4 * p0, n, kc, k, float(sign),
            W.data_ptr(), cs.data_ptr(), flags.data_ptr(), ok.data_ptr(),
            build.stream(L))
        build.check(rc, "chol_rank_update")
        build.LAUNCHES["chol_rank_update"] += 1
    return out, ok.bool()

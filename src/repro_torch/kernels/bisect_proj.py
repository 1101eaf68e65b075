"""Ladder statistics for a whole ladder of thresholds in one data pass
(counterpart of ``repro.kernels.bisect_proj``).

``ladder_stats(az, thetas)`` returns the (2, B) f32 tile
``[sum_i max(az_i - theta_b, 0); #{i : az_i > theta_b}]``. On a CUDA
tensor it launches the two-pass kernel of ``csrc/ladder_stats.cu``
(per-block partials, then a fixed-order sum); on a CPU tensor it is the
plain version :func:`repro_torch.kernels.ref.ladder_stats_ref`.
"""
from __future__ import annotations

import torch

from . import build
from .ref import ladder_stats_ref

_SIGNATURES = {
    "ladder_stats_f32": [build.P, build.P, build.P, build.P, build.P,
                         build.I, build.I, build.I, build.P],
    "ladder_chunk": [],
}
MAX_RUNGS = 8192   # the ladder sits in shared memory beside one az chunk


def ladder_stats(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """az (n,) nonnegative, thetas (B,) -> (2, B) f32 ladder statistics."""
    if az.device.type == "cpu":
        return ladder_stats_ref(az, thetas)
    if az.device.type != "cuda":
        raise ValueError(f"ladder_stats: no kernel for device {az.device}")
    return _launch(az, thetas)


def _launch(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    build.require_cuda("ladder_stats", az, thetas)
    if az.ndim != 1 or thetas.ndim != 1:
        raise ValueError("ladder_stats: az and thetas must be 1-D, got "
                         f"{tuple(az.shape)} and {tuple(thetas.shape)}")
    if az.dtype != torch.float32 or thetas.dtype != torch.float32:
        raise ValueError("ladder_stats: the kernel takes float32, got "
                         f"{az.dtype} and {thetas.dtype}")
    n, B = az.shape[0], thetas.shape[0]
    if not 1 <= B <= MAX_RUNGS:
        raise ValueError(f"ladder_stats: B={B} outside [1, {MAX_RUNGS}]")
    if n >= 2 ** 31:
        raise ValueError(f"ladder_stats: n={n} exceeds the int32 index range")
    az, thetas = az.contiguous(), thetas.contiguous()
    lib = build.library("ladder_stats", _SIGNATURES)
    chunk = lib.ladder_chunk()
    nblocks = -(-n // chunk)
    psum = torch.empty((max(nblocks, 1), B), dtype=torch.float32,
                       device=az.device)
    pcnt = torch.empty((max(nblocks, 1), B), dtype=torch.int32,
                       device=az.device)
    out = torch.empty((2, B), dtype=torch.float32, device=az.device)
    rc = lib.ladder_stats_f32(az.data_ptr(), thetas.data_ptr(),
                              psum.data_ptr(), pcnt.data_ptr(),
                              out.data_ptr(), n, B, nblocks,
                              build.stream(az))
    build.check(rc, "ladder_stats")
    # two kernels: ladder_partial (skipped when n == 0) and ladder_reduce
    build.LAUNCHES["ladder_stats"] += 1 + (nblocks > 0)
    return out

"""The exact sort-free projections on the card (counterpart of
``repro.kernels.bisect_proj`` and of the loops of ``repro.core.bilinear``
that drive it).

* ``l1_epigraph_proj(z0, t0) -> (z, t)`` and ``skappa_support(z, kappa)
  -> (u_max, s_star)`` run one whole projection in one launch of
  ``csrc/ladder_proj.cu``: |z| in shared memory, the bracketing rounds and
  the polish (or the pivot search) on the device, one CTA or a
  thread-block cluster of up to 8 (:func:`plan`). ``core.bilinear`` sends
  a CUDA tensor with the default reductions here while :func:`plan` says
  one launch holds it.
* ``ladder_stats(az, thetas)`` returns the (2, B) f32 tile
  ``[sum_i max(az_i - theta_b, 0); #{i : az_i > theta_b}]`` from the
  two-pass kernel of ``csrc/ladder_stats.cu`` (per-block partials, then a
  fixed-order sum). It carries the bracketing rounds of a projection too
  large for one launch, whose polish ``core.bilinear`` composes from
  PyTorch ops.

On a CPU tensor each function is its plain version in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .ref import (LADDER_CAP, l1_epigraph_proj_ref, ladder_stats_ref,
                  skappa_support_ref)

_SIGNATURES = {
    "ladder_stats_f32": [build.P, build.P, build.P, build.P, build.P,
                         build.I, build.I, build.I, build.P],
    "ladder_chunk": [],
}
_PROJ_SIGNATURES = {
    "l1_epigraph_proj_f32": [build.P, build.P, build.P, build.P, build.P,
                             build.P, build.I, build.I, build.I, build.I,
                             build.P],
    "skappa_support_f32": [build.P, build.F, build.P, build.P, build.P,
                           build.I, build.I, build.I, build.I, build.P],
    "ladder_proj_empty": [build.P],
}
MAX_RUNGS = 8192   # the ladder sits in shared memory beside one az chunk

# Mirrors of csrc/ladder_proj.cu's constants (tests/test_torch_ladder_proj.py
# reads them from the source).
THREADS = 1024          # kThreads: threads a CTA
RUNGS = 128             # kRungs: B, the rungs of a bracketing round
MAX_PER_CTA = 51_200    # kMaxPerCta: |z| entries one CTA's shared memory holds
MAX_CTAS = 8            # kMaxCtas: the largest (portable) cluster
MAX_N = MAX_PER_CTA * MAX_CTAS   # 409,600: the largest one-launch projection
# The cluster size by n: the smallest n at which 4 and 8 CTAs are taken
# (below 1,000 one CTA). Measured by chip_smoke.py's cluster sweep on an
# H100: 1 CTA is fastest at n = 250 and 500, 4 about as fast as any at
# n = 1,000, 8 from n = 2,500; 2 CTAs never were (PERF.md section 6).
CLUSTER_FROM = ((4, 1_000), (8, 2_500))


class Plan(NamedTuple):
    """How a projection of n entries runs. ``one_launch``: one launch of
    ``csrc/ladder_proj.cu`` with a cluster of ``ctas`` CTAs; otherwise
    (n > MAX_N) the two-pass ``ladder_stats`` kernel carries the bracketing
    rounds and PyTorch ops the polish (``ctas`` 0)."""
    one_launch: bool
    ctas: int


def plan(n: int) -> Plan:
    """The launch of a projection of ``n`` entries (a pure function of n)."""
    if n < 1:
        raise ValueError(f"a projection needs n >= 1 entries, got {n}")
    if n > MAX_N:
        return Plan(False, 0)
    ctas = 1
    for c, n_from in CLUSTER_FROM:
        if n >= n_from:
            ctas = c
    while -(-n // ctas) > MAX_PER_CTA:     # the slices must fit
        ctas *= 2
    return Plan(True, ctas)


def _operand(name: str, z: torch.Tensor, ctas) -> tuple[torch.Tensor, int]:
    """The contiguous f32 vector the kernel reads, and its cluster size."""
    build.require_cuda(name, z)
    if z.ndim != 1 or z.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes a 1-D float32 vector, "
                         f"got {tuple(z.shape)} {z.dtype}")
    n = z.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: n={n} outside the one-launch range "
                         f"[1, {MAX_N}]")
    if ctas is None:
        ctas = plan(n).ctas
    return z.contiguous(), ctas


def _stats_out(device, stats: bool, *dtypes) -> tuple:
    """0-d outputs of the given dtypes and a final int32 step count, or
    Nones when the statistics are not asked for."""
    dtypes = (*dtypes, torch.int32)
    if not stats:
        return (None,) * len(dtypes)
    return tuple(torch.empty((), dtype=d, device=device) for d in dtypes)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def l1_epigraph_proj(z0: torch.Tensor, t0, *, rounds: int = 2,
                     cap: int = LADDER_CAP, ctas: int | None = None,
                     stats: bool = False):
    """Exact projection of (z0, t0) onto {(z, t): ||z||_1 <= t}: z (n,) and
    t (), both on z0's device (``t0`` a 0-d tensor or a number). ``ctas``
    overrides :func:`plan`'s cluster size; with ``stats`` the threshold
    theta and the polish steps taken follow."""
    if z0.device.type == "cpu":
        return l1_epigraph_proj_ref(z0, t0, rounds=rounds, cap=cap,
                                    stats=stats)
    if z0.device.type != "cuda":
        raise ValueError(f"l1_epigraph_proj: no kernel for device "
                         f"{z0.device}")
    z0, ctas = _operand("l1_epigraph_proj", z0, ctas)
    if torch.is_tensor(t0):
        build.require_cuda("l1_epigraph_proj", z0, t0)
        if t0.numel() != 1 or t0.dtype != torch.float32:
            raise ValueError("l1_epigraph_proj: t0 must be one float32, got "
                             f"{tuple(t0.shape)} {t0.dtype}")
        t0 = t0.reshape(())
    else:
        t0 = torch.full((), float(t0), dtype=torch.float32, device=z0.device)
    z = torch.empty_like(z0)
    t = torch.empty((), dtype=torch.float32, device=z0.device)
    theta, k = _stats_out(z0.device, stats, torch.float32)
    lib = build.library("ladder_proj", _PROJ_SIGNATURES)
    rc = lib.l1_epigraph_proj_f32(
        z0.data_ptr(), t0.data_ptr(), z.data_ptr(), t.data_ptr(),
        _ptr(theta), _ptr(k), z0.shape[0], ctas, rounds, cap,
        build.stream(z0))
    build.check(rc, "l1_epigraph_proj")
    build.LAUNCHES["l1_epigraph_proj"] += 1
    return (z, t, theta, k) if stats else (z, t)


def skappa_support(z: torch.Tensor, kappa, *, rounds: int = 2,
                   cap: int = LADDER_CAP, ctas: int | None = None,
                   stats: bool = False):
    """Exact ``max_{s in S^kappa} z^T s`` () and an argmax s* (n,) on z's
    device; ``kappa`` a number. ``ctas`` as in :func:`l1_epigraph_proj`;
    with ``stats`` the search steps taken follow."""
    if z.device.type == "cpu":
        return skappa_support_ref(z, kappa, rounds=rounds, cap=cap,
                                  stats=stats)
    if z.device.type != "cuda":
        raise ValueError(f"skappa_support: no kernel for device {z.device}")
    z, ctas = _operand("skappa_support", z, ctas)
    if torch.is_tensor(kappa) and kappa.device.type != "cpu":
        raise ValueError("skappa_support: kappa must be a number (reading "
                         "a device tensor would stall the card)")
    s_star = torch.empty_like(z)
    u_max = torch.empty((), dtype=torch.float32, device=z.device)
    (k,) = _stats_out(z.device, stats)
    lib = build.library("ladder_proj", _PROJ_SIGNATURES)
    rc = lib.skappa_support_f32(
        z.data_ptr(), float(kappa), s_star.data_ptr(), u_max.data_ptr(),
        _ptr(k), z.shape[0], ctas, rounds, cap, build.stream(z))
    build.check(rc, "skappa_support")
    build.LAUNCHES["skappa_support"] += 1
    return (u_max, s_star, k) if stats else (u_max, s_star)


def launch_empty(like: torch.Tensor) -> None:
    """Launch an empty kernel on ``like``'s stream: the launch latency the
    one-launch projections sit on (not counted in ``build.LAUNCHES``)."""
    build.require_cuda("launch_empty", like)
    lib = build.library("ladder_proj", _PROJ_SIGNATURES)
    build.check(lib.ladder_proj_empty(build.stream(like)), "launch_empty")


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

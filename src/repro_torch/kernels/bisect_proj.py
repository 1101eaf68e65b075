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
  ``[sum_i max(az_i - theta_b, 0); #{i : az_i > theta_b}]`` from one
  launch of ``csrc/ladder_stats.cu`` (a grid sized to the card by
  :func:`stats_plan`; the last CTA to arrive adds the CTAs' partials in
  order). It carries the bracketing rounds of a projection too large for
  one launch, whose polish ``core.bilinear`` composes from PyTorch ops.
* ``l1_epigraph_proj_lanes(z0 (B, d), t0 (B,))`` and
  ``skappa_support_lanes(z (B, d), kappa (B,))`` project every row of a
  lane-stacked operand (the fleet driver's B problems, a grid's P points)
  in ONE launch of the same source, each row with its own t0 or kappa read
  on the device; the layout (:func:`lane_plan`) follows d.
* ``polish64=True`` (precision ``"fp64_polish"``) takes the l1 kernels'
  f64-polish instantiations: the same launch, the polish run to the f64
  fixpoint and theta rounded to f32 once. They count as launches of their
  kernel, and by type under ``l1_epigraph_proj_f64polish`` /
  ``l1_epigraph_proj_lanes_f64polish`` (``ops.launch_counts_by_type``).

On a CPU tensor each function is its plain version in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import build
from .matvec import sm_count
from .ref import (LADDER_CAP, l1_epigraph_proj_lanes_ref,
                  l1_epigraph_proj_ref, ladder_stats_ref,
                  skappa_support_lanes_ref, skappa_support_ref)

_SIGNATURES = {
    "ladder_stats_f32": [build.P, build.P, build.I, build.I, build.I,
                         build.I, build.P, build.P, build.P, build.P,
                         build.P],
}
_PROJ_SIGNATURES = {
    "l1_epigraph_proj_f32": [build.P, build.P, build.P, build.P, build.P,
                             build.P, build.I, build.I, build.I, build.I,
                             build.P],
    "l1_epigraph_proj_f32_polish64": [build.P, build.P, build.P, build.P,
                                      build.P, build.P, build.I, build.I,
                                      build.I, build.I, build.P],
    "skappa_support_f32": [build.P, build.F, build.P, build.P, build.P,
                           build.I, build.I, build.I, build.I, build.P],
    "ladder_proj_empty": [build.P],
    "l1_epigraph_proj_lanes_f32": [build.P, build.P, build.P, build.P,
                                   build.P, build.P, build.I, build.I,
                                   build.I, build.I, build.I, build.I,
                                   build.P],
    "l1_epigraph_proj_lanes_f32_polish64": [build.P, build.P, build.P,
                                            build.P, build.P, build.P,
                                            build.I, build.I, build.I,
                                            build.I, build.I, build.I,
                                            build.P],
    "skappa_support_lanes_f32": [build.P, build.P, build.P, build.P,
                                 build.P, build.I, build.I, build.I, build.I,
                                 build.I, build.I, build.P],
}
MAX_RUNGS = 8192   # kMaxRungs: the ladder sits in shared memory
# ladder_stats' grid (stats_plan): a CTA takes at least STATS_MIN_PER_CTA
# entries of az, and there is at most one CTA an SM
STATS_MIN_PER_CTA = 512

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


# The lane kernels' layouts (threads a lane): one warp up to
# LANE_WARP_MAX_N entries, a CTA of THREADS beyond (the header of
# csrc/ladder_proj.cu says why).
LANE_WARP_MAX_N = 256
LANE_THREADS = (32, THREADS)


class Plan(NamedTuple):
    """How a projection of n entries runs. ``one_launch``: one launch of
    ``csrc/ladder_proj.cu`` with a cluster of ``ctas`` CTAs; otherwise
    (n > MAX_N) the ``ladder_stats`` kernel carries the bracketing
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


class LanePlan(NamedTuple):
    """The layout of a lane launch: ``threads`` threads a lane, a cluster
    of ``ctas`` CTAs of THREADS (``threads`` == THREADS), or a warp on a
    persistent grid (32)."""
    ctas: int
    threads: int


def lane_plan(d: int) -> LanePlan:
    """The layout of a lane launch over rows of ``d`` entries (a pure
    function of d): where :func:`plan` takes a cluster, that cluster of
    THREADS-thread CTAs a lane; below it a warp a lane up to
    LANE_WARP_MAX_N, one CTA of THREADS beyond."""
    p = plan(d)
    if not p.one_launch:
        raise ValueError(f"a lane of d={d} entries is past the one-launch "
                         f"limit {MAX_N}")
    if p.ctas > 1 or d > LANE_WARP_MAX_N:
        return LanePlan(p.ctas, THREADS)
    return LanePlan(1, 32)


def _lanes_operand(name: str, z: torch.Tensor, per_lane: torch.Tensor,
                   what: str, ctas, threads):
    """The contiguous (B, d) f32 rows, the (B,) f32 per-lane values on
    their device, and the layout."""
    build.require_cuda(name, z, per_lane)
    if z.ndim != 2 or z.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes a (B, d) float32 "
                         f"operand, got {tuple(z.shape)} {z.dtype}")
    B, d = z.shape
    if B < 1 or not 1 <= d <= MAX_N:
        raise ValueError(f"{name}: B={B}, d={d} outside B >= 1, "
                         f"1 <= d <= {MAX_N}")
    if B >= 2 ** 31 or B * d >= 2 ** 62:
        raise ValueError(f"{name}: B={B} lanes exceed the index range")
    if tuple(per_lane.shape) != (B,):
        raise ValueError(f"{name}: {what} must be ({B},), got "
                         f"{tuple(per_lane.shape)}")
    if per_lane.dtype == torch.int32:
        per_lane = per_lane.to(torch.float32)     # exact below 2^24
    if per_lane.dtype != torch.float32:
        raise ValueError(f"{name}: {what} must be float32 or int32, got "
                         f"{per_lane.dtype}")
    lp = lane_plan(d)
    ctas = lp.ctas if ctas is None else ctas
    threads = lp.threads if threads is None else threads
    if threads not in LANE_THREADS or (threads < THREADS and (
            ctas != 1 or d > LANE_WARP_MAX_N)):
        raise ValueError(f"{name}: no lane layout of {ctas} CTAs of "
                         f"{threads} threads for d={d}")
    return z.contiguous(), per_lane.contiguous(), ctas, threads


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
                     stats: bool = False, polish64: bool = False):
    """Exact projection of (z0, t0) onto {(z, t): ||z||_1 <= t}: z (n,) and
    t (), both on z0's device (``t0`` a 0-d tensor or a number). ``ctas``
    overrides :func:`plan`'s cluster size; with ``stats`` the threshold
    theta and the polish steps taken follow; ``polish64`` runs the polish
    in f64."""
    if z0.device.type == "cpu":
        return l1_epigraph_proj_ref(z0, t0, rounds=rounds, cap=cap,
                                    stats=stats, polish64=polish64)
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
    entry = (lib.l1_epigraph_proj_f32_polish64 if polish64
             else lib.l1_epigraph_proj_f32)
    rc = entry(z0.data_ptr(), t0.data_ptr(), z.data_ptr(), t.data_ptr(),
               _ptr(theta), _ptr(k), z0.shape[0], ctas, rounds, cap,
               build.stream(z0))
    build.check(rc, "l1_epigraph_proj")
    build.LAUNCHES["l1_epigraph_proj"] += 1
    if polish64:
        build.LAUNCHES_BY_TYPE["l1_epigraph_proj_f64polish"] += 1
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


def l1_epigraph_proj_lanes(z0: torch.Tensor, t0: torch.Tensor, *,
                           rounds: int = 2, cap: int = LADDER_CAP,
                           ctas: int | None = None,
                           threads: int | None = None, stats: bool = False,
                           polish64: bool = False):
    """Row b of ``z0`` (B, d) projected with ``t0[b]`` (a (B,) tensor on
    z0's device) onto {(z, t): ||z||_1 <= t}, every row in one launch: z
    (B, d), t (B,); with ``stats`` theta (B,) and the polish steps (B,)
    follow. ``ctas`` / ``threads`` override :func:`lane_plan`;
    ``polish64`` runs every lane's polish in f64."""
    if z0.device.type == "cpu":
        return l1_epigraph_proj_lanes_ref(z0, t0, rounds=rounds, cap=cap,
                                          stats=stats, polish64=polish64)
    if z0.device.type != "cuda":
        raise ValueError(f"l1_epigraph_proj_lanes: no kernel for device "
                         f"{z0.device}")
    z0, t0, ctas, threads = _lanes_operand("l1_epigraph_proj_lanes", z0, t0,
                                           "t0", ctas, threads)
    B, d = z0.shape
    z = torch.empty_like(z0)
    t = torch.empty(B, dtype=torch.float32, device=z0.device)
    theta, k = ((torch.empty(B, dtype=torch.float32, device=z0.device),
                 torch.empty(B, dtype=torch.int32, device=z0.device))
                if stats else (None, None))
    lib = build.library("ladder_proj", _PROJ_SIGNATURES)
    entry = (lib.l1_epigraph_proj_lanes_f32_polish64 if polish64
             else lib.l1_epigraph_proj_lanes_f32)
    rc = entry(z0.data_ptr(), t0.data_ptr(), z.data_ptr(), t.data_ptr(),
               _ptr(theta), _ptr(k), B, d, ctas, threads, rounds, cap,
               build.stream(z0))
    build.check(rc, "l1_epigraph_proj_lanes")
    build.LAUNCHES["l1_epigraph_proj_lanes"] += 1
    if polish64:
        build.LAUNCHES_BY_TYPE["l1_epigraph_proj_lanes_f64polish"] += 1
    return (z, t, theta, k) if stats else (z, t)


def skappa_support_lanes(z: torch.Tensor, kappa: torch.Tensor, *,
                         rounds: int = 2, cap: int = LADDER_CAP,
                         ctas: int | None = None, threads: int | None = None,
                         stats: bool = False):
    """Per row b of ``z`` (B, d): max over S^kappa[b] of z_b^T s (B,) and
    an argmax s* (B, d), every row in one launch; ``kappa`` a (B,) float32
    or int32 tensor on z's device (read there: no host read). With
    ``stats`` the search steps (B,) follow."""
    if z.device.type == "cpu":
        return skappa_support_lanes_ref(z, kappa, rounds=rounds, cap=cap,
                                        stats=stats)
    if z.device.type != "cuda":
        raise ValueError(f"skappa_support_lanes: no kernel for device "
                         f"{z.device}")
    z, kappa, ctas, threads = _lanes_operand("skappa_support_lanes", z,
                                             kappa, "kappa", ctas, threads)
    B, d = z.shape
    s_star = torch.empty_like(z)
    u_max = torch.empty(B, dtype=torch.float32, device=z.device)
    k = (torch.empty(B, dtype=torch.int32, device=z.device) if stats
         else None)
    lib = build.library("ladder_proj", _PROJ_SIGNATURES)
    rc = lib.skappa_support_lanes_f32(
        z.data_ptr(), kappa.data_ptr(), s_star.data_ptr(), u_max.data_ptr(),
        _ptr(k), B, d, ctas, threads, rounds, cap, build.stream(z))
    build.check(rc, "skappa_support_lanes")
    build.LAUNCHES["skappa_support_lanes"] += 1
    return (u_max, s_star, k) if stats else (u_max, s_star)


def launch_empty(like: torch.Tensor) -> None:
    """Launch an empty kernel on ``like``'s stream: the launch latency the
    one-launch projections sit on (not counted in ``build.LAUNCHES``)."""
    build.require_cuda("launch_empty", like)
    lib = build.library("ladder_proj", _PROJ_SIGNATURES)
    build.check(lib.ladder_proj_empty(build.stream(like)), "launch_empty")


class StatsPlan(NamedTuple):
    """The grid of one ``ladder_stats`` launch: ``ctas`` CTAs, each owning
    ``per_cta`` consecutive entries of az (the last may own fewer)."""
    ctas: int
    per_cta: int


def stats_plan(n: int, sms: int) -> StatsPlan:
    """The grid of ``ladder_stats`` over n entries on a card of ``sms`` SMs
    (a pure function): at most one CTA an SM, each with at least
    STATS_MIN_PER_CTA entries; n = 0 is one CTA of none."""
    if n < 0 or sms < 1:
        raise ValueError(f"stats_plan: n={n}, sms={sms}")
    ctas = max(1, min(sms, n // STATS_MIN_PER_CTA))
    per_cta = -(-n // ctas)
    return StatsPlan(-(-n // per_cta) if n else 1, per_cta)


# Per device: the ticket counter (0 between calls; the last CTA of a call
# resets it) and the partials' scratch, grown as a call needs. Calls on one
# device share them, so they must be ordered on one stream, as the solver's
# are.
_SCRATCH: dict = {}


def _scratch(device: torch.device, size: int):
    ticket, psum, pcnt = _SCRATCH.get(device, (None, None, None))
    if ticket is None:
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
    if psum is None or psum.numel() < size:
        psum = torch.empty(size, dtype=torch.float64, device=device)
        pcnt = torch.empty(size, dtype=torch.int32, device=device)
    _SCRATCH[device] = (ticket, psum, pcnt)
    return ticket, psum, pcnt


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
    ctas, per_cta = stats_plan(n, sm_count(az.device))
    ticket, psum, pcnt = _scratch(az.device, ctas * B)
    out = torch.empty((2, B), dtype=torch.float32, device=az.device)
    rc = lib.ladder_stats_f32(az.data_ptr(), thetas.data_ptr(), n, B, ctas,
                              per_cta, psum.data_ptr(), pcnt.data_ptr(),
                              ticket.data_ptr(), out.data_ptr(),
                              build.stream(az))
    build.check(rc, "ladder_stats")
    build.LAUNCHES["ladder_stats"] += 1
    return out

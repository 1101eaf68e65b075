"""Bi-linear reformulation machinery (counterpart of ``repro.core.bilinear``).

``||x||_0 <= kappa``  <=>  exists s, t with
``x^T s = t, ||x||_1 <= t, ||s||_1 <= kappa, ||s||_inf <= 1``.

The projections are the sort-free exact ones of the JAX package:
:func:`ladder_refine` finds the root of the piecewise-linear KKT function
``h(theta) = sum_i max(|z_i| - theta, 0) - t0 - theta`` by optional
bracketing rounds (one ``ladder_stats`` kernel pass over B = 128 rungs
each) and a monotone closed-form polish run to its floating-point fixpoint.
See the JAX module's docstring for the exactness argument.

Data-dependent loops on the device. The polish and the S^kappa quantile
search run inside the 120-step FISTA loop, so a host check per step would
stall the card hundreds of times per outer iteration. Their state stays in
tensors; they run in chunks of ``CHUNK[device]`` masked steps (``torch.where``
freezes a finished loop) and the host reads ``done`` once per chunk. This
is exact: a frozen loop keeps the values the JAX ``while_loop`` exits
with, and steps are counted against the same cap (:data:`NEWTON_CAP`).

The ``*_sort`` functions are the sort-based test oracles.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

LADDER_B = 128     # rungs per bracketing round (one (2, B) stats pass each)
NEWTON_CAP = 64    # hard cap on polish / search steps
# masked steps between two host checks of ``done``: on the card a check is a
# device sync, on the CPU it is free, so the CPU checks after every step
CHUNK = {"cuda": 4, "cpu": 1}


def g(z: torch.Tensor, s: torch.Tensor, t) -> torch.Tensor:
    """Bi-linear constraint residual g(z, s, t) = z^T s - t."""
    return torch.sum(z * s) - t


# --------------------------------------------------------------------------
# ladder statistics plumbing
# --------------------------------------------------------------------------
class LadderOps(NamedTuple):
    """Injectable reductions of the exact projections (see
    ``repro.core.bilinear.LadderOps``)."""
    sum_fn: Callable
    max_fn: Callable
    stats_fn: Callable
    point_fn: Callable
    band_fn: Callable


def _stats_kernel(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    from ..kernels.ops import ladder_stats_auto
    return ladder_stats_auto(az, thetas)


def point_stats(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """(2, k) [sum max(az - theta, 0); count(az > theta)] for a few rungs,
    one fused reduction per rung."""
    cols = []
    for i in range(thetas.shape[0]):
        d = az - thetas[i]
        cols.append(torch.stack([torch.clamp_min(d, 0.0).sum(),
                                 (d > 0).to(az.dtype).sum()]))
    return torch.stack(cols, dim=1)


def band_stats(az: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """(2,) [sum; count] of the az falling in (lo, hi]."""
    m = (az > lo) & (az <= hi)
    return torch.stack([torch.where(m, az, 0.0).sum(), m.to(az.dtype).sum()])


DEFAULT_OPS = LadderOps(sum_fn=torch.sum, max_fn=torch.max,
                        stats_fn=_stats_kernel, point_fn=point_stats,
                        band_fn=band_stats)


def default_rounds(device: torch.device) -> int:
    """Bracketing rounds for ``device``: 2 on the card (one kernel pass
    evaluates all B rungs), 0 on the CPU (see repro_torch.runtime)."""
    from .. import runtime
    return runtime.ladder_rounds(device.type)


def _bracket_rounds(lo, hi, rounds, B, crossing_fn):
    """Narrow [lo, hi] xB per round; ``crossing_fn(thetas) -> idx`` is the
    number of leading rungs on the h > 0 / count > kappa side. The index
    gathers stay on the device: ``index_select`` with a tensor index, where
    ``th[idx]`` would read a 0-d index back to the host."""
    ar = torch.arange(1, B + 1, dtype=lo.dtype, device=lo.device)

    def at(th, i):
        return th.index_select(0, i.reshape(1))[0]

    for _ in range(rounds):
        th = lo + (hi - lo) * ar / B
        idx = crossing_fn(th)
        lo_n = torch.where(idx == 0, lo, at(th, torch.clamp_min(idx - 1, 0)))
        hi_n = torch.where(idx == B, hi, at(th, torch.clamp_max(idx, B - 1)))
        lo, hi = lo_n, hi_n
    return lo, hi


def _masked_loop(step, state: tuple, active: torch.Tensor, k: int,
                 cap: int) -> tuple:
    """Run ``state = step(state)`` while ``active`` and ``k < cap``.

    ``step`` returns ``(new_state, still_going)``; a finished loop's state is
    frozen with ``torch.where``, and the host reads ``active`` once per
    ``CHUNK[device]`` steps.
    """
    chunk = CHUNK[active.device.type]
    while k < cap:
        for _ in range(chunk):
            if k >= cap:
                break
            new, going = step(state)
            state = tuple(torch.where(active, n, o)
                          for n, o in zip(new, state))
            active = active & going
            k += 1
        if not bool(active):
            break
    return state


# --------------------------------------------------------------------------
# the shared exact primitive
# --------------------------------------------------------------------------
def ladder_refine(az: torch.Tensor, h_target, *,
                  ops: LadderOps = DEFAULT_OPS, hi=None,
                  rounds: int | None = None, B: int = LADDER_B,
                  newton_cap: int = NEWTON_CAP) -> torch.Tensor:
    """Exact root of ``h(theta) = sum max(az - theta, 0) - h_target - theta``
    (``repro.core.bilinear.ladder_refine`` in the working dtype)."""
    dt = az.dtype
    t0 = torch.as_tensor(h_target, dtype=dt, device=az.device)
    if rounds is None:
        rounds = default_rounds(az.device)
    if hi is None:
        hi = ops.max_fn(az)
    lo = torch.zeros_like(hi)

    if rounds:
        def crossing(th):
            st = ops.stats_fn(az, th)
            hv = st[0].to(dt) - t0 - th
            return torch.sum(hv > 0)
        lo, hi = _bracket_rounds(lo, hi, rounds, B, crossing)

    def propose(th):
        st = ops.point_fn(az, th[None]).to(dt)
        hv = st[0, 0] - t0 - th
        return torch.maximum(th + hv / (st[1, 0] + 1.0), th)

    # JAX: k = 1, (th, prev) = (propose(lo), lo); step while th > prev.
    def step(state):
        th, _ = state
        new = propose(th)
        return (new, th), new > th

    theta0 = propose(lo)
    theta, _ = _masked_loop(step, (theta0, lo), theta0 > lo, 1, newton_cap)
    return theta


# --------------------------------------------------------------------------
# l1-epigraph projection
# --------------------------------------------------------------------------
def _soft(z: torch.Tensor, thr) -> torch.Tensor:
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - thr, 0.0)


def project_l1_epigraph(z0: torch.Tensor, t0, *, ops: LadderOps = DEFAULT_OPS,
                        rounds: int | None = None, B: int = LADDER_B,
                        newton_cap: int = NEWTON_CAP):
    """Exact Euclidean projection onto ``{(z, t): ||z||_1 <= t}``
    (sort-free; apex and inside cases as in the JAX package)."""
    t0 = torch.as_tensor(t0, dtype=z0.dtype, device=z0.device)
    az = torch.abs(z0)
    abs_sum = ops.sum_fn(az)
    hi0 = ops.max_fn(az)
    inside = abs_sum <= t0
    apex = (-t0 - hi0) > 0
    theta = ladder_refine(az, t0, ops=ops, hi=hi0, rounds=rounds, B=B,
                          newton_cap=newton_cap)
    theta = torch.where(inside, 0.0, theta)
    to_apex = apex & ~inside
    z = torch.where(to_apex, 0.0,
                    torch.sign(z0) * torch.clamp_min(az - theta, 0.0))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0), t0 + theta)
    return z, t


def project_l1_epigraph_sort(z0: torch.Tensor, t0):
    """Sort-based exact projection — the test oracle of the ladder path."""
    t0 = torch.as_tensor(t0, dtype=z0.dtype, device=z0.device)
    az = torch.sort(torch.abs(z0), descending=True).values
    csum = torch.cumsum(az, 0)
    n = z0.shape[0]
    k = torch.arange(1, n + 1, dtype=z0.dtype, device=z0.device)
    theta_j = (csum - t0) / (k + 1.0)
    lower = torch.cat([az[1:], torch.zeros(1, dtype=az.dtype,
                                           device=az.device)])
    valid = (theta_j >= lower) & (theta_j <= az) & (theta_j >= 0)
    theta = torch.min(torch.where(valid, theta_j, math.inf))
    apex = ~torch.isfinite(theta)
    theta = torch.where(apex, 0.0, theta)
    inside = torch.sum(torch.abs(z0)) <= t0
    theta = torch.where(inside, 0.0, theta)
    to_apex = apex & ~inside
    z = torch.where(to_apex, 0.0, _soft(z0, theta))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0), t0 + theta)
    return z, t


# --------------------------------------------------------------------------
# S^kappa support function
# --------------------------------------------------------------------------
def support_skappa_sort(z: torch.Tensor, kappa):
    """Double-argsort rank-trick LP over S^kappa — the test oracle."""
    az = torch.abs(z)
    kap = torch.as_tensor(kappa, dtype=az.dtype, device=az.device)
    kf = torch.floor(kap)
    frac = kap - kf
    order = torch.argsort(-az, stable=True)
    ranks_f = torch.argsort(order, stable=True).to(az.dtype)
    w = torch.clamp(kf - ranks_f, 0.0, 1.0)
    w = w + frac * ((ranks_f >= kf) & (ranks_f < kf + 1.0)).to(az.dtype)
    return torch.sum(az * w), torch.sign(z) * w


def support_skappa_ladder(z: torch.Tensor, kappa, *,
                          ops: LadderOps = DEFAULT_OPS,
                          rounds: int | None = None, B: int = LADDER_B,
                          cap: int = NEWTON_CAP):
    """Exact sort-free ``max_{s in S^kappa} z^T s`` and an argmax
    (``repro.core.bilinear.support_skappa_ladder``)."""
    az = torch.abs(z)
    dt = az.dtype
    kap = torch.as_tensor(kappa, dtype=dt, device=z.device)
    if rounds is None:
        rounds = default_rounds(z.device)
    hi0 = ops.max_fn(az)
    st0 = ops.point_fn(az, torch.zeros(1, dtype=dt, device=z.device)).to(dt)
    c0 = st0[1, 0]
    all_in = c0 <= kap  # fewer than kappa nonzeros: tau* = 0

    lo = torch.zeros_like(hi0)
    hi = hi0
    if rounds:
        def crossing(th):
            st = ops.stats_fn(az, th)
            return torch.sum(st[1].to(dt) > kap)
        lo, hi = _bracket_rounds(lo, hi, rounds, B, crossing)

    neg_inf = torch.tensor(-math.inf, dtype=dt, device=z.device)
    pos_inf = torch.tensor(math.inf, dtype=dt, device=z.device)

    def step(state):
        lo, hi, _, _, _ = state
        band = ops.band_fn(az, lo, hi).to(dt)         # (sum, count) in (lo, hi]
        a = band[0] / torch.clamp_min(band[1], 1.0)   # interior mean pivot
        a = torch.minimum(torch.maximum(a, torch.nextafter(lo, pos_inf)), hi)
        am = torch.nextafter(a, neg_inf)
        ap = torch.nextafter(a, pos_inf)
        c3 = ops.point_fn(az, torch.stack([am, a, ap])).to(dt)[1]
        done1 = (c3[0] > kap) & (kap >= c3[1])   # crossing inside (am, a]
        done2 = (c3[1] > kap) & (kap >= c3[2])   # crossing inside (a, ap]
        done = done1 | done2
        tau = torch.where(done2, ap, a)
        c_tau = torch.where(done2, c3[2], c3[1])
        ceq = torch.where(done2, c3[1] - c3[2], c3[0] - c3[1])
        go_lo = (~done) & (c3[1] > kap)
        lo_n = torch.where(go_lo, a, lo)
        hi_n = torch.where((~done) & (~go_lo), am, hi)
        return (lo_n, hi_n, tau, c_tau, ceq), ~done

    zero = torch.zeros_like(c0)
    _, _, tau, c_tau, ceq = _masked_loop(step, (lo, hi, hi, zero, zero),
                                         ~all_in, 0, cap)

    tau = torch.where(all_in, 0.0, tau)
    c_tau = torch.where(all_in, c0, c_tau)
    ceq = torch.where(all_in, 0.0, ceq)
    above = (az > tau).to(dt)
    at_tau = ((az == tau) & (tau > 0)).to(dt)
    leftover = torch.minimum(torch.clamp_min(kap - c_tau, 0.0),
                             torch.clamp_min(ceq, 0.0))
    bnd_w = torch.where(ceq > 0, leftover / torch.where(ceq > 0, ceq, 1.0),
                        0.0)
    w = above + bnd_w * at_tau
    return ops.sum_fn(az * w), torch.sign(z) * w


# --------------------------------------------------------------------------
# s-step and hard thresholding
# --------------------------------------------------------------------------
def s_update(z: torch.Tensor, t, v, kappa, *, ops: LadderOps = DEFAULT_OPS,
             method: str = "ladder", rounds: int | None = None):
    """Closed-form ADMM s-step (12): argmin_{s in S^kappa} (z^T s - (t - v))^2."""
    if method == "sort":
        u_max, s_star = support_skappa_sort(z, kappa)
    else:
        u_max, s_star = support_skappa_ladder(z, kappa, ops=ops,
                                              rounds=rounds)
    c = torch.as_tensor(t - v, dtype=z.dtype, device=z.device)
    c_cl = torch.minimum(torch.maximum(c, -u_max), u_max)
    theta = torch.where(u_max > 0,
                        c_cl / torch.where(u_max > 0, u_max, 1.0), 0.0)
    return theta * s_star


def hard_threshold(z: torch.Tensor, kappa) -> torch.Tensor:
    """Keep the ceil(kappa) largest magnitudes of z; ties go to the lower
    index, as ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    n = z.shape[0]
    k = min(n, max(0, math.ceil(kappa)))
    if k == 0:
        return torch.zeros_like(z)
    if k >= n:
        return z
    idx = torch.sort(torch.abs(z), descending=True, stable=True).indices[:k]
    mask = torch.zeros(n, dtype=torch.bool, device=z.device)
    mask[idx] = True
    return torch.where(mask, z, 0.0)


def hard_threshold_sort(z: torch.Tensor, kappa) -> torch.Tensor:
    """Double-argsort rank-trick top-kappa mask — the test oracle."""
    ranks = torch.argsort(torch.argsort(-torch.abs(z), stable=True),
                          stable=True)
    return torch.where(ranks < kappa, z, 0.0)

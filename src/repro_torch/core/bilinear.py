"""Bi-linear reformulation machinery (counterpart of ``repro.core.bilinear``).

``||x||_0 <= kappa``  <=>  exists s, t with
``x^T s = t, ||x||_1 <= t, ||s||_1 <= kappa, ||s||_inf <= 1``.

The projections are the sort-free exact ones of the JAX package:
:func:`ladder_refine` finds the root of the piecewise-linear KKT function
``h(theta) = sum_i max(|z_i| - theta, 0) - t0 - theta`` by optional
bracketing rounds (one pass over |z| for all B = 128 rungs each) and a
monotone closed-form polish run to its floating-point fixpoint.
See the JAX module's docstring for the exactness argument.

On the card. A CUDA vector with the default reductions (``ops is
DEFAULT_OPS``) and B = 128 rungs is projected in ONE launch of
``csrc/ladder_proj.cu`` (``kernels.bisect_proj.l1_epigraph_proj`` /
``skappa_support``, through the registry): the rounds, the polish or the
pivot search and the output run on the device with no host read, while
``bisect_proj.plan`` says one launch holds n. Past that, and for injected
reductions (the hook of a distributed engine), the composed path below
runs: ``ladder_stats`` kernel rounds and PyTorch ops.

Data-dependent loops of the composed path. The polish and the S^kappa
quantile search run inside the 120-step FISTA loop, so a host check per
step would stall the card hundreds of times per outer iteration. Their
state stays in tensors; they run in chunks of ``CHUNK[device]`` masked
steps (``torch.where`` freezes a finished loop) and the host reads ``done``
once per chunk. This is exact: a frozen loop keeps the values the JAX
``while_loop`` exits with, and steps are counted against the same cap
(:data:`NEWTON_CAP`).

Lanes. :func:`project_l1_epigraph`, :func:`support_skappa_ladder`,
:func:`s_update` and :func:`g` also take a leading lane axis (z of shape
(B, d), one vector per lane, with per-lane (B,) t0, kappa, t and v): the
fleet driver's B problems and a grid's P points. On the card every lane is
projected in ONE launch (``kernels.bisect_proj.l1_epigraph_proj_lanes`` /
``skappa_support_lanes``): a CUDA lane tensor reaches those kernels or
raises. On the CPU the lanes run the composed path with the row reductions
of each lane, so a lane's result equals the solo composed path's on that
row bit for bit; the data-dependent loops then run until every lane is
done, a finished lane frozen by ``torch.where`` as the JAX package's
vmapped ``while_loop`` freezes it.

``polish_dtype`` (the precision policy's ``kkt_polish``: ``torch.float64``
or ``"float64"`` under ``"fp64_polish"``) runs the l1 polish in f64: the
bracketing stays in the working dtype, |z|, t0 and ``lo`` are cast to f64
once, the polish runs to the f64 fixpoint and theta is cast back before the
soft threshold (``repro.core.bilinear.ladder_refine``). On the card the
one-launch and lane kernels take it as their f64-polish instantiations.
Only the l1 projection has it: the S^kappa search has no polish dtype in
the JAX package either.

The ``*_sort`` functions are the sort-based test oracles (lanes too); the
``*_bisect`` ones the approximate scalar-bisection variants, and
:func:`support_skappa` the top-k LP at a static kappa.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..kernels import bisect_proj
from ..kernels.ops import (l1_epigraph_proj_auto,
                           l1_epigraph_proj_lanes_auto, ladder_stats_auto,
                           skappa_support_auto, skappa_support_lanes_auto)

LADDER_B = 128     # rungs per bracketing round (one (2, B) stats pass each)
NEWTON_CAP = 64    # hard cap on polish / search steps
# masked steps between two host checks of ``done``: on the card a check is a
# device sync, on the CPU it is free, so the CPU checks after every step
CHUNK = {"cuda": 4, "cpu": 1}


def g(z: torch.Tensor, s: torch.Tensor, t, *, sum_fn=None) -> torch.Tensor:
    """Bi-linear constraint residual g(z, s, t) = z^T s - t (per lane for
    (B, d) operands); ``sum_fn`` replaces the sum (the sharded engine's sum
    over its feature blocks)."""
    if z.ndim == 2:
        return torch.sum(z * s, dim=-1) - t
    return (torch.sum if sum_fn is None else sum_fn)(z * s) - t


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
                        stats_fn=ladder_stats_auto, point_fn=point_stats,
                        band_fn=band_stats)


def default_rounds(device: torch.device) -> int:
    """Bracketing rounds for ``device``: 2 on the card (one kernel pass
    evaluates all B rungs), 0 on the CPU (see repro_torch.runtime)."""
    from .. import runtime
    return runtime.ladder_rounds(device.type)


def _one_launch(z: torch.Tensor, ops: LadderOps, B: int) -> bool:
    """Whether a projection of ``z`` is one launch of
    ``csrc/ladder_proj.cu``: an f32 CUDA vector, the default reductions,
    B = 128 rungs, n within ``bisect_proj.plan``'s one-launch range."""
    return (ops is DEFAULT_OPS and B == LADDER_B
            and z.device.type == "cuda" and z.dtype == torch.float32
            and z.ndim == 1 and z.shape[0] >= 1
            and bisect_proj.plan(z.shape[0]).one_launch)


def _polish_dt(polish_dtype, dt: torch.dtype) -> torch.dtype:
    """The polish's dtype: ``polish_dtype`` (a torch dtype or its name),
    the working dtype ``dt`` when None."""
    if polish_dtype is None:
        return dt
    return (polish_dtype if isinstance(polish_dtype, torch.dtype)
            else getattr(torch, polish_dtype))


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
    ``CHUNK[device]`` steps. ``active`` may hold one flag per lane (the
    state entries then (B,)): the loop runs until every lane is done.
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
        if not bool(active.any()):
            break
    return state


# --------------------------------------------------------------------------
# the shared exact primitive
# --------------------------------------------------------------------------
def ladder_refine(az: torch.Tensor, h_target, *,
                  ops: LadderOps = DEFAULT_OPS, hi=None,
                  rounds: int | None = None, B: int = LADDER_B,
                  newton_cap: int = NEWTON_CAP,
                  polish_dtype=None) -> torch.Tensor:
    """Exact root of ``h(theta) = sum max(az - theta, 0) - h_target - theta``
    (``repro.core.bilinear.ladder_refine``); ``polish_dtype`` runs the
    polish in a wider dtype (module docstring), the root is returned in the
    working dtype."""
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

    pdt = _polish_dt(polish_dtype, dt)
    azp, t0p, lo = az.to(pdt), t0.to(pdt), lo.to(pdt)

    def propose(th):
        st = ops.point_fn(azp, th[None]).to(pdt)
        hv = st[0, 0] - t0p - th
        return torch.maximum(th + hv / (st[1, 0] + 1.0), th)

    # JAX: k = 1, (th, prev) = (propose(lo), lo); step while th > prev.
    def step(state):
        th, _ = state
        new = propose(th)
        return (new, th), new > th

    theta0 = propose(lo)
    theta, _ = _masked_loop(step, (theta0, lo), theta0 > lo, 1, newton_cap)
    return theta.to(dt)


# --------------------------------------------------------------------------
# l1-epigraph projection
# --------------------------------------------------------------------------
def _soft(z: torch.Tensor, thr) -> torch.Tensor:
    return torch.sign(z) * torch.clamp_min(torch.abs(z) - thr, 0.0)


def project_l1_epigraph(z0: torch.Tensor, t0, *, ops: LadderOps = DEFAULT_OPS,
                        rounds: int | None = None, B: int = LADDER_B,
                        newton_cap: int = NEWTON_CAP, polish_dtype=None):
    """Exact Euclidean projection onto ``{(z, t): ||z||_1 <= t}``
    (sort-free; apex and inside cases as in the JAX package). ``z0`` (B, d)
    with ``t0`` (B,) projects every lane; ``polish_dtype`` as in
    :func:`ladder_refine` (module docstring)."""
    if rounds is None:
        rounds = default_rounds(z0.device)
    pdt = _polish_dt(polish_dtype, z0.dtype)
    if pdt not in (z0.dtype, torch.float64):
        raise ValueError(f"polish_dtype must be float64 or None, got "
                         f"{polish_dtype!r}")
    polish64 = pdt != z0.dtype
    if z0.ndim == 2:
        if _lanes_on_card(z0, ops, B, "project_l1_epigraph"):
            return l1_epigraph_proj_lanes_auto(z0, t0, rounds=rounds,
                                               cap=newton_cap,
                                               polish64=polish64)
        return _project_lanes(z0, t0, rounds, B, newton_cap, polish64)
    if _one_launch(z0, ops, B):
        return l1_epigraph_proj_auto(z0, t0, rounds=rounds, cap=newton_cap,
                                     polish64=polish64)
    t0 = torch.as_tensor(t0, dtype=z0.dtype, device=z0.device)
    az = torch.abs(z0)
    abs_sum = ops.sum_fn(az)
    hi0 = ops.max_fn(az)
    inside = abs_sum <= t0
    apex = (-t0 - hi0) > 0
    theta = ladder_refine(az, t0, ops=ops, hi=hi0, rounds=rounds, B=B,
                          newton_cap=newton_cap, polish_dtype=polish_dtype)
    theta = torch.where(inside, 0.0, theta)
    to_apex = apex & ~inside
    z = torch.where(to_apex, 0.0,
                    torch.sign(z0) * torch.clamp_min(az - theta, 0.0))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0), t0 + theta)
    return z, t


def project_l1_epigraph_sort(z0: torch.Tensor, t0):
    """Sort-based exact projection — the test oracle of the ladder path
    (per lane for z0 (B, d), t0 (B,))."""
    t0 = torch.as_tensor(t0, dtype=z0.dtype, device=z0.device)
    az = torch.sort(torch.abs(z0), dim=-1, descending=True).values
    csum = torch.cumsum(az, -1)
    n = z0.shape[-1]
    k = torch.arange(1, n + 1, dtype=z0.dtype, device=z0.device)
    theta_j = (csum - t0[..., None]) / (k + 1.0)
    lower = torch.cat([az[..., 1:], torch.zeros_like(az[..., :1])], -1)
    valid = (theta_j >= lower) & (theta_j <= az) & (theta_j >= 0)
    theta = torch.amin(torch.where(valid, theta_j, math.inf), -1)
    apex = ~torch.isfinite(theta)
    theta = torch.where(apex, 0.0, theta)
    inside = torch.sum(torch.abs(z0), -1) <= t0
    theta = torch.where(inside, 0.0, theta)
    to_apex = apex & ~inside
    z = torch.where(to_apex[..., None], 0.0, _soft(z0, theta[..., None]))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0), t0 + theta)
    return z, t


def project_l1_epigraph_bisect(z0: torch.Tensor, t0, iters: int = 60,
                               sum_fn=torch.sum, max_fn=torch.max):
    """Projection onto the l1-epigraph by ``iters`` bisection steps on
    theta (``repro.core.bilinear.project_l1_epigraph_bisect``): accurate to
    max|z0| / 2^iters, not exact; the fixed-count loop reads nothing back
    to the host."""
    t0 = torch.as_tensor(t0, dtype=z0.dtype, device=z0.device)
    az = torch.abs(z0)
    inside = sum_fn(az) <= t0
    hi = max_fn(az)
    lo = torch.zeros_like(hi)
    apex = (-t0 - hi) > 0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        pos = (sum_fn(torch.clamp_min(az - mid, 0.0)) - t0 - mid) > 0
        lo, hi = torch.where(pos, mid, lo), torch.where(pos, hi, mid)
    theta = torch.where(inside, 0.0, 0.5 * (lo + hi))
    to_apex = apex & ~inside
    z = torch.where(to_apex, 0.0, _soft(z0, theta))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0),
                    torch.where(inside, t0, t0 + theta))
    return z, t


# --------------------------------------------------------------------------
# S^kappa support function
# --------------------------------------------------------------------------
def support_skappa_sort(z: torch.Tensor, kappa):
    """Double-argsort rank-trick LP over S^kappa — the test oracle (per
    lane for z (B, d), kappa (B,))."""
    az = torch.abs(z)
    kap = torch.as_tensor(kappa, device=az.device).to(az.dtype)[..., None]
    kf = torch.floor(kap)
    frac = kap - kf
    order = torch.argsort(-az, dim=-1, stable=True)
    ranks_f = torch.argsort(order, dim=-1, stable=True).to(az.dtype)
    w = torch.clamp(kf - ranks_f, 0.0, 1.0)
    w = w + frac * ((ranks_f >= kf) & (ranks_f < kf + 1.0)).to(az.dtype)
    return torch.sum(az * w, -1), torch.sign(z) * w


def support_skappa(z: torch.Tensor, kappa):
    """max over S^kappa of z^T s and an attaining vertex
    (``repro.core.bilinear.support_skappa``): for a Python number kappa
    the top-ceil(kappa) magnitudes by a stable descending sort (ties to the
    lower index, as ``jax.lax.top_k``), the fractional weight on the last;
    for a tensor kappa the sort oracle."""
    if not isinstance(kappa, (int, float)) or isinstance(kappa, bool):
        return support_skappa_sort(z, kappa)
    az = torch.abs(z)
    n = z.shape[0]
    kf = math.floor(kappa)
    frac = kappa - kf
    if kf >= n:
        return torch.sum(az), torch.sign(z)
    k_take = min(n, kf + (1 if frac > 0 else 0))
    if k_take == 0:
        return torch.zeros((), dtype=az.dtype, device=z.device), \
            torch.zeros_like(z)
    order = torch.sort(az, descending=True, stable=True)
    vals, idx = order.values[:k_take], order.indices[:k_take]
    wts = torch.ones(k_take, dtype=az.dtype, device=z.device)
    if frac > 0 and k_take == kf + 1:
        wts[-1] = frac
    w = torch.zeros_like(az).index_put_((idx,), wts)
    return torch.sum(vals * wts), torch.sign(z) * w


def support_skappa_bisect(z: torch.Tensor, kappa, iters: int = 60,
                          sum_fn=torch.sum, max_fn=torch.max):
    """Scalar-bisection variant of :func:`support_skappa`
    (``repro.core.bilinear.support_skappa_bisect``): approximate to the
    bisection's resolution; the fixed-count loop reads nothing back to the
    host."""
    az = torch.abs(z)
    kap = torch.as_tensor(kappa, dtype=az.dtype, device=az.device)
    hi = max_fn(az)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_many = sum_fn((az > mid).to(az.dtype)) > kap
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi,
                                                              mid)
    above = (az > hi).to(az.dtype)
    boundary = ((az > lo) & (az <= hi)).to(az.dtype)
    cnt_bnd = sum_fn(boundary)
    leftover = torch.clamp_min(kap - sum_fn(above), 0.0)
    bnd_w = torch.where(cnt_bnd > 0,
                        leftover / torch.where(cnt_bnd > 0, cnt_bnd, 1.0),
                        0.0)
    w = above + bnd_w * boundary
    return sum_fn(az * w), torch.sign(z) * w


def support_skappa_ladder(z: torch.Tensor, kappa, *,
                          ops: LadderOps = DEFAULT_OPS,
                          rounds: int | None = None, B: int = LADDER_B,
                          cap: int = NEWTON_CAP):
    """Exact sort-free ``max_{s in S^kappa} z^T s`` and an argmax
    (``repro.core.bilinear.support_skappa_ladder``). ``z`` (B, d) with a
    (B,) tensor ``kappa`` (on z's device) takes every lane."""
    if rounds is None:
        rounds = default_rounds(z.device)
    if z.ndim == 2:
        if _lanes_on_card(z, ops, B, "support_skappa_ladder"):
            return skappa_support_lanes_auto(z, kappa, rounds=rounds,
                                             cap=cap)
        return _support_lanes(z, kappa, rounds, B, cap)
    if _one_launch(z, ops, B) and not (torch.is_tensor(kappa)
                                       and kappa.device.type != "cpu"):
        return skappa_support_auto(z, kappa, rounds=rounds, cap=cap)
    az = torch.abs(z)
    dt = az.dtype
    kap = torch.as_tensor(kappa, dtype=dt, device=z.device)
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
    """Closed-form ADMM s-step (12): argmin_{s in S^kappa} (z^T s - (t - v))^2
    (per lane for z (B, d) with (B,) t, v and kappa)."""
    if method == "sort":
        u_max, s_star = support_skappa_sort(z, kappa)
    else:
        u_max, s_star = support_skappa_ladder(z, kappa, ops=ops,
                                              rounds=rounds)
    c = torch.as_tensor(t - v, dtype=z.dtype, device=z.device)
    c_cl = torch.minimum(torch.maximum(c, -u_max), u_max)
    theta = torch.where(u_max > 0,
                        c_cl / torch.where(u_max > 0, u_max, 1.0), 0.0)
    if z.ndim == 2:
        return theta[:, None] * s_star
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


def hard_threshold_lanes(z: torch.Tensor, kappa: torch.Tensor
                         ) -> torch.Tensor:
    """:func:`hard_threshold` of every row of z (B, d) at its own kappa
    (B,): the ceil(kappa) largest magnitudes, ties to the lower index (the
    same entries the solo function keeps)."""
    order = torch.sort(torch.abs(z), dim=-1, descending=True,
                       stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(z.shape[-1], device=z.device).expand_as(
            order).contiguous())
    keep = ranks < torch.ceil(kappa.to(torch.float64)).to(ranks.dtype)[:, None]
    return torch.where(keep, z, 0.0)


def check_theorem_certificate(x: torch.Tensor, kappa, tol: float = 1e-6
                              ) -> dict[str, torch.Tensor]:
    """The (s, t) certificate of Theorem 2.1 for a kappa-sparse x, and the
    residuals of its four conditions (``repro.core.bilinear
    .check_theorem_certificate``)."""
    t = torch.sum(torch.abs(x))
    s = torch.sign(x)   # ||s||_1 = ||x||_0 <= kappa when x is kappa-sparse
    return {
        "bilinear": torch.abs(g(x, s, t)),
        "l1_x": torch.clamp_min(torch.sum(torch.abs(x)) - t, 0.0),
        "l1_s": torch.clamp_min(torch.sum(torch.abs(s)) - kappa, 0.0),
        "linf_s": torch.clamp_min(torch.max(torch.abs(s)) - 1.0, 0.0),
    }


# --------------------------------------------------------------------------
# lanes
# --------------------------------------------------------------------------
def _lanes_on_card(z: torch.Tensor, ops: LadderOps, B: int,
                   what: str) -> bool:
    """Whether lanes z (B, d) go to a lane kernel: every CUDA lane operand
    does, or raises where no lane kernel takes it; CPU lanes run the
    composed path."""
    if z.device.type != "cuda":
        return False
    if ops is not DEFAULT_OPS or B != LADDER_B:
        raise ValueError(f"{what}: lanes on the card take the default "
                         f"reductions and {LADDER_B} rungs (the lane "
                         "kernels)")
    if z.dtype != torch.float32 or not bisect_proj.plan(
            z.shape[-1]).one_launch:
        raise ValueError(f"{what}: no lane kernel for {z.dtype} rows of "
                         f"{z.shape[-1]} entries (float32, at most "
                         f"{bisect_proj.MAX_N})")
    return True


def _rung_crossings(az, th, kap_or_t0, l1: bool):
    """Per lane: the number of leading rungs of th (L, B) on the h > 0
    (``l1``) or count > kappa side, from (L, d, B) f32 terms."""
    d = az[:, :, None] - th[:, None, :]
    if l1:
        h = torch.clamp_min(d, 0.0).sum(1) - kap_or_t0[:, None] - th
        return torch.sum(h > 0, 1)
    return torch.sum((d > 0).to(az.dtype).sum(1) > kap_or_t0[:, None], 1)


def _lane_bracket(az, lo, hi, rounds, B, target, l1: bool):
    """``rounds`` bracketing rounds of every lane's [lo, hi]."""
    ar = torch.arange(1, B + 1, dtype=lo.dtype, device=lo.device)
    for _ in range(rounds):
        th = lo[:, None] + (hi - lo)[:, None] * ar / B
        idx = _rung_crossings(az, th, target, l1)
        below = th.gather(1, torch.clamp_min(idx - 1, 0)[:, None])[:, 0]
        above = th.gather(1, torch.clamp_max(idx, B - 1)[:, None])[:, 0]
        lo, hi = (torch.where(idx == 0, lo, below),
                  torch.where(idx == B, hi, above))
    return lo, hi


def _project_lanes(z0, t0, rounds, B, cap, polish64: bool = False):
    """:func:`project_l1_epigraph`'s composed path on every lane (the
    default reductions per row; ``polish64``: the polish in f64)."""
    dt = z0.dtype
    t0 = torch.as_tensor(t0, dtype=dt, device=z0.device).expand(
        z0.shape[0])
    az = torch.abs(z0)
    abs_sum = torch.sum(az, -1)
    hi0 = torch.amax(az, -1)
    inside = abs_sum <= t0
    apex = (-t0 - hi0) > 0
    lo = torch.zeros_like(hi0)
    if rounds:
        lo, _ = _lane_bracket(az, lo, hi0, rounds, B, t0, True)
    pdt = torch.float64 if polish64 else dt
    azp, t0p, lo = az.to(pdt), t0.to(pdt), lo.to(pdt)

    def propose(th):
        d = azp - th[:, None]
        hv = torch.clamp_min(d, 0.0).sum(-1) - t0p - th
        return torch.maximum(th + hv / ((d > 0).to(pdt).sum(-1) + 1.0), th)

    def step(state):
        th, _ = state
        new = propose(th)
        return (new, th), new > th

    theta0 = propose(lo)
    theta, _ = _masked_loop(step, (theta0, lo), theta0 > lo, 1, cap)
    theta = torch.where(inside, 0.0, theta.to(dt))
    to_apex = apex & ~inside
    z = torch.where(to_apex[:, None], 0.0,
                    torch.sign(z0) * torch.clamp_min(az - theta[:, None],
                                                     0.0))
    t = torch.where(to_apex, torch.clamp_min(t0, 0.0), t0 + theta)
    return z, t


def _support_lanes(z, kappa, rounds, B, cap):
    """:func:`support_skappa_ladder`'s composed path on every lane."""
    az = torch.abs(z)
    dt = az.dtype
    kap = torch.as_tensor(kappa, device=z.device).to(dt).expand(z.shape[0])
    hi0 = torch.amax(az, -1)
    c0 = (az > 0).to(dt).sum(-1)
    all_in = c0 <= kap
    lo, hi = torch.zeros_like(hi0), hi0
    if rounds:
        lo, hi = _lane_bracket(az, lo, hi, rounds, B, kap, False)
    neg_inf = torch.full_like(hi0, -math.inf)
    pos_inf = torch.full_like(hi0, math.inf)

    def count(x):
        return ((az - x[:, None]) > 0).to(dt).sum(-1)

    def step(state):
        lo, hi, _, _, _ = state
        band = (az > lo[:, None]) & (az <= hi[:, None])
        a = (torch.where(band, az, 0.0).sum(-1)
             / torch.clamp_min(band.to(dt).sum(-1), 1.0))
        a = torch.minimum(torch.maximum(a, torch.nextafter(lo, pos_inf)), hi)
        am = torch.nextafter(a, neg_inf)
        ap = torch.nextafter(a, pos_inf)
        cm, ca, cp = count(am), count(a), count(ap)
        done1 = (cm > kap) & (kap >= ca)
        done2 = (ca > kap) & (kap >= cp)
        done = done1 | done2
        tau = torch.where(done2, ap, a)
        c_tau = torch.where(done2, cp, ca)
        ceq = torch.where(done2, ca - cp, cm - ca)
        go_lo = (~done) & (ca > kap)
        lo_n = torch.where(go_lo, a, lo)
        hi_n = torch.where((~done) & (~go_lo), am, hi)
        return (lo_n, hi_n, tau, c_tau, ceq), ~done

    zero = torch.zeros_like(c0)
    _, _, tau, c_tau, ceq = _masked_loop(step, (lo, hi, hi, zero, zero),
                                         ~all_in, 0, cap)
    tau = torch.where(all_in, 0.0, tau)
    c_tau = torch.where(all_in, c0, c_tau)
    ceq = torch.where(all_in, 0.0, ceq)
    above = (az > tau[:, None]).to(dt)
    at_tau = ((az == tau[:, None]) & (tau[:, None] > 0)).to(dt)
    leftover = torch.minimum(torch.clamp_min(kap - c_tau, 0.0),
                             torch.clamp_min(ceq, 0.0))
    bnd_w = torch.where(ceq > 0, leftover / torch.where(ceq > 0, ceq, 1.0),
                        0.0)
    w = above + bnd_w[:, None] * at_tau
    return torch.sum(az * w, -1), torch.sign(z) * w

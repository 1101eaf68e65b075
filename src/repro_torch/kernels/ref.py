"""Plain PyTorch versions of every ported kernel — the CPU rows of the
registry and the oracles the CUDA kernels are held against
(counterpart of ``repro.kernels.ref``).

Each solver product accepts an optional leading node axis: ``a`` of shape
``(m, n)`` or ``(N, m, n)`` with operands shaped to match; the block
products take the node axis always. Operands of any float type (bf16 and
fp16 data included) are widened to f32, which is exact, and the product is
computed in f32 (the Gram of bf16 / fp16 operands in f64, rounded once);
the registry rows (:mod:`.ops`) round the f32 result once to the output
dtype. The attention oracle takes the flat
head-major layout of the kernel.
"""
from __future__ import annotations

import math

import torch

from ..runtime import REDUCED

f32 = torch.float32


def gram_ref(a: torch.Tensor) -> torch.Tensor:
    """A^T A in f32 (see :func:`gram_xy_ref`)."""
    return gram_xy_ref(a, a)


def gram_xy_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """X^T Y in f32; for bf16 / fp16 operands an f64 product rounded once
    (their products are exact, so this is the correctly rounded Gram, as
    ``csrc/gram.cu`` forms it)."""
    if x.dtype in REDUCED and y.dtype in REDUCED:
        return (x.double().mT @ y.double()).to(f32)
    return x.to(f32).mT @ y.to(f32)


def ladder_stats_ref(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """(2, B): [sum max(az - theta, 0); count(az > theta)]."""
    diff = az.to(f32)[:, None] - thetas.to(f32)[None, :]
    return torch.stack([torch.clamp_min(diff, 0.0).sum(0),
                        (diff > 0).to(f32).sum(0)])


LADDER_RUNGS = 128   # B of the projections' bracketing rounds
LADDER_CAP = 64      # cap on polish / search steps


def _sum_once(x: torch.Tensor, dim=None) -> torch.Tensor:
    """A projection's sum of f32 terms: accumulated in f64 and rounded to
    f32 once, so the order of the terms does not matter except in rare f32
    ties (the f64 sum is exact only while the terms' exponent spread plus
    log2 n fits in f64's 29 spare bits)."""
    x = x.double()
    return (x.sum() if dim is None else x.sum(dim)).float()


def l1_epigraph_proj_ref(z0: torch.Tensor, t0, *, rounds: int = 2,
                         cap: int = LADDER_CAP, stats: bool = False,
                         polish64: bool = False):
    """Projection of (z0, t0) onto {(z, t): ||z||_1 <= t} -- the plain
    version of ``csrc/ladder_proj.cu``'s ``l1_proj_kernel``: one lane of
    :func:`l1_epigraph_proj_lanes_ref`. With ``stats`` theta and the
    polish steps taken (an int) follow."""
    t0 = torch.as_tensor(t0, dtype=f32, device=z0.device).reshape(1)
    out = l1_epigraph_proj_lanes_ref(z0[None], t0, rounds=rounds, cap=cap,
                                     stats=stats, polish64=polish64)
    if stats:
        return out[0][0], out[1][0], out[2][0], int(out[3][0])
    return out[0][0], out[1][0]


def skappa_support_ref(z: torch.Tensor, kappa, *, rounds: int = 2,
                       cap: int = LADDER_CAP, stats: bool = False):
    """(max over S^kappa of z^T s, an argmax s*) -- the plain version of
    ``csrc/ladder_proj.cu``'s ``skappa_kernel``: one lane of
    :func:`skappa_support_lanes_ref`. With ``stats`` the search steps
    taken (an int) follow."""
    kappa = torch.as_tensor(kappa, dtype=f32, device=z.device).reshape(1)
    out = skappa_support_lanes_ref(z[None], kappa, rounds=rounds, cap=cap,
                                   stats=stats)
    if stats:
        return out[0][0], out[1][0], int(out[2][0])
    return out[0][0], out[1][0]


# (lane, entry, rung) terms a bracketing round of the lane versions forms at
# once: larger operands take their rounds in blocks of lanes
_LANE_TERMS = 2 ** 24


def _lane_rounds(az, lo, hi, rounds, crossing):
    """``rounds`` bracketing rounds of every lane's [lo, hi] (L,) over the
    rungs lo + (hi - lo) * b / B, b = 1..B, of az (L, d);
    ``crossing(az_rows, th (l, B), rows)`` is each row's count of leading
    rungs on the h > 0 / count > kappa side."""
    B = LADDER_RUNGS
    ar = torch.arange(1, B + 1, dtype=f32, device=az.device)
    L, d = az.shape
    step = max(1, _LANE_TERMS // max(1, d * B))
    for _ in range(rounds):
        th = lo[:, None] + (hi - lo)[:, None] * ar / B
        idx = torch.cat([crossing(az[i:i + step], th[i:i + step],
                                  slice(i, i + step))
                         for i in range(0, L, step)])
        below = th.gather(1, torch.clamp_min(idx - 1, 0)[:, None])[:, 0]
        above = th.gather(1, torch.clamp_max(idx, B - 1)[:, None])[:, 0]
        lo, hi = (torch.where(idx == 0, lo, below),
                  torch.where(idx == B, hi, above))
    return lo, hi


def l1_epigraph_proj_lanes_ref(z0: torch.Tensor, t0, *, rounds: int = 2,
                               cap: int = LADDER_CAP, stats: bool = False,
                               polish64: bool = False):
    """The projection of every row of z0 (L, d) with its own t0 (L,) onto
    {(z, t): ||z||_1 <= t} -- the plain version of ``csrc/ladder_proj.cu``'s
    ``l1_lanes_kernel`` (and, on one lane, of ``l1_proj_kernel``): the
    composed ``bilinear.project_l1_epigraph`` at ``rounds`` rounds, every
    sum (sum |z0|, the rungs', the polish's) in f64 over its row rounded
    once, the rounds and the polish only where theta is used (neither
    inside nor apex: theta is 0 there), the polish run with a mask until
    every lane is at its own fixpoint. With ``stats`` theta (L,) and the
    polish steps (L,) follow. ``polish64``: the f64-polish instantiation's
    plain version, the polish's theta, terms (|z| - theta), sums and step
    in f64 (the rounds still in f32) and theta rounded to f32 once."""
    z0 = z0.to(f32)
    L = z0.shape[0]
    t0 = torch.as_tensor(t0, dtype=f32, device=z0.device).expand(L)
    az = z0.abs()
    hi0 = az.amax(1)
    inside = _sum_once(az, 1) <= t0
    apex = (-t0 - hi0) > 0
    need = ~inside & ~apex

    def crossing(a, th, rows):
        d = a[:, :, None] - th[:, None, :]
        h = _sum_once(torch.clamp_min(d, 0.0), 1) - t0[rows, None] - th
        return torch.sum(h > 0, 1)

    th, _ = _lane_rounds(az, torch.zeros_like(hi0), hi0, rounds, crossing)
    k = torch.zeros(L, dtype=torch.int32, device=z0.device)
    active = need.clone()
    if polish64:
        az_p, t0_p, th = az.double(), t0.double(), th.double()
    else:
        az_p, t0_p = az, t0
    while bool(active.any()):    # the monotone polish, lane by lane
        d = az_p - th[:, None]
        hv = (torch.clamp_min(d, 0.0).sum(1) if polish64
              else _sum_once(torch.clamp_min(d, 0.0), 1)) - t0_p - th
        cnt = (d > 0).sum(1).to(th.dtype)
        new = torch.maximum(th + hv / (cnt + 1.0), th)
        k = k + active.to(torch.int32)
        go = active & (new > th) & (k < cap)
        th = torch.where(active, new, th)
        active = go
    theta = torch.where(need, th.to(f32), 0.0)
    to_apex = (apex & ~inside)[:, None]
    z = torch.where(to_apex, 0.0,
                    torch.sign(z0) * torch.clamp_min(az - theta[:, None],
                                                     0.0))
    t = torch.where(apex & ~inside, torch.clamp_min(t0, 0.0), t0 + theta)
    return (z, t, theta, k) if stats else (z, t)


def skappa_support_lanes_ref(z: torch.Tensor, kappa, *, rounds: int = 2,
                             cap: int = LADDER_CAP, stats: bool = False):
    """(max over S^kappa of z^T s, an argmax s*) of every row of z (L, d)
    with its own kappa (L,) -- the plain version of ``skappa_lanes_kernel``
    (and, on one lane, of ``skappa_kernel``): the composed
    ``bilinear.support_skappa_ladder`` at ``rounds`` rounds, the band sum
    and u_max in f64 rounded once, the pivot search run with a mask until
    every lane is done; s* depends on counts alone. With ``stats`` the
    search steps (L,) follow."""
    z = z.to(f32)
    L = z.shape[0]
    az = z.abs()
    kap = torch.as_tensor(kappa, device=z.device).to(f32).expand(L)
    zero = torch.zeros(L, dtype=f32, device=z.device)
    c0 = (az > 0).sum(1).to(f32)
    search = ~(c0 <= kap)

    def crossing(a, th, rows):
        cnt = (a[:, :, None] - th[:, None, :] > 0).to(f32).sum(1)
        return torch.sum(cnt > kap[rows, None], 1)

    lo, hi = _lane_rounds(az, zero, az.amax(1), rounds, crossing)
    up = torch.full_like(zero, math.inf)
    down = torch.full_like(zero, -math.inf)
    tau, c_tau, ceq = torch.where(search, hi, 0.0), torch.where(
        search, 0.0, c0), zero
    k = torch.zeros(L, dtype=torch.int32, device=z.device)
    active = search & (k < cap)
    while bool(active.any()):    # the mean-pivot search, lane by lane
        band = (az > lo[:, None]) & (az <= hi[:, None])
        a = (_sum_once(torch.where(band, az, 0.0), 1)
             / torch.clamp_min(band.sum(1).to(f32), 1.0))
        a = torch.minimum(torch.maximum(a, torch.nextafter(lo, up)), hi)
        am, ap = torch.nextafter(a, down), torch.nextafter(a, up)
        cm, ca, cp = ((az > x[:, None]).sum(1).to(f32) for x in (am, a, ap))
        done1 = (cm > kap) & (kap >= ca)   # crossing in (am, a]
        done2 = (ca > kap) & (kap >= cp)   # crossing in (a, ap]
        done = done1 | done2
        tau = torch.where(active, torch.where(done2, ap, a), tau)
        c_tau = torch.where(active, torch.where(done2, cp, ca), c_tau)
        ceq = torch.where(active, torch.where(done2, ca - cp, cm - ca), ceq)
        move = active & ~done
        go_lo = ca > kap
        lo = torch.where(move & go_lo, a, lo)
        hi = torch.where(move & ~go_lo, am, hi)
        k = k + active.to(torch.int32)
        active = move & (k < cap)
    leftover = torch.minimum(torch.clamp_min(kap - c_tau, 0.0),
                             torch.clamp_min(ceq, 0.0))
    bnd_w = torch.where(ceq > 0, leftover / torch.where(ceq > 0, ceq, 1.0),
                        0.0)
    w = ((az > tau[:, None]).to(f32) + bnd_w[:, None]
         * ((az == tau[:, None]) & (tau[:, None] > 0)).to(f32))
    out = (_sum_once(az * w, 1), torch.sign(z) * w)
    return (*out, k) if stats else out


def chol_rank_update_ref(L: torch.Tensor, V: torch.Tensor, sign: float):
    """(L', ok) with L' L'^T = L L^T + sign V V^T for the lower factor L
    (n, n) and V (n, k) or (n,) -- the plain version of
    ``csrc/chol_update.cu``: the LINPACK rank-1 recurrence of
    ``repro.core.prox._chol_rank1`` (Givens rotations for sign +1,
    hyperbolic ones for -1), one vector after the other, column by column,
    each operation rounded on its own. ``ok`` (a 0-d bool) is False once a
    pivot lost definiteness (a downdate of energy the factor does not
    hold); L' is then garbage."""
    L = L.clone()
    V = V if V.ndim == 2 else V[:, None]
    n = L.shape[0]
    tiny = torch.finfo(L.dtype).tiny
    ok = torch.ones((), dtype=torch.bool, device=L.device)
    for p in range(V.shape[1]):
        v = V[:, p].to(L.dtype).clone()
        for j in range(n):
            ljj, vj = L[j, j], v[j]
            r2 = ljj * ljj + sign * vj * vj
            ok = ok & (r2 > 0) & (ljj > 0)
            r = torch.sqrt(torch.clamp_min(r2, tiny))
            den = torch.clamp_min(ljj, tiny)
            c, s = r / den, vj / den
            col = (L[j + 1:, j] + sign * s * v[j + 1:]) / c
            v[j + 1:] = c * v[j + 1:] - s * col
            L[j + 1:, j] = col
            L[j, j] = r
    return L, ok


def _vec_as_mat(a: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``v`` with a trailing right-hand-side axis (and whether it had none):
    a 1-D operand of a 2-D ``a``, or a 2-D operand of a 3-D ``a``."""
    one = v.ndim == a.ndim - 1
    return (v[..., None] if one else v), one


def matvec_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """a @ x in f32; x is (n,) / (n, K) for 2-D a, (N, n) / (N, n, K) for
    3-D a."""
    x2, one = _vec_as_mat(a, x)
    out = a.to(f32) @ x2.to(f32)
    return out[..., 0] if one else out


def rmatvec_ref(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a^T @ y in f32 (operand shapes as in :func:`matvec_ref`)."""
    y2, one = _vec_as_mat(a, y)
    out = a.to(f32).mT @ y2.to(f32)
    return out[..., 0] if one else out


def normal_matvec_ref(a: torch.Tensor, p: torch.Tensor, shift) -> torch.Tensor:
    """(A^T A + diag(shift)) p in f32, w = A p included (as the JAX
    package's CPU row keeps it), rounded once to the promoted type of a and
    p."""
    pf = p.to(f32)
    w = matvec_ref(a, pf)
    return (rmatvec_ref(a, w) + shift * pf).to(
        torch.promote_types(a.dtype, p.dtype))


def block_widths(n: int, nb: int, M: int) -> tuple[int, int]:
    """(full, rest): the number of blocks that hold nb columns of A, and the
    width of the one ragged block after them (0 when there is none)."""
    full = min(M, n // nb)
    return full, (n - full * nb if full < M else 0)


def block_matvec_ref(a: torch.Tensor, x_blocks: torch.Tensor,
                     M: int) -> torch.Tensor:
    """Per feature block j: A_j @ x_j, in f32 (bf16 / fp16 ``a`` widened
    exactly: the plain version of the half-width kernels too).

    ``a`` (N, m, n) row-major, ``x_blocks`` (N, M, nb, K) with nb = ceil(n/M);
    block j is the columns [j nb, min(n, (j+1) nb)) of ``a``. Entries of
    ``x_blocks`` past n are the zero padding and add nothing. Returns
    (N, M, m, K): the einsum ``jmn,jnk->jmk`` of ``repro.kernels.ops`` on the
    zero-padded blocks, per node.
    """
    N, m, n = a.shape
    nb, K = x_blocks.shape[2], x_blocks.shape[3]
    full, rest = block_widths(n, nb, M)
    af, xf = a.to(f32), x_blocks.to(f32)
    out = torch.zeros((N, M, m, K), dtype=f32, device=a.device)
    if full:
        a_full = af[..., :full * nb].unflatten(-1, (full, nb)).transpose(1, 2)
        out[:, :full] = a_full @ xf[:, :full]
    if rest:
        out[:, full] = af[..., full * nb:] @ xf[:, full, :rest]
    return out


def block_rmatvec_ref(a: torch.Tensor, y_blocks: torch.Tensor,
                      M: int) -> torch.Tensor:
    """Per feature block j: A_j^T @ y_j, in f32 (any float ``a`` widened
    exactly). ``y_blocks`` is
    (N, M, m, K); returns (N, M, nb, K) with the padded rows 0 (the einsum
    ``jmn,jmk->jnk`` on the zero-padded blocks)."""
    N, m, n = a.shape
    K = y_blocks.shape[3]
    nb = -(-n // M)
    full, rest = block_widths(n, nb, M)
    af, yf = a.to(f32), y_blocks.to(f32)
    out = torch.zeros((N, M, nb, K), dtype=f32, device=a.device)
    if full:
        a_full = af[..., :full * nb].unflatten(-1, (full, nb)).transpose(1, 2)
        out[:, :full] = a_full.mT @ yf[:, :full]
    if rest:
        out[:, full, :rest] = af[..., full * nb:].mT @ yf[:, full]
    return out


def flash_attention_flat_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             sm_scale: float | None = None) -> torch.Tensor:
    """Softmax attention with grouped-query heads: q (BHq, Sq, Dh), k/v
    (BHkv, Sk, Dh) head-major, query row b reading KV row b // (BHq / BHkv).
    Scores and softmax in f32, causal mask top-left aligned (masked scores
    -1e30); the output is cast to q.dtype."""
    BH, Sq, Dh = q.shape
    BHkv, Sk, _ = k.shape
    group = BH // BHkv
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.to(f32), k.to(f32)) * sm_scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(qpos < torch.arange(Sk, device=q.device), -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.to(f32)).to(q.dtype)

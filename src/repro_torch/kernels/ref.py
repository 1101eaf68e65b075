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


def _bracket(az, lo, hi, rounds, crossing):
    """``rounds`` bracketing rounds of [lo, hi] over the rungs
    lo + (hi - lo) * b / B, b = 1..B; ``crossing(th)`` is the number of
    leading rungs on the h > 0 / count > kappa side."""
    B = LADDER_RUNGS
    ar = torch.arange(1, B + 1, dtype=f32, device=az.device)
    for _ in range(rounds):
        th = lo + (hi - lo) * ar / B
        idx = int(crossing(th))
        lo, hi = (lo if idx == 0 else th[idx - 1],
                  hi if idx == B else th[idx])
    return lo, hi


def l1_epigraph_proj_ref(z0: torch.Tensor, t0, *, rounds: int = 2,
                         cap: int = LADDER_CAP, stats: bool = False):
    """Projection of (z0, t0) onto {(z, t): ||z||_1 <= t} -- the plain
    version of ``csrc/ladder_proj.cu``'s ``l1_proj_kernel``: the composed
    ``bilinear.project_l1_epigraph`` at ``rounds`` rounds, with every sum
    (sum |z0|, the rungs', the polish's) in f64 rounded once. The rounds
    and the polish run only where theta is used (neither inside nor apex:
    theta is 0 there). With ``stats`` theta and the polish steps taken
    follow."""
    z0 = z0.to(f32)
    t0 = torch.as_tensor(t0, dtype=f32, device=z0.device)
    az = z0.abs()
    hi0 = az.max()
    inside = bool(_sum_once(az) <= t0)
    apex = bool((-t0 - hi0) > 0)
    theta = torch.zeros((), dtype=f32, device=z0.device)
    k = 0
    if not inside and not apex:
        def crossing(th):
            d = az[:, None] - th[None, :]
            return torch.sum((_sum_once(torch.clamp_min(d, 0.0), 0) - t0
                              - th) > 0)
        th, _ = _bracket(az, torch.zeros_like(hi0), hi0, rounds, crossing)
        while True:      # the monotone closed-form polish to its fixpoint
            prev = th
            d = az - th
            hv = _sum_once(torch.clamp_min(d, 0.0)) - t0 - th
            th = torch.maximum(th + hv / ((d > 0).sum().to(f32) + 1.0), th)
            k += 1
            if not (bool(th > prev) and k < cap):
                break
        theta = th
    if apex and not inside:
        z, t = torch.zeros_like(z0), torch.clamp_min(t0, 0.0)
    else:
        z, t = torch.sign(z0) * torch.clamp_min(az - theta, 0.0), t0 + theta
    return (z, t, theta, k) if stats else (z, t)


def skappa_support_ref(z: torch.Tensor, kappa, *, rounds: int = 2,
                       cap: int = LADDER_CAP, stats: bool = False):
    """(max over S^kappa of z^T s, an argmax s*) -- the plain version of
    ``csrc/ladder_proj.cu``'s ``skappa_kernel``: the composed
    ``bilinear.support_skappa_ladder`` at ``rounds`` rounds, with the band
    sum and u_max in f64 rounded once. s* depends on counts alone. With
    ``stats`` the search steps taken follow."""
    z = z.to(f32)
    az = z.abs()
    kap = torch.as_tensor(kappa, dtype=f32, device=z.device)
    zero = torch.zeros((), dtype=f32, device=z.device)
    c0 = (az > 0).sum().to(f32)
    tau, c_tau, ceq, k = zero, c0, zero, 0
    if not bool(c0 <= kap):              # else fewer than kappa nonzeros
        def crossing(th):
            return torch.sum(ladder_stats_ref(az, th)[1] > kap)
        lo, hi = _bracket(az, zero, az.max(), rounds, crossing)
        up, down = torch.full_like(zero, math.inf), torch.full_like(
            zero, -math.inf)
        tau, c_tau, done = hi, zero, False
        while not done and k < cap:      # the mean-pivot search
            band = (az > lo) & (az <= hi)
            a = (_sum_once(torch.where(band, az, 0.0))
                 / torch.clamp_min(band.sum().to(f32), 1.0))
            a = torch.minimum(torch.maximum(a, torch.nextafter(lo, up)), hi)
            am, ap = torch.nextafter(a, down), torch.nextafter(a, up)
            cm, ca, cp = ((az > x).sum().to(f32) for x in (am, a, ap))
            done1 = bool((cm > kap) & (kap >= ca))   # crossing in (am, a]
            done2 = bool((ca > kap) & (kap >= cp))   # crossing in (a, ap]
            done = done1 or done2
            tau, c_tau, ceq = (ap, cp, ca - cp) if done2 else (a, ca, cm - ca)
            if not done:
                lo, hi = (a, hi) if bool(ca > kap) else (lo, am)
            k += 1
    leftover = torch.minimum(torch.clamp_min(kap - c_tau, 0.0),
                             torch.clamp_min(ceq, 0.0))
    bnd_w = leftover / ceq if bool(ceq > 0) else zero
    w = (az > tau).to(f32) + bnd_w * ((az == tau) & (tau > 0)).to(f32)
    out = (_sum_once(az * w), torch.sign(z) * w)
    return (*out, k) if stats else out


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
    """Per feature block j: A_j @ x_j, in f32.

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
    """Per feature block j: A_j^T @ y_j, in f32. ``y_blocks`` is
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

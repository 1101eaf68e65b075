"""Registry-dispatched entry points around the kernels (counterpart of
``repro.kernels.ops``).

Every ``*_auto`` dispatcher is one lookup in the ``repro_torch.runtime``
registry by the device type of its first tensor:

=================  ==========================  =============================
kernel             cuda row                    cpu row
=================  ==========================  =============================
gram               csrc/gram.cu                plain ``a^T a``
matvec / rmatvec   csrc/matvec.cu              plain ``a @ x`` / ``a^T y``
normal_matvec      csrc/normal_matvec.cu       plain composition
ladder_stats       csrc/ladder_stats.cu        plain broadcast
l1_epigraph_proj   csrc/ladder_proj.cu         plain projection (f64 sums)
skappa_support     csrc/ladder_proj.cu         plain support (f64 sums)
l1_epigraph_proj_  csrc/ladder_proj.cu         plain projection per lane
lanes
skappa_support_    csrc/ladder_proj.cu         plain support per lane
lanes
block_matvec /     csrc/block_matvec.cu        plain products per block
block_rmatvec
flash_attention    csrc/flash_attention.cu     plain softmax attention
chol_rank_update   csrc/chol_update.cu         plain rank-1 recurrence
=================  ==========================  =============================

The l1 projections take ``polish64=`` (precision ``"fp64_polish"``): the
f64-polish instantiations of the same kernels, counted as their kernel's
launches and, by type, under ``l1_epigraph_proj_f64polish`` /
``l1_epigraph_proj_lanes_f64polish``.

There is no default row: a CUDA tensor reaches a kernel or an error.
The kernels and plain versions compute in f32 (bf16 / fp16 data widened
exactly); the rows round that once to ``out_dtype`` when it is given, else
to the natural promotion of the two operands' types, as the JAX package's
CPU row does (``repro/kernels/ops.py:58-63``, ``_matmul_jnp``): bf16 A
against an f32 x gives f32, bf16 A against a bf16 b gives bf16. (Its
Pallas rows round to ``a.dtype`` instead, ``ops.py:54-55``; for f32
operands the two rules agree.)

:func:`launch_counts` reads how many CUDA kernels each wrapper launched
since :func:`reset_launch_counts`: device launches, so a ``ladder_stats``
call or a one-launch projection counts 1, a ``normal_matvec`` call 1 or 2
(``matvec.normal_plan``; the CPU rows count nothing), and a lane
projection 1 whatever its number of lanes.
"""
from __future__ import annotations

import torch

from .. import runtime
from . import build, ref
from .bisect_proj import (l1_epigraph_proj, l1_epigraph_proj_lanes,
                          ladder_stats, skappa_support, skappa_support_lanes)
from .block_matvec import block_matvec, block_rmatvec
from .chol_update import chol_rank_update
from .flash_attention import check_flat, flash_attention_flat
from .gram import gram, gram_xy
from .matvec import matvec, normal_matvec, rmatvec

__all__ = ["block_matvec", "block_matvec_auto", "block_rmatvec",
           "block_rmatvec_auto", "chol_rank_update", "chol_rank_update_auto",
           "flash_attention", "flash_attention_auto",
           "flash_attention_flat", "gram", "gram_auto", "gram_xy",
           "l1_epigraph_proj", "l1_epigraph_proj_auto",
           "l1_epigraph_proj_lanes", "l1_epigraph_proj_lanes_auto",
           "ladder_stats",
           "ladder_stats_auto", "launch_counts", "launch_counts_by_type",
           "matvec", "matvec_auto",
           "normal_matvec", "normal_matvec_auto", "reset_launch_counts",
           "rmatvec", "rmatvec_auto", "skappa_support",
           "skappa_support_auto", "skappa_support_lanes",
           "skappa_support_lanes_auto"]

KERNELS = ("ladder_stats", "l1_epigraph_proj", "skappa_support", "gram",
           "matvec", "rmatvec", "normal_matvec", "block_matvec",
           "block_rmatvec", "flash_attention", "l1_epigraph_proj_lanes",
           "skappa_support_lanes", "chol_rank_update")


def _out(x: torch.Tensor, a: torch.Tensor, v: torch.Tensor,
         out_dtype) -> torch.Tensor:
    return x.to(out_dtype if out_dtype is not None
                else torch.promote_types(a.dtype, v.dtype))


for (_dev, _gram, _mv, _rmv, _nmv, _ls, _l1, _sk, _bmv, _brmv, _l1l,
     _skl) in (
        ("cuda", gram, matvec, rmatvec, normal_matvec, ladder_stats,
         l1_epigraph_proj, skappa_support, block_matvec, block_rmatvec,
         l1_epigraph_proj_lanes, skappa_support_lanes),
        ("cpu", ref.gram_ref, ref.matvec_ref, ref.rmatvec_ref,
         ref.normal_matvec_ref, ref.ladder_stats_ref,
         ref.l1_epigraph_proj_ref, ref.skappa_support_ref,
         ref.block_matvec_ref, ref.block_rmatvec_ref,
         ref.l1_epigraph_proj_lanes_ref, ref.skappa_support_lanes_ref)):
    runtime.register_kernel(
        "gram", _dev,
        lambda a, out_dtype=None, _f=_gram: _out(_f(a), a, a, out_dtype))
    runtime.register_kernel(
        "matvec", _dev,
        lambda a, x, out_dtype=None, _f=_mv: _out(_f(a, x), a, x, out_dtype))
    runtime.register_kernel(
        "rmatvec", _dev,
        lambda a, y, out_dtype=None, _f=_rmv: _out(_f(a, y), a, y,
                                                   out_dtype))
    runtime.register_kernel("normal_matvec", _dev, _nmv)
    runtime.register_kernel("ladder_stats", _dev, _ls)
    runtime.register_kernel("l1_epigraph_proj", _dev, _l1)
    runtime.register_kernel("skappa_support", _dev, _sk)
    runtime.register_kernel("l1_epigraph_proj_lanes", _dev, _l1l)
    runtime.register_kernel("skappa_support_lanes", _dev, _skl)
    runtime.register_kernel(
        "block_matvec", _dev,
        lambda a, x, M, out_dtype=None, _f=_bmv: _out(_f(a, x, M), a, x,
                                                      out_dtype))
    runtime.register_kernel(
        "block_rmatvec", _dev,
        lambda a, y, M, out_dtype=None, _f=_brmv: _out(_f(a, y, M), a, y,
                                                       out_dtype))


def _flash_plain(q, k, v, *, causal=True, sm_scale=None):
    """The CPU row: the JAX contract's argument checks, then the plain
    version."""
    check_flat(q, k, v, causal=causal)
    return ref.flash_attention_flat_ref(q, k, v, causal=causal,
                                        sm_scale=sm_scale)


runtime.register_kernel("flash_attention", "cuda", flash_attention_flat)
runtime.register_kernel("flash_attention", "cpu", _flash_plain)
runtime.register_kernel("chol_rank_update", "cuda", chol_rank_update)
runtime.register_kernel("chol_rank_update", "cpu", ref.chol_rank_update_ref)


def gram_auto(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a^T a (per entry of up to two leading batch axes: nodes, blocks).
    ``gram_auto(A.mT)`` is A A^T, read from the transposed view without a
    copy."""
    return runtime.kernel("gram", a.device.type)(a, out_dtype)


def matvec_auto(a: torch.Tensor, x: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """a @ x through the registry."""
    return runtime.kernel("matvec", a.device.type)(a, x, out_dtype)


def rmatvec_auto(a: torch.Tensor, y: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """a^T @ y through the registry."""
    return runtime.kernel("rmatvec", a.device.type)(a, y, out_dtype)


def normal_matvec_auto(a: torch.Tensor, p: torch.Tensor,
                       shift) -> torch.Tensor:
    """(A^T A + diag(shift)) p without forming A^T A, in the promoted type
    of a and p (f32 for the solver's f32 iterates over any data)."""
    return runtime.kernel("normal_matvec", a.device.type)(a, p, shift)


def block_matvec_auto(a: torch.Tensor, x_blocks: torch.Tensor, M: int,
                      out_dtype=None) -> torch.Tensor:
    """Per feature block A_j @ x_j: ``a`` (N, m, n) read in place,
    ``x_blocks`` (N, M, nb, K) -> (N, M, m, K)."""
    return runtime.kernel("block_matvec", a.device.type)(a, x_blocks, M,
                                                         out_dtype)


def block_rmatvec_auto(a: torch.Tensor, y_blocks: torch.Tensor, M: int,
                       out_dtype=None) -> torch.Tensor:
    """Per feature block A_j^T @ y_j: ``y_blocks`` (N, M, m, K) ->
    (N, M, nb, K), the padded rows 0."""
    return runtime.kernel("block_rmatvec", a.device.type)(a, y_blocks, M,
                                                          out_dtype)


def ladder_stats_auto(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """(2, B) ladder statistics of az against the rungs ``thetas``."""
    return runtime.kernel("ladder_stats", az.device.type)(az, thetas)


def l1_epigraph_proj_auto(z0: torch.Tensor, t0, *, rounds: int, cap: int,
                          polish64: bool = False
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact l1-epigraph projection (z, t) of (z0, t0), one launch on
    the card (``polish64``: the polish in f64)."""
    return runtime.kernel("l1_epigraph_proj", z0.device.type)(
        z0, t0, rounds=rounds, cap=cap, polish64=polish64)


def skappa_support_auto(z: torch.Tensor, kappa, *, rounds: int,
                        cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_max, s_star) of the S^kappa support function, one launch on the
    card."""
    return runtime.kernel("skappa_support", z.device.type)(
        z, kappa, rounds=rounds, cap=cap)


def l1_epigraph_proj_lanes_auto(z0: torch.Tensor, t0: torch.Tensor, *,
                                rounds: int, cap: int, polish64: bool = False
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every row of z0 (B, d) projected with its t0 (B,): (z, t), one
    launch on the card for all B rows (``polish64``: the polish in f64)."""
    return runtime.kernel("l1_epigraph_proj_lanes", z0.device.type)(
        z0, t0, rounds=rounds, cap=cap, polish64=polish64)


def chol_rank_update_auto(L: torch.Tensor, V: torch.Tensor, sign: float):
    """(L', ok): the rank-k Cholesky update (``sign`` +1) or downdate (-1)
    of the lower factor L by the columns of V, through the registry."""
    return runtime.kernel("chol_rank_update", L.device.type)(L, V, sign)


def skappa_support_lanes_auto(z: torch.Tensor, kappa: torch.Tensor, *,
                              rounds: int, cap: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_max (B,), s_star (B, d)) of every row of z with its kappa (B,),
    one launch on the card for all B rows."""
    return runtime.kernel("skappa_support_lanes", z.device.type)(
        z, kappa, rounds=rounds, cap=cap)


def flash_attention_auto(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Flat-layout attention, q (BHq, Sq, Dh) over k/v (BHkv, Sk, Dh),
    through the registry."""
    return runtime.kernel("flash_attention", q.device.type)(q, k, v,
                                                            causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Model-layout wrapper: q (B, Sq, Hq, Dh), k/v (B, Sk, Hkv, Dh) to the
    flat head-major layout, through :func:`flash_attention_auto`, and back
    to (B, Sq, Hq, Dh), as ``repro.kernels.ops.flash_attention``."""
    B, Sq, Hq, Dh = q.shape
    _, Sk, Hkv, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * Hq, Sq, Dh)
    kf = k.transpose(1, 2).reshape(B * Hkv, Sk, Dh)
    vf = v.transpose(1, 2).reshape(B * Hkv, Sk, Dh)
    out = flash_attention_auto(qf, kf, vf, causal=causal)
    return out.reshape(B, Hq, Sq, Dh).transpose(1, 2)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: build.LAUNCHES[name] for name in KERNELS}


def launch_counts_by_type() -> dict[str, int]:
    """The launches of gram, matvec, rmatvec and normal_matvec since the
    last reset by the element type of A (``{"matvec_bf16": n, ...}``), and
    of the l1 projections' f64-polish instantiations
    (``"l1_epigraph_proj_f64polish"``, ``"l1_epigraph_proj_lanes_f64polish"``)."""
    return dict(build.LAUNCHES_BY_TYPE)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    build.LAUNCHES.clear()
    build.LAUNCHES_BY_TYPE.clear()

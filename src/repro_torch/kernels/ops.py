"""Registry-dispatched entry points around the kernels (counterpart of
``repro.kernels.ops``).

Every ``*_auto`` dispatcher is one lookup in the ``repro_torch.runtime``
registry by the device type of its first tensor:

=================  ==========================  =============================
kernel             cuda row                    cpu row
=================  ==========================  =============================
gram               csrc/gram.cu                plain ``a^T a``
matvec / rmatvec   csrc/matvec.cu              plain ``a @ x`` / ``a^T y``
normal_matvec      matvec + rmatvec kernels    plain composition
ladder_stats       csrc/ladder_stats.cu        plain broadcast
=================  ==========================  =============================

There is no default row: a CUDA tensor reaches a kernel or an error.
Outputs are cast to ``a.dtype`` unless ``out_dtype`` is given, as in the
JAX package (``repro/kernels/ops.py:54-63``).

:func:`launch_counts` reads how many CUDA kernels each wrapper launched
since :func:`reset_launch_counts`: device launches, so a two-pass
``ladder_stats`` call counts 2 (the CPU rows count nothing).
"""
from __future__ import annotations

import torch

from .. import runtime
from . import build, ref
from .bisect_proj import ladder_stats
from .gram import gram, gram_xy
from .matvec import matvec, normal_matvec, rmatvec

__all__ = ["gram", "gram_auto", "gram_xy", "ladder_stats",
           "ladder_stats_auto", "launch_counts", "matvec", "matvec_auto",
           "normal_matvec", "normal_matvec_auto", "reset_launch_counts",
           "rmatvec", "rmatvec_auto"]

KERNELS = ("ladder_stats", "gram", "matvec", "rmatvec")


def _out(x: torch.Tensor, like: torch.Tensor, out_dtype) -> torch.Tensor:
    return x.to(out_dtype if out_dtype is not None else like.dtype)


for _dev, _gram, _mv, _rmv, _nmv, _ls in (
        ("cuda", gram, matvec, rmatvec, normal_matvec, ladder_stats),
        ("cpu", ref.gram_ref, ref.matvec_ref, ref.rmatvec_ref,
         ref.normal_matvec_ref, ref.ladder_stats_ref)):
    runtime.register_kernel(
        "gram", _dev,
        lambda a, out_dtype=None, _f=_gram: _out(_f(a), a, out_dtype))
    runtime.register_kernel(
        "matvec", _dev,
        lambda a, x, out_dtype=None, _f=_mv: _out(_f(a, x), a, out_dtype))
    runtime.register_kernel(
        "rmatvec", _dev,
        lambda a, y, out_dtype=None, _f=_rmv: _out(_f(a, y), a, out_dtype))
    runtime.register_kernel("normal_matvec", _dev, _nmv)
    runtime.register_kernel("ladder_stats", _dev, _ls)


def gram_auto(a: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a^T a (per node for a leading node axis). ``gram_auto(A.mT)`` is
    A A^T, read from the transposed view without a copy."""
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
    """(A^T A + diag(shift)) p without forming A^T A."""
    return runtime.kernel("normal_matvec", a.device.type)(a, p, shift)


def ladder_stats_auto(az: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """(2, B) ladder statistics of az against the rungs ``thetas``."""
    return runtime.kernel("ladder_stats", az.device.type)(az, thetas)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: build.LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    build.LAUNCHES.clear()

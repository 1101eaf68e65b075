"""Runtime platform layer of the PyTorch port: device resolution, kernel
registry, ladder rounds and the precision policy.

Counterpart of ``repro.runtime``. Everything device-shaped lives here so
the rest of the port never string-compares device names:

* **Device resolution** — :func:`resolve_device` maps a caller's
  ``device=`` to ``"cuda"`` or ``"cpu"``. ``None`` means the card: with no
  CUDA device the call raises and says how to ask for the CPU. Nothing
  falls back to the CPU on its own.
* **Kernel registry** — every kernel registers a ``"cuda"`` row (the
  hand-written Hopper kernel's wrapper) and a ``"cpu"`` row (its plain
  PyTorch version). Dispatch looks the row up by the tensor's device type.
  There is no ``"default"`` row, so a CUDA tensor can never reach a plain
  version.
* **Ladder rounds** — :func:`ladder_rounds` gives 2 bracketing rounds where
  the one-pass ``ladder_stats`` kernel exists (the card) and 0 on the CPU.
* **Precision policy** — :class:`PrecisionPolicy` and its presets, as in the
  JAX package. This port certifies ``"fp32"`` only; the solver front-end
  rejects the other presets with :class:`CapabilityError`.

Float32 matrix products and convolutions run in full float32 here:
TF32 keeps about three decimal digits, which breaks the f32 kernel parity
bound (rtol 1e-4 / atol 1e-5) the port is held to. Both switches are set
explicitly when this module is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Full float32 for every float32 product on the card (see module docstring).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "DEVICE_TYPES", "PRECISION_PRESETS", "CapabilityError",
    "PrecisionPolicy", "kernel", "kernel_table", "ladder_rounds",
    "precision_name", "register_kernel", "resolve_device",
    "resolve_precision",
]

DEVICE_TYPES = ("cuda", "cpu")


class CapabilityError(ValueError):
    """A request the port cannot honor yet, raised by the front-end before
    any solver code runs (same role as ``repro.api.CapabilityError``)."""


# ---------------------------------------------------------------- device --

def resolve_device(device=None) -> torch.device:
    """The device a solve runs on. ``None`` and ``"cuda"`` mean the card
    and raise ``RuntimeError`` when there is none; ``"cpu"`` must be asked
    for explicitly."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type not in DEVICE_TYPES:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU by "
            "default — pass device='cpu' to run on the CPU")
    return dev


# ------------------------------------------------------- kernel registry --

_REGISTRY: dict[str, dict[str, Callable]] = {}


def register_kernel(name: str, device_type: str, fn: Callable) -> Callable:
    """Register ``fn`` as the ``name`` kernel for ``device_type``
    (``"cuda"``: the kernel wrapper; ``"cpu"``: the plain version)."""
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"kernel rows are {DEVICE_TYPES}, got "
                         f"{device_type!r} (there is no default row)")
    _REGISTRY.setdefault(name, {})[device_type] = fn
    return fn


def kernel(name: str, device_type: str) -> Callable:
    """Resolve the ``name`` kernel for ``device_type`` (``"cuda"`` or
    ``"cpu"``). Raises ``KeyError`` when the row does not exist."""
    try:
        table = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel registered under {name!r}; known: "
                       f"{sorted(_REGISTRY)}") from None
    try:
        return table[device_type]
    except KeyError:
        raise KeyError(f"kernel {name!r} has no row for device type "
                       f"{device_type!r}; has: {sorted(table)}") from None


def kernel_table() -> dict[str, dict[str, Callable]]:
    """A copy of the registry ``{kernel_name: {device_type: fn}}``."""
    return {name: dict(table) for name, table in _REGISTRY.items()}


# Bracketing rounds for the ladder projection: the card evaluates all
# B = 128 rungs in one kernel pass; on the CPU the (n, B) broadcast costs
# more than the polish steps it would save (same table as repro.runtime).
_LADDER_ROUNDS = {"cuda": 2, "cpu": 0}


def ladder_rounds(device_type: str) -> int:
    """Default ladder bracketing rounds for ``device_type``."""
    return _LADDER_ROUNDS[device_type]


# ------------------------------------------------------ precision policy --

_DATA_DTYPES = ("bfloat16", "float16", "float32", "float64")
_ACCUM_DTYPES = ("float32", "float64")
_POLISH_DTYPES = ("float64",)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """What dtype each stage of the solver runs in (see
    ``repro.runtime.PrecisionPolicy`` for the meaning of each field)."""

    data: str | None = None
    accum: str = "float32"
    state: str | None = None
    kkt_polish: str | None = None

    def __post_init__(self):
        for name, allowed, optional in (
                ("data", _DATA_DTYPES, True),
                ("accum", _ACCUM_DTYPES, False),
                ("state", _DATA_DTYPES, True),
                ("kkt_polish", _POLISH_DTYPES, True)):
            val = getattr(self, name)
            if val is None and optional:
                continue
            if val not in allowed:
                raise ValueError(f"PrecisionPolicy.{name}={val!r} not in "
                                 f"{allowed}")


PRECISION_PRESETS: dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy(),
    "bf16": PrecisionPolicy(data="bfloat16", state="float32"),
    "fp16": PrecisionPolicy(data="float16", state="float32"),
    "fp64_polish": PrecisionPolicy(kkt_polish="float64"),
}


def resolve_precision(precision) -> PrecisionPolicy:
    """Resolve a preset name or policy instance to a :class:`PrecisionPolicy`."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    if isinstance(precision, str):
        try:
            return PRECISION_PRESETS[precision]
        except KeyError:
            raise ValueError(
                f"unknown precision preset {precision!r}; known presets: "
                f"{sorted(PRECISION_PRESETS)} (or pass a PrecisionPolicy)"
            ) from None
    raise TypeError("precision must be a preset name or a PrecisionPolicy, "
                    f"got {type(precision).__name__}")


def precision_name(policy: PrecisionPolicy) -> str:
    """Preset name of ``policy`` if it matches one, else a custom tag."""
    for name, preset in PRECISION_PRESETS.items():
        if preset == policy:
            return name
    return (f"custom(data={policy.data},accum={policy.accum},"
            f"state={policy.state},kkt_polish={policy.kkt_polish})")

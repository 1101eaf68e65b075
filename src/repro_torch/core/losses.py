"""Losses of the port (counterpart of ``repro.core.losses``).

This slice ports the squared loss, the sparse least-squares model of the
paper's main experiments. The logistic, hinge, smoothed-hinge and softmax
losses run a Newton-CG x-update that a later slice ports; asking for them
raises :class:`~repro_torch.runtime.CapabilityError`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..runtime import CapabilityError


def _identity(pred: torch.Tensor) -> torch.Tensor:
    return pred


@dataclasses.dataclass(frozen=True)
class Loss:
    """A loss and its oracles (see ``repro.core.losses.Loss``)."""
    name: str
    value: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    grad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    prox_omega: Callable
    n_classes: int = 1
    decision: Callable[[torch.Tensor], torch.Tensor] = _identity
    predict: Callable[[torch.Tensor], torch.Tensor] = _identity


def _sq_value(pred, b):
    return 0.5 * torch.sum((pred - b) ** 2)


def _sq_grad(pred, b):
    return pred - b


def _sq_prox(q, b, c):
    # argmin_w 1/2 (w-b)^2 + c/2 (w-q)^2  = (b + c q) / (1 + c)
    return (b + c * q) / (1.0 + c)


squared = Loss("squared", _sq_value, _sq_grad, _sq_prox)

REGISTRY: dict[str, Loss] = {"squared": squared}
UNPORTED = ("logistic", "hinge", "smoothed_hinge", "softmax")


def get_loss(name: str, n_classes: int = 1) -> Loss:
    """The registry loss ``name``; the losses of a later slice raise
    :class:`CapabilityError`."""
    if name in REGISTRY and n_classes == 1:
        return REGISTRY[name]
    if name in UNPORTED or name.startswith("softmax"):
        raise CapabilityError(
            f"loss {name!r} is not ported to repro_torch yet (it needs the "
            "Newton-CG x-update); use loss='squared' or the JAX package")
    raise KeyError(f"unknown loss {name!r}; known: {sorted(REGISTRY)}")

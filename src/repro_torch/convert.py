"""Carry solver state and results between the JAX package and the port.

A JAX ``BiCADMMState`` crosses as a dict of numpy arrays
(``{k: np.asarray(v) for k, v in st._asdict().items()}``, with
``inner=None``); :func:`state_from_numpy` turns it into the port's state on
a device, and :func:`state_to_numpy` / :func:`result_to_numpy` go back.
Warm starts then move between the packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bicadmm import BiCADMMState
from .core.results import FitResult

_INT_FIELDS = ("k",)


def state_from_numpy(d: dict, device) -> BiCADMMState:
    """The port's state from a dict of numpy arrays (one per field)."""
    if d.get("inner") is not None:
        raise ValueError("feature-split sub-solver state is not ported; "
                         "carry a state with inner=None")
    fields = {}
    for name in BiCADMMState._fields:
        if name == "inner":
            continue
        arr = np.array(d[name])          # a writable copy
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        fields[name] = torch.as_tensor(arr, device=device).to(dtype)
    return BiCADMMState(**fields, inner=None)


def state_to_numpy(st: BiCADMMState) -> dict:
    """A dict of numpy arrays, one per state field (``inner`` is None)."""
    return {name: (None if val is None else val.detach().cpu().numpy())
            for name, val in st._asdict().items()}


def result_to_numpy(res: FitResult) -> dict:
    """The result's arrays as numpy, with its state as a nested dict."""
    out = {}
    for name in ("coef", "z", "support", "iters", "p_r", "d_r", "b_r",
                 "status"):
        val = getattr(res, name)
        out[name] = None if val is None else val.detach().cpu().numpy()
    out["state"] = None if res.state is None else state_to_numpy(res.state)
    return out

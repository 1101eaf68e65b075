"""Carry solver state and results between the JAX package and the port.

A JAX ``BiCADMMState`` crosses as a dict of numpy arrays, one per field
(``{k: np.asarray(v) for k, v in st._asdict().items() if k != "inner"}``).
Its ``inner`` field, the feature-split sub-solver's state, crosses as
``None``, as a dict of the three arrays ``x_blocks`` / ``nu`` /
``omega_bar``, or as any object with those attributes (the JAX
``SubsolverState`` itself). :func:`state_from_numpy` turns it into the
port's state on a device, and :func:`state_to_numpy` /
:func:`result_to_numpy` go back, with ``inner`` as a dict. Warm starts then
move between the packages. :func:`path_to_numpy` does the same for a
:class:`~repro_torch.core.results.SparsePath`, and :func:`fleet_to_numpy`
for a :class:`~repro_torch.core.results.FleetResult`;
:func:`fleet_state_from_numpy` takes a fleet's batched state (a JAX
``FleetResult.state``, each field with its leading lane axis), so a fleet
warm-starts from the other package's.

:func:`lm_params_from_jax` carries the JAX package's LM parameters (a tree
of numpy arrays) into the port's model.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.bicadmm import BiCADMMState
from .core.results import FitResult, FleetResult, SparsePath
from .core.subsolver import SubsolverState
from .models import transformer, zoo

_INT_FIELDS = ("k",)
_INNER_FIELDS = tuple(f.name for f in dataclasses.fields(SubsolverState))


def _tensor(arr, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(arr), device=device).to(dtype)


def _inner_from(inner, device) -> SubsolverState | None:
    if inner is None:
        return None
    get = inner.__getitem__ if isinstance(inner, Mapping) else (
        lambda name: getattr(inner, name))
    return SubsolverState(**{name: _tensor(get(name), device)
                             for name in _INNER_FIELDS})


def state_from_numpy(d: dict, device) -> BiCADMMState:
    """The port's state from a dict of numpy arrays (one per field)."""
    fields = {}
    for name in BiCADMMState._fields:
        if name == "inner":
            continue
        dtype = torch.int32 if name in _INT_FIELDS else torch.float32
        fields[name] = _tensor(d[name], device, dtype)
    return BiCADMMState(**fields, inner=_inner_from(d.get("inner"), device))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_to_numpy(st: BiCADMMState) -> dict:
    """A dict of numpy arrays, one per state field; ``inner`` is None or
    the dict of the sub-solver's three arrays."""
    out = {name: _numpy(val) for name, val in st._asdict().items()
           if name != "inner"}
    out["inner"] = (None if st.inner is None else
                    {name: _numpy(getattr(st.inner, name))
                     for name in _INNER_FIELDS})
    return out


def result_to_numpy(res: FitResult) -> dict:
    """The result's arrays as numpy, with its state as a nested dict."""
    out = {}
    for name in ("coef", "z", "support", "iters", "p_r", "d_r", "b_r",
                 "status"):
        val = getattr(res, name)
        out[name] = None if val is None else _numpy(val)
    out["state"] = None if res.state is None else state_to_numpy(res.state)
    return out


def path_to_numpy(path: SparsePath) -> dict:
    """The path's arrays as numpy (the grids as float32 whatever the data
    dtype), its last state as a nested dict and its strategy."""
    out = {}
    for name in SparsePath._fields:
        val = getattr(path, name)
        if name == "state":
            val = None if val is None else state_to_numpy(val)
        elif name in ("kappas", "gammas", "rho_cs"):
            val = _numpy(val.to(torch.float32))
        elif torch.is_tensor(val):
            val = _numpy(val)
        out[name] = val
    return out


def fleet_to_numpy(fleet: FleetResult) -> dict:
    """The fleet's arrays as numpy, its batched state as a nested dict and
    its strategy."""
    out = {}
    for name in FleetResult._fields:
        val = getattr(fleet, name)
        if name == "state":
            val = None if val is None else state_to_numpy(val)
        elif torch.is_tensor(val):
            val = _numpy(val)
        out[name] = val
    return out


def fleet_state_from_numpy(d: dict, device) -> BiCADMMState:
    """The port's batched fleet state from a dict of numpy arrays with a
    leading lane axis (the fleet has no feature-split inner state)."""
    if d.get("inner") is not None:
        raise ValueError("a fleet state has no feature-split inner state")
    return state_from_numpy(d, device)


def lm_params_from_jax(params: Mapping, cfg, device) -> transformer.LM:
    """The port's dense LM with the weights of a JAX ``zoo.init_params``
    tree, given as numpy arrays (any float dtype; cast to ``cfg.dtype``).

    The JAX tree stacks the blocks on a leading L axis and lays dense
    weights out (d_in, d_out) for ``x @ W``; the port's ``nn.Linear``
    weights are (d_out, d_in), so those are transposed. Embedding, LM head
    and norm weights keep their layout."""
    zoo._require_dense(cfg)
    dtype = zoo.dtype_of(cfg.dtype)
    dev = torch.device(device)
    model = transformer.lm_init(None, cfg, dtype, dev)

    def t(arr) -> torch.Tensor:
        return torch.as_tensor(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    blocks = params["blocks"]
    with torch.no_grad():
        model.embed.copy_(t(params["embed"]))
        model.lm_head.copy_(t(params["lm_head"]))
        model.final_norm.copy_(t(params["final_norm"]))
        for i, blk in enumerate(model.blocks):
            blk.norm1.copy_(t(blocks["norm1"][i]))
            blk.norm2.copy_(t(blocks["norm2"][i]))
            for name in ("wq", "wk", "wv", "wo"):
                getattr(blk.attn, name).weight.copy_(
                    t(blocks["attn"][name][i]).T)
            if cfg.qk_norm:
                blk.attn.q_norm.copy_(t(blocks["attn"]["q_norm"][i]))
                blk.attn.k_norm.copy_(t(blocks["attn"]["k_norm"][i]))
            for name in ("w_gate", "w_up", "w_down"):
                getattr(blk.mlp, name).weight.copy_(
                    t(blocks["mlp"][name][i]).T)
    return model

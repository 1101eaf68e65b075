"""Carry solver state and results between the JAX package and the port.

A JAX ``BiCADMMState`` crosses as a dict of numpy arrays, one per field
(``{k: np.asarray(v) for k, v in st._asdict().items() if k != "inner"}``).
Its ``inner`` field, the feature-split sub-solver's state, crosses as
``None``, as a dict of the three arrays ``x_blocks`` / ``nu`` /
``omega_bar``, or as any object with those attributes (the JAX
``SubsolverState`` itself). :func:`state_from_numpy` turns it into the
port's state on a device, and :func:`state_to_numpy` /
:func:`result_to_numpy` go back, with ``inner`` as a dict. Warm starts then
move between the packages. :func:`sharded_state_from_numpy` /
:func:`sharded_state_to_numpy` carry the sharded engine's global state
(a JAX ``ShardedGlobalState``'s eight arrays), so both sharded engines
warm-start from the same state. :func:`path_to_numpy` does the same for a
:class:`~repro_torch.core.results.SparsePath`, and :func:`fleet_to_numpy`
for a :class:`~repro_torch.core.results.FleetResult`;
:func:`fleet_state_from_numpy` takes a fleet's batched state (a JAX
``FleetResult.state``, each field with its leading lane axis), so a fleet
warm-starts from the other package's.

:func:`accum_to_numpy` / :func:`accum_from_numpy` carry the streaming
engine's accumulators (dense, Woodbury, PCG: a dict of numpy arrays, one
per field, which says its kind by its keys), :func:`recovery_to_numpy` /
:func:`recovery_from_numpy` a ``FitResult.recovery`` log (a structured
numpy array of stage, detail, status and iterations), and
:func:`seed_stream` installs another stream's snapshot (its regime, its
accumulators, its replay window's chunks and its state) into a port
``StreamingBiCADMM``, so a port stream continues a JAX one.

:func:`lm_params_from_jax` carries the JAX package's LM parameters (a tree
of numpy arrays) into the port's model, the dense or the hybrid one
(:func:`hybrid_params_from_jax`).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .core.bicadmm import BiCADMMState
from .core.recovery import RecoveryAttempt
from .core.results import FitResult, FleetResult, SparsePath
from .core.sharded import ShardedGlobalState
from .core.streaming import (CGStreamAccum, DenseStreamAccum,
                             StreamingBiCADMM, WoodburyStreamAccum)
from .core.subsolver import SubsolverState
from .models import ssm, transformer, zoo

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


def sharded_state_from_numpy(d, device) -> ShardedGlobalState:
    """The port's sharded global state on ``device`` from a dict of numpy
    arrays, or any object with the eight fields (a JAX
    ``ShardedGlobalState`` itself): x / u (N, n_pad, K), z / s
    (n_pad, K), t, v, nu / omega (n_samples, K)."""
    get = d.__getitem__ if isinstance(d, Mapping) else (
        lambda name: getattr(d, name))
    return ShardedGlobalState(**{name: _tensor(get(name), device)
                                 for name in ShardedGlobalState._fields})


def sharded_state_to_numpy(gs: ShardedGlobalState) -> dict:
    """A dict of numpy arrays, one per field of the sharded global state
    (the JAX ``ShardedGlobalState(**d)`` takes it)."""
    return {name: _numpy(val) for name, val in gs._asdict().items()}


def result_to_numpy(res: FitResult) -> dict:
    """The result's arrays as numpy, with its state as a nested dict."""
    out = {}
    for name in ("coef", "z", "support", "iters", "p_r", "d_r", "b_r",
                 "status"):
        val = getattr(res, name)
        out[name] = None if val is None else _numpy(val)
    out["state"] = (None if res.state is None
                    else sharded_state_to_numpy(res.state)
                    if isinstance(res.state, ShardedGlobalState)
                    else state_to_numpy(res.state))
    out["recovery"] = (None if res.recovery is None
                       else recovery_to_numpy(res.recovery))
    return out


# the streaming accumulators, told apart by their fields
_ACCUMS = (DenseStreamAccum, WoodburyStreamAccum, CGStreamAccum)


def accum_to_numpy(acc) -> dict:
    """A streaming accumulator (the port's or the JAX package's: any object
    with the fields of one) as a dict of numpy arrays, one per field."""
    names = next(tuple(f.name for f in dataclasses.fields(cls))
                 for cls in _ACCUMS
                 if all(hasattr(acc, f.name)
                        for f in dataclasses.fields(cls)))
    vals = {name: getattr(acc, name) for name in names}
    return {name: _numpy(v) if torch.is_tensor(v) else np.asarray(v)
            for name, v in vals.items()}


def accum_from_numpy(d: Mapping, device):
    """The port's accumulator from a dict of numpy arrays (its kind from its
    keys), as float32 tensors on ``device``."""
    for cls in _ACCUMS:
        names = {f.name for f in dataclasses.fields(cls)}
        if names == set(d):
            return cls(**{name: _tensor(d[name], device) for name in names})
    raise ValueError(f"no streaming accumulator has the fields {sorted(d)}")


_RECOVERY_DTYPE = np.dtype([("stage", "U16"), ("detail", "U64"),
                            ("status", np.int32), ("iters", np.int32)])


def recovery_to_numpy(log) -> np.ndarray:
    """A recovery log (a sequence of ``RecoveryAttempt``, the port's or the
    JAX package's) as a structured numpy array."""
    return np.array([(a.stage, a.detail, int(a.status), int(a.iters))
                     for a in log], dtype=_RECOVERY_DTYPE)


def recovery_from_numpy(arr) -> tuple[RecoveryAttempt, ...]:
    """The port's recovery log from :func:`recovery_to_numpy`'s array (or
    any sequence of (stage, detail, status, iters) records)."""
    return tuple(RecoveryAttempt(str(r[0]), str(r[1]), int(r[2]), int(r[3]))
                 for r in arr)


def seed_stream(engine: StreamingBiCADMM, *, mode: str, acc, chunks,
                state=None, m_seen: int | None = None) -> StreamingBiCADMM:
    """Install a stream's snapshot into the port's ``engine`` (a fresh one):
    its regime ``mode``, accumulator ``acc`` (:func:`accum_to_numpy`'s dict
    or an accumulator), the replay window's ``chunks`` (numpy ``(X, y)``
    pairs, oldest first) and the solver ``state`` (a dict of numpy arrays,
    as :func:`state_from_numpy` takes). The next ``partial_fit`` continues
    the stream. Returns ``engine``."""
    dev = engine.device
    pairs = [(torch.as_tensor(np.asarray(X), device=dev),
              torch.as_tensor(np.asarray(y), device=dev))
             for X, y in chunks]
    if pairs:
        engine._admit(*pairs[0])        # the stream's width and data dtype
    engine._chunks = [engine._admit(X, y) for X, y in pairs]
    engine._win_cache = None
    engine._fcache = None
    engine._mode = mode
    engine._acc = (None if acc is None else accum_from_numpy(
        acc if isinstance(acc, Mapping) else accum_to_numpy(acc), dev))
    engine._m = sum(int(X.shape[0]) for X, _ in engine._chunks)
    engine.m_seen = engine._m if m_seen is None else int(m_seen)
    if state is not None:
        # the seeded state stands for the stream's last refit (the drift
        # probe runs from the next chunk on, as in the stream it came from)
        st = state_from_numpy(state, dev)
        engine.adopt(FitResult(st.z.reshape(-1, engine.loss.n_classes),
                               st.z, st.z != 0, st.k, st.p_r, st.d_r,
                               st.b_r, state=st))
    return engine


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


def lm_params_from_jax(params: Mapping, cfg, device) -> zoo.Model:
    """The port's LM with the weights of a JAX ``zoo.init_params`` tree,
    given as numpy arrays (any float dtype; cast to ``cfg.dtype``): the
    dense LM, or for the hybrid family :func:`hybrid_params_from_jax`.

    The JAX tree stacks the blocks on a leading L axis and lays dense
    weights out (d_in, d_out) for ``x @ W``; the port's ``nn.Linear``
    weights are (d_out, d_in), so those are transposed. Embedding, LM head
    and norm weights keep their layout."""
    if zoo._hybrid(cfg):
        return hybrid_params_from_jax(params, cfg, device)
    dtype = zoo.dtype_of(cfg.dtype)
    dev = torch.device(device)
    model = transformer.lm_init(None, cfg, dtype, dev)
    t = _caster(dtype, dev)
    with torch.no_grad():
        _outer_from_jax(model, params, t)
        for i, blk in enumerate(model.blocks):
            _block_from_jax(blk, params["blocks"], cfg, t, i)
    return model


def hybrid_params_from_jax(params: Mapping, cfg,
                           device) -> transformer.HybridLM:
    """The port's hybrid (Zamba2) LM with the weights of a JAX
    ``zoo.init_params`` tree as numpy arrays: the tree's ``mgroups``,
    stacked (G, A, ...), unstacked into ``groups[g][a]``; ``in_proj`` and
    ``out_proj`` transposed into ``nn.Linear`` layout; the conv weights and
    the f32 SSD parameters as they are; the shared block as a dense
    block."""
    dtype = zoo.dtype_of(cfg.dtype)
    dev = torch.device(device)
    model = transformer.hybrid_init(None, cfg, dtype, dev)
    t = _caster(dtype, dev)
    mg = params["mgroups"]
    with torch.no_grad():
        _outer_from_jax(model, params, t)
        _block_from_jax(model.shared, params["shared"], cfg, t)
        for g, group in enumerate(model.groups):
            for a, layer in enumerate(group):
                layer.norm.copy_(t(mg["norm"][g, a]))
                _mamba_from_jax(layer.mamba, {k: v[g, a] for k, v in
                                              mg["mamba"].items()}, t)
    return model


def mamba_params_from_jax(params: Mapping, cfg, device) -> ssm.Mamba2:
    """One Mamba2 mixer from a JAX ``ssm.mamba_init`` tree of numpy
    arrays, as :func:`hybrid_params_from_jax` converts each layer."""
    dtype = zoo.dtype_of(cfg.dtype)
    dev = torch.device(device)
    m = ssm.mamba_init(None, cfg, dtype, dev)
    with torch.no_grad():
        _mamba_from_jax(m, params, _caster(dtype, dev))
    return m


def _mamba_from_jax(m: ssm.Mamba2, tree: Mapping, t) -> None:
    for name in ("in_proj", "out_proj"):
        getattr(m, name).weight.copy_(t(tree[name]).T)
    for name in ("conv_w", "conv_bias_w", "gate_norm", "a_log", "dt_bias",
                 "d_skip"):
        param = getattr(m, name)
        param.copy_(t(tree[name], param.dtype))


def _caster(dtype, dev):
    """numpy -> a tensor on ``dev`` in ``dtype`` (or the given one)."""
    def t(arr, to=dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=to)
    return t


def _outer_from_jax(model, params: Mapping, t) -> None:
    model.embed.copy_(t(params["embed"]))
    model.lm_head.copy_(t(params["lm_head"]))
    model.final_norm.copy_(t(params["final_norm"]))


def _block_from_jax(blk: transformer.Block, tree: Mapping, cfg, t,
                    i: int | None = None) -> None:
    """A dense block from a JAX block tree, entry ``i`` of a stacked one."""
    def leaf(arr):
        return t(arr if i is None else arr[i])
    blk.norm1.copy_(leaf(tree["norm1"]))
    blk.norm2.copy_(leaf(tree["norm2"]))
    for name in ("wq", "wk", "wv", "wo"):
        getattr(blk.attn, name).weight.copy_(leaf(tree["attn"][name]).T)
    if cfg.qk_norm:
        blk.attn.q_norm.copy_(leaf(tree["attn"]["q_norm"]))
        blk.attn.k_norm.copy_(leaf(tree["attn"]["k_norm"]))
    for name in ("w_gate", "w_up", "w_down"):
        getattr(blk.mlp, name).weight.copy_(leaf(tree["mlp"][name]).T)

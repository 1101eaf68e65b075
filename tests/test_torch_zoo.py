"""The port's dense LM serving path against the JAX package's, on the CPU.

The reduced qwen3-8b (2 layers, d_model 64, 4 query and 2 KV heads of
dim 16, qk-norm) takes its weights from JAX ``zoo.init_params(PRNGKey(0))``
through ``convert.lm_params_from_jax``; tokens come from a numpy seed.
Checked at f32, rtol 1e-4 / atol 1e-4 (the same model, sums in another
order): ``forward`` logits, ``prefill``'s last-position logits and cache
(B = 2, S = 31, max_seq = 32), and ``decode_step``'s logits and updated
cache. One bf16 case at rtol 2e-2 with an atol of 2e-2 per unit of the
logits' scale (the two frameworks round to bf16 at different places).
Then the port's own consistency, decode(prefill(x[:-1]), x[-1]) ==
forward(x)[:, -1] at 2e-3 as tests/test_zoo_smoke.py checks the JAX
package, and the entry points' contracts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import zoo as jzoo
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config
from repro_torch.models import transformer, zoo
from repro_torch.runtime import CapabilityError

B, S = 2, 32


def _cfgs(dtype):
    jcfg = jreduced_config(jget_config("qwen3-8b"))
    cfg = reduced_config(get_config("qwen3-8b"))
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(cfg, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jax_run(dtype):
    """JAX forward, prefill of S - 1 tokens and one decode step, and the
    numpy parameters."""
    jcfg, _ = _cfgs(dtype)
    params = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    logits, _ = jax.jit(lambda p, b: jzoo.forward(p, jcfg, b))(
        params, {"tokens": jnp.asarray(tokens)})
    last, cache = jax.jit(
        lambda p, b: jzoo.prefill(p, jcfg, b, max_seq=S))(
        params, {"tokens": jnp.asarray(tokens[:, :-1])})
    step, cache2 = jax.jit(lambda p, b, c: jzoo.decode_step(p, jcfg, b, c))(
        params, {"token": jnp.asarray(tokens[:, -1:]),
                 "pos": jnp.int32(S - 1)}, cache)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    return (jax.tree.map(np.asarray, params), tokens,
            {"forward": f32(logits), "prefill": f32(last),
             "k": f32(cache["k"]), "v": f32(cache["v"]),
             "decode": f32(step), "k2": f32(cache2["k"]),
             "v2": f32(cache2["v"])})


def _port_run(dtype):
    _, cfg = _cfgs(dtype)
    params, tokens, _ = _jax_run(dtype)
    model = convert.lm_params_from_jax(params, cfg, "cpu")
    logits, aux = zoo.forward(model, cfg, {"tokens": tokens})
    assert float(aux) == 0.0
    last, cache = zoo.prefill(model, cfg, {"tokens": tokens[:, :-1]},
                              max_seq=S)
    pre_k, pre_v = cache["k"].clone(), cache["v"].clone()
    step, cache2 = zoo.decode_step(
        model, cfg, {"token": tokens[:, -1:], "pos": S - 1}, cache)
    assert cache2["k"] is cache["k"]                   # written in place
    return {"forward": logits, "prefill": last, "k": pre_k, "v": pre_v,
            "decode": step, "k2": cache2["k"], "v2": cache2["v"]}


def test_slice_matches_jax_f32():
    got = _port_run("float32")
    want = _jax_run("float32")[2]
    assert tuple(got["forward"].shape) == (B, S, 512)
    assert tuple(got["prefill"].shape) == (B, 1, 512)
    assert tuple(got["k"].shape) == (2, B, S, 2, 16)
    for name in want:
        np.testing.assert_allclose(got[name].float().numpy(), want[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the prefill leaves the position past the prompt zero, as JAX pads
    assert not got["k"][:, :, S - 1:].any()


def test_slice_matches_jax_bf16():
    got = _port_run("bfloat16")
    want = _jax_run("bfloat16")[2]
    assert got["forward"].dtype == torch.bfloat16
    assert got["k"].dtype == torch.bfloat16
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name].float().numpy(), want[name],
                                   rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-8b", "minitron-4b"])
def test_decode_after_prefill_matches_forward(arch):
    cfg = reduced_config(get_config(arch))
    model = zoo.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)))
    full, _ = zoo.forward(model, cfg, {"tokens": tokens})
    _, cache = zoo.prefill(model, cfg, {"tokens": tokens[:, :-1]}, max_seq=S)
    step, _ = zoo.decode_step(model, cfg, {"token": tokens[:, -1:],
                                           "pos": S - 1}, cache)
    np.testing.assert_allclose(step[:, 0, :cfg.vocab_size].numpy(),
                               full[:, -1].numpy(), rtol=2e-3, atol=2e-3)


def test_qwen3_8b_full_size_holds_its_published_parameter_count():
    """The full configuration built on the meta device: 8.19e9 parameters,
    16.4 GB in bf16, and its KV cache at 4 x 2,080 positions 1.23 GB."""
    cfg = get_config("qwen3-8b")
    model = transformer.lm_init(None, cfg, torch.bfloat16, "meta")
    n = sum(p.numel() for p in model.parameters())
    qk_norms = 2 * cfg.n_layers * cfg.resolved_head_dim
    pad = 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    assert n == cfg.param_count() + qk_norms + pad
    assert round(n / 1e9, 2) == 8.19
    assert round(2 * n / 1e9, 1) == 16.4
    cache = transformer.lm_cache_init(cfg, 4, 2_080, torch.bfloat16, "meta")
    assert round(2 * cache["k"].numel() * 2 / 1e9, 2) == 1.23


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_cache(cfg, 2, 8)
    cache = zoo.init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].shape == (2, 2, 8, 2, 16)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if get_config(a).family not in zoo.PORTED])
def test_other_families_raise_capability_error(arch):
    cfg = reduced_config(get_config(arch))
    with pytest.raises(CapabilityError, match="ROADMAP"):
        zoo.init_params(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(CapabilityError):
        zoo.init_cache(cfg, 1, 4, device="cpu")
    dense = reduced_config(get_config("qwen3-8b"))
    model = zoo.init_params(dense, generator=torch.Generator(), device="cpu")
    with pytest.raises(CapabilityError):
        zoo.prefill(model, cfg, {"tokens": np.zeros((1, 4), np.int32)})

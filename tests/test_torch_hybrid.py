"""The port's hybrid (Zamba2) serving path against the JAX package's, on
the CPU.

The reduced zamba2-2.7b at 4 layers (2 groups of 2 Mamba2 layers, each
followed by the shared attention block; d_model 64, 2 heads of 32, d_inner
128, 8 SSD heads of 16, state 16) and a d_model 160 variant whose 2 heads
are of dim 80, zamba2-2.7b's own, so the plain flash runs at Dh 80. The
port takes its weights from JAX ``zoo.init_params(PRNGKey(0))`` through
``convert.lm_params_from_jax``; tokens come from a numpy seed. As the
dense slice: ``forward`` over 32 tokens, ``prefill`` of 31 into a cache
of 32 positions (logits and every cache entry: ``ssm_h``, ``ssm_conv``,
``k``, ``v``) and one ``decode_step`` at position 31 (logits and the
updated cache), at f32 rtol 1e-4 / atol 1e-4 and at bf16 rtol 2e-2 with
an atol of 2e-2 per unit of the reference's scale. Across SSD chunks the
f32 forward over 256 tokens is held at rtol 1e-4 with an atol of 1e-4
per unit of scale: each decay is exp(E_t - E_s) of two cumulative sums
that reach |E| ~ 2,000 within a chunk of 128, where the two frameworks'
sums differ by up to 2.4e-4 (an ulp of 2,048 is 1.2e-4), and rounding
the matmuls otherwise alone (f64 products rounded once) moves the port's
256-token logits by 5.4e-4 at a scale of 59. (In bf16 a one-ulp
difference of a dt moves every later decay of its chunk by ~4 %, in
either framework, so bf16 is compared within one chunk only.) Then the
port's own
consistency across a chunk boundary, the full-size parameter count and
cache, and the entry points' contracts.
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
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.models import transformer, zoo

B, S = 2, 32
LONG = 256                      # two SSD chunks of 128
CACHE = ("ssm_h", "ssm_conv", "k", "v")


def _cfgs(dtype, d_model):
    jcfg = jreduced_config(jget_config("zamba2-2.7b"), n_layers=4,
                           d_model=d_model)
    cfg = reduced_config(get_config("zamba2-2.7b"), n_layers=4,
                         d_model=d_model)
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(cfg, dtype=dtype))


def _tokens(cfg, seed=0, n=LONG):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(dtype, d_model):
    """JAX forward over S tokens, prefill of S - 1 and one decode step (and
    in f32 the forward over LONG tokens), and the numpy parameters."""
    jcfg, _ = _cfgs(dtype, d_model)
    params = jzoo.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = _tokens(jcfg)
    fwd = jax.jit(lambda p, b: jzoo.forward(p, jcfg, b)[0])
    logits = fwd(params, {"tokens": jnp.asarray(tokens[:, :S])})
    last, cache = jax.jit(lambda p, b: jzoo.prefill(p, jcfg, b, max_seq=S))(
        params, {"tokens": jnp.asarray(tokens[:, :S - 1])})
    step, cache2 = jax.jit(lambda p, b, c: jzoo.decode_step(p, jcfg, b, c))(
        params, {"token": jnp.asarray(tokens[:, S - 1:S]),
                 "pos": jnp.int32(S - 1)}, cache)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    want = {"forward": f32(logits), "prefill": f32(last),
            "decode": f32(step)}
    if dtype == "float32":
        want["long"] = f32(fwd(params, {"tokens": jnp.asarray(tokens)}))
    for name in CACHE:
        want[name] = f32(cache[name])
        want[name + "2"] = f32(cache2[name])
    return jax.tree.map(np.asarray, params), tokens, want


def _port_run(dtype, d_model):
    _, cfg = _cfgs(dtype, d_model)
    params, tokens, _ = _jax_run(dtype, d_model)
    model = convert.lm_params_from_jax(params, cfg, "cpu")
    assert isinstance(model, transformer.HybridLM)
    logits, aux = zoo.forward(model, cfg, {"tokens": tokens[:, :S]})
    assert float(aux) == 0.0
    last, cache = zoo.prefill(model, cfg, {"tokens": tokens[:, :S - 1]},
                              max_seq=S)
    got = {"forward": logits, "prefill": last}
    for name in CACHE:
        got[name] = cache[name].clone()
    step, cache2 = zoo.decode_step(
        model, cfg, {"token": tokens[:, S - 1:S], "pos": S - 1}, cache)
    assert cache2["k"] is cache["k"]                   # written in place
    got["decode"] = step
    for name in CACHE:
        got[name + "2"] = cache2[name]
    if dtype == "float32":
        got["long"] = zoo.forward(model, cfg, {"tokens": tokens})[0]
    return cfg, model, got


@pytest.mark.parametrize("d_model", [64, 160])
def test_hybrid_matches_jax_f32(d_model):
    cfg, _, got = _port_run("float32", d_model)
    want = _jax_run("float32", d_model)[2]
    G, A = cfg.n_layers // cfg.attn_every, cfg.attn_every
    Dh = d_model // 2
    assert cfg.resolved_head_dim == Dh
    assert tuple(got["forward"].shape) == (B, S, cfg.vocab_size)
    assert tuple(got["prefill"].shape) == (B, 1, cfg.padded_vocab)
    assert tuple(got["k"].shape) == (G, B, S, 2, Dh)
    assert tuple(got["ssm_h"].shape) == (G, A, B, cfg.n_ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state)
    assert got["ssm_h"].dtype == torch.float32
    long_got, long_want = got.pop("long"), want.pop("long")
    for name in want:
        np.testing.assert_allclose(got[name].float().numpy(), want[name],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(long_got.numpy(), long_want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(long_want).max()))
    # the prefill leaves the position past the prompt zero, as JAX pads
    assert not got["k"][:, :, S - 1:].any()


@pytest.mark.parametrize("d_model", [64, 160])
def test_hybrid_matches_jax_bf16(d_model):
    _, _, got = _port_run("bfloat16", d_model)
    want = _jax_run("bfloat16", d_model)[2]
    assert got["forward"].dtype == torch.bfloat16
    assert got["k"].dtype == got["ssm_conv"].dtype == torch.bfloat16
    assert got["ssm_h"].dtype == torch.float32
    for name in want:
        scale = float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name].float().numpy(), want[name],
                                   rtol=2e-2, atol=2e-2 * scale,
                                   err_msg=name)


def test_hybrid_prefill_flash_equals_full_at_head_dim_80():
    """At Dh 80 the prefill's attention through the flash wrapper (its
    plain version here; no launch on the CPU) and through impl='full'."""
    _, cfg = _cfgs("float32", 160)
    model = zoo.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = _tokens(cfg, seed=1, n=64)
    ops.reset_launch_counts()
    flash, c1 = zoo.prefill(model, cfg, {"tokens": tokens}, impl="flash")
    assert ops.launch_counts()["flash_attention"] == 0
    full, c2 = zoo.prefill(model, cfg, {"tokens": tokens}, impl="full")
    np.testing.assert_allclose(flash.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    for name in CACHE:
        np.testing.assert_allclose(c1[name].numpy(), c2[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_decode_after_prefill_matches_forward_across_chunks():
    """Prefill of 256 tokens (two SSD chunks), then 8 decode steps, against
    the forward pass over 384 tokens at those positions (2e-3, as the JAX
    package's own smoke test holds decode to forward)."""
    _, cfg = _cfgs("float32", 160)
    model = zoo.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    x = torch.as_tensor(_tokens(cfg, seed=2, n=384))
    full, _ = zoo.forward(model, cfg, {"tokens": x})
    last, cache = zoo.prefill(model, cfg, {"tokens": x[:, :LONG]},
                              max_seq=LONG + 8)
    np.testing.assert_allclose(last[:, 0, :cfg.vocab_size].numpy(),
                               full[:, LONG - 1].numpy(), rtol=2e-3,
                               atol=2e-3)
    for i in range(LONG, LONG + 8):
        step, cache = zoo.decode_step(model, cfg, {"token": x[:, i:i + 1],
                                                   "pos": i}, cache)
        np.testing.assert_allclose(step[:, 0, :cfg.vocab_size].numpy(),
                                   full[:, i].numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=f"position {i}")


def test_hybrid_prefill_needs_whole_chunks_as_jax_does():
    _, cfg = _cfgs("float32", 64)
    model = zoo.init_params(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        zoo.prefill(model, cfg, {"tokens": np.zeros((1, 200), np.int32)})
    with pytest.raises(ValueError, match="max_seq"):
        zoo.prefill(model, cfg, {"tokens": np.zeros((1, 8), np.int32)},
                    max_seq=4)
    with pytest.raises(ValueError, match="attn_every"):
        zoo.init_params(dataclasses.replace(cfg, n_layers=3),
                        generator=torch.Generator(), device="cpu")


def test_zamba2_full_size_parameter_count_and_cache():
    """The full configuration on the meta device: the JAX package's
    parameters leaf for leaf in number (``jax.eval_shape`` of its
    ``init_params``), 2.42e9, 4.845 GB in bf16 (4.84 GB by
    ``cfg.param_count()``). ``cfg.param_count()`` counts
    a Mamba2 layer's conv as d_inner x K and its norms as 2 D; the layer
    also holds the conv over B and C, the conv bias, A, dt_bias, D and the
    gate norm: L (2 ds K + conv_dim + 3 H + d_inner - D) more. The cache at
    4 x 2,080 positions: k and v 0.77 GB, the SSD states 0.28 GB."""
    cfg = get_config("zamba2-2.7b")
    model = transformer.hybrid_init(None, cfg, torch.bfloat16, "meta")
    n = sum(p.numel() for p in model.parameters())
    avals = jzoo.param_avals(jget_config("zamba2-2.7b"))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(avals))
    D, di, ds, H, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.n_ssm_heads, cfg.conv_kernel)
    extra = cfg.n_layers * (2 * ds * K + di + 2 * ds + 3 * H + di - D)
    assert n == cfg.param_count() + extra
    assert round(n / 1e9, 2) == 2.42
    assert round(2 * cfg.param_count() / 1e9, 2) == 4.84
    assert round(2 * n / 1e9, 3) == 4.845
    assert len(model.groups) == 9 and len(model.groups[0]) == 6
    cache = transformer.hybrid_cache_init(cfg, 4, 2_080, torch.bfloat16,
                                          "meta")
    nbytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
    assert round((nbytes["k"] + nbytes["v"]) / 1e9, 2) == 0.77
    assert round(nbytes["ssm_h"] / 1e9, 2) == 0.28


def test_hybrid_entry_points_and_cache_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("float32", 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_params(cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_cache(cfg, 2, 8)
    cache = zoo.init_cache(cfg, 3, 8, device="cpu")
    assert set(cache) == set(CACHE)
    assert tuple(cache["k"].shape) == (2, 3, 8, 2, 32)
    assert tuple(cache["ssm_conv"].shape) == (2, 2, 3, cfg.conv_kernel - 1,
                                              cfg.d_inner + 2 * cfg.ssm_state)
    assert not any(v.any() for v in cache.values())

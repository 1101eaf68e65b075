"""The port's attention against the JAX package's, on the CPU, from the same
numpy inputs.

* The flash function: the port's CPU row (its plain version) against the
  Pallas kernel in interpret mode (``repro.kernels.ops.flash_attention``)
  and against ``repro.kernels.ref.flash_attention_flat_ref``: f32 at rtol
  2e-5 / atol 1e-4 and bf16 at 2e-2 / 1e-1, the JAX package's own bounds
  (tests/test_kernels.py).
* Layers: ``rms_norm``, RoPE up to position 4,096 and the SwiGLU MLP at f32,
  rtol 1e-6 with an atol of 1e-6 per unit of the output's scale (the two
  frameworks' sin, cos and matrix products differ in the last bit).
* Attention on the reduced qwen3-8b (qk-norm) and minitron-4b (no qk-norm)
  configurations, weights from the JAX package's ``init_params``: the
  port's ``attention(impl="flash")`` against JAX ``impl="pallas"``,
  ``attention_with_cache`` and ``decode_attention`` against theirs, at f32
  rtol 1e-5 (atol 1e-6 per unit of scale).

The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py, on a machine with a card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import zoo as jzoo
from repro_torch import convert, runtime
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _scaled(got, want, rtol):
    """rtol, with an atol of rtol per unit of the reference's scale."""
    want = np.asarray(want, np.float32)
    _close(got, want, rtol, rtol * float(np.abs(want).max()))


def _to_torch(a, dtype):
    return torch.as_tensor(a).to(dtype)


# ---------------------------------------------------- flash attention --
FLASH_CASES = [
    # the shapes of tests/test_kernels.py (S = 100 is ragged; group 8;
    # Dh 128 with group 3), then group 3 (minitron's 24:8) at a ragged S
    (2, 128, 128, 4, 2, 64, True), (1, 256, 256, 8, 1, 32, True),
    (2, 100, 100, 4, 4, 64, True), (1, 384, 384, 6, 2, 128, True),
    (2, 77, 77, 6, 2, 16, True),
    # non-causal, and queries fewer than keys (causal and not)
    (1, 128, 128, 2, 2, 64, False), (2, 64, 128, 4, 2, 32, False),
    (1, 40, 96, 3, 1, 16, True),
    # zamba2-2.7b's head dim 80 (its 32:32 heads cut to 2), S ragged
    (1, 100, 100, 2, 2, 80, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,Dh,causal", FLASH_CASES)
def test_flash_plain_matches_pallas_and_ref(B, Sq, Sk, Hq, Hkv, Dh, causal,
                                            dtype):
    rng = np.random.default_rng(B * Sq + Sk + Hq + Dh)
    q = rng.standard_normal((B, Sq, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dh)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ops.flash_attention(_to_torch(q, tdt), _to_torch(k, tdt),
                              _to_torch(v, tdt), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (B, Sq, Hq, Dh)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_k=64, interpret=True)
    flat = (jq.transpose(0, 2, 1, 3).reshape(B * Hq, Sq, Dh),
            jk.transpose(0, 2, 1, 3).reshape(B * Hkv, Sk, Dh),
            jv.transpose(0, 2, 1, 3).reshape(B * Hkv, Sk, Dh))
    oracle = jref.flash_attention_flat_ref(*flat, causal=causal)
    oracle = oracle.reshape(B, Hq, Sq, Dh).transpose(0, 2, 1, 3)
    rtol, atol = (2e-5, 1e-4) if dtype == "float32" else (2e-2, 1e-1)
    got = got.float().numpy()
    _close(got, pallas, rtol, atol)
    _close(got, oracle, rtol, atol)


def test_flash_flat_plain_version_matches_jax_ref():
    """The flat layout and an explicit sm_scale, as the kernel takes them."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((6, 50, 32)).astype(np.float32)
    k = rng.standard_normal((2, 50, 32)).astype(np.float32)
    v = rng.standard_normal((2, 50, 32)).astype(np.float32)
    for causal in (True, False):
        got = tflash.flash_attention_flat(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            causal=causal, sm_scale=0.3)
        want = jref.flash_attention_flat_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            sm_scale=0.3)
        _close(got, want, 2e-5, 1e-5)


def test_flash_refuses_non_causal_ragged_keys_as_jax_does():
    q = torch.zeros(2, 64, 16)
    k = torch.zeros(2, 200, 16)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention_auto(q, k, k, causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        tflash.flash_attention_flat(q, k, k, causal=False)
    with pytest.raises(ValueError):
        jops.flash_attention(jnp.zeros((1, 64, 2, 16)),
                             jnp.zeros((1, 200, 2, 16)),
                             jnp.zeros((1, 200, 2, 16)), causal=False,
                             interpret=True)
    # keys fewer than block_k form one block; causal calls never refuse
    assert ops.flash_attention_auto(q, k[:, :100], k[:, :100],
                                    causal=False).shape == q.shape
    assert ops.flash_attention_auto(q, k, k).shape == q.shape
    with pytest.raises(ValueError):
        ops.flash_attention_auto(q, torch.zeros(3, 64, 16),
                                 torch.zeros(3, 64, 16))   # 2 % 3 != 0


def test_flash_registry_rows():
    assert runtime.kernel("flash_attention", "cuda") is \
        tflash.flash_attention_flat
    assert runtime.kernel("flash_attention", "cpu") is ops._flash_plain
    assert "flash_attention" in ops.KERNELS
    ops.reset_launch_counts()
    ops.flash_attention(torch.ones(1, 8, 2, 16), torch.ones(1, 8, 1, 16),
                        torch.ones(1, 8, 1, 16))
    assert ops.launch_counts()["flash_attention"] == 0   # the CPU row


# --------------------------------------------------------------- layers --
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 7, 4, 64))).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    got = tlayers.rms_norm(torch.as_tensor(x), torch.as_tensor(w))
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))
    _scaled(got, want, 1e-6)


@pytest.mark.parametrize("head_dim,theta", [(16, 1e6), (128, 1e6),
                                            (128, 1e4), (80, 1e4)])
def test_rope_matches_jax_up_to_position_4096(head_dim, theta):
    pos = np.arange(4097, dtype=np.int32)[None, :]
    cos, sin = tlayers.rope_freqs(head_dim, theta, torch.as_tensor(pos))
    jcos, jsin = jlayers.rope_freqs(head_dim, theta, jnp.asarray(pos))
    assert cos.dtype == torch.float32
    _close(cos, jcos, 1e-6, 1e-6)
    _close(sin, jsin, 1e-6, 1e-6)
    x = np.random.default_rng(head_dim).standard_normal(
        (1, 4097, 2, head_dim)).astype(np.float32)
    got = tlayers.apply_rope(torch.as_tensor(x), cos, sin)
    want = jlayers.apply_rope(jnp.asarray(x), jcos, jsin)
    _scaled(got, want, 1e-6)
    # the angle is f32 even for a bf16 model: bf16 positions near 2,000
    # would be off by whole radians
    cos16, _ = tlayers.rope_freqs(head_dim, theta,
                                  torch.as_tensor(pos).to(torch.bfloat16))
    assert cos16.dtype == torch.float32


def test_mlp_matches_jax():
    rng = np.random.default_rng(1)
    d, f = 64, 192
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    ws = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for n, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                       ("w_down", (f, d)))}
    mlp = tlayers.mlp_init(None, d, f, torch.float32, "cpu")
    for name, w in ws.items():
        getattr(mlp, name).weight.copy_(torch.as_tensor(w.T))
    got = tlayers.mlp_apply(mlp, torch.as_tensor(x))
    want = jlayers.mlp_apply({n: jnp.asarray(w) for n, w in ws.items()},
                             jnp.asarray(x))
    _scaled(got, want, 1e-6)


# ------------------------------------------------------------ attention --
@functools.lru_cache(maxsize=None)
def _layer0(arch):
    """Block 0's attention of the reduced config: JAX params and the port's
    module holding the same weights."""
    jcfg = jreduced_config(jget_config(arch))
    cfg = reduced_config(get_config(arch))
    params = jax.tree.map(np.asarray,
                          jzoo.init_params(jax.random.PRNGKey(1), jcfg))
    model = convert.lm_params_from_jax(params, cfg, "cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"]["attn"])
    return jcfg, cfg, jp, model.blocks[0].attn


@pytest.mark.parametrize("arch", ["qwen3-8b", "minitron-4b"])
def test_attention_flash_matches_jax_pallas(arch):
    jcfg, cfg, jp, attn = _layer0(arch)
    assert cfg.qk_norm == (arch == "qwen3-8b")
    x = np.random.default_rng(2).standard_normal(
        (2, 70, cfg.d_model)).astype(np.float32)
    got = tattn.attention(attn, cfg, torch.as_tensor(x), impl="flash")
    want = jattn.attention(jp, jcfg, jnp.asarray(x), impl="pallas")
    _scaled(got, want, 1e-5)
    _scaled(tattn.attention(attn, cfg, torch.as_tensor(x), impl="full"),
            jattn.attention(jp, jcfg, jnp.asarray(x), impl="full"), 1e-5)
    with pytest.raises(ValueError):
        tattn.attention(attn, cfg, torch.as_tensor(x), impl="pallas")


@pytest.mark.parametrize("arch", ["qwen3-8b", "minitron-4b"])
def test_attention_with_cache_and_decode_match_jax(arch):
    jcfg, cfg, jp, attn = _layer0(arch)
    rng = np.random.default_rng(3)
    B, S, Smax = 2, 23, 32
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    out, (k, v) = tattn.attention_with_cache(attn, cfg, torch.as_tensor(x))
    jout, (jk, jv) = jattn.attention_with_cache(jp, jcfg, jnp.asarray(x))
    _scaled(out, jout, 1e-5)
    _scaled(k, jk, 1e-5)
    _scaled(v, jv, 1e-5)

    shape = (B, Smax, cfg.n_kv_heads, cfg.resolved_head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    pos = 13
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    out, tk2, tv2 = tattn.decode_attention(attn, cfg, torch.as_tensor(x1),
                                           tk, tv, pos)
    jout, jk2, jv2 = jattn.decode_attention(jp, jcfg, jnp.asarray(x1),
                                            jnp.asarray(ck), jnp.asarray(cv),
                                            jnp.int32(pos))
    _scaled(out, jout, 1e-5)
    _scaled(tk2, jk2, 1e-5)
    _scaled(tv2, jv2, 1e-5)
    assert tk2 is tk                               # written in place
    np.testing.assert_array_equal(tk[:, pos + 1:].numpy(), ck[:, pos + 1:])

"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU, from the same numpy inputs.

The JAX functions run under ``jax.jit``. f32 at rtol 1e-5 with an atol of
1e-5 per unit of the reference's scale for the conv and the scans (the
same sums in another order; the decays are exponentials of cumulative
sums, which the two frameworks add in another order), and at the LM
slice's 1e-4 for the whole mixer, whose state also carries the in_proj
products' rounding through those exponentials; bf16 at 2e-2 per unit of
scale, as the LM slice (the two frameworks round bf16 at different
places), 5e-2 for the f32 state that a bf16 mixer leaves. The mixers take the
weights of the JAX ``mamba_init`` through ``convert.mamba_params_from_jax``.
Then the port's own consistency: the one-token recurrence ``ssd_step``
against the chunked scan, and ``mamba_step`` after ``mamba_block`` against
``mamba_block`` over the longer sequence.
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
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import ssm

B, H, P, DS = 2, 4, 8, 16


def _scaled(got, want, rtol):
    """rtol, with an atol of rtol per unit of the reference's scale."""
    got, want = (a.float().numpy() if torch.is_tensor(a)
                 else np.asarray(a, np.float32) for a in (got, want))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _ssd_inputs(S, seed=0):
    """x, dt (softplus of normals), A = -(1 .. 16), B, C, h0 as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    Bm = rng.standard_normal((B, S, DS)).astype(np.float32)
    Cm = rng.standard_normal((B, S, DS)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, DS)).astype(np.float32)
    return x, dt, A, Bm, Cm, h0


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# ------------------------------------------------------------------ conv --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_conv_step_match_jax(dtype):
    rng = np.random.default_rng(1)
    K, C, S = 4, 24, 19
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = (rng.standard_normal((K, C)) / K).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    state = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tw, tb, ts = (a.to(tdt) for a in _t(x, w, bias, state))
    jx, jw, jb, js = (jnp.asarray(a).astype(jdt) for a in (x, w, bias, state))
    rtol = 1e-6 if dtype == "float32" else 2e-2
    got = ssm._causal_conv(tx, tw, tb)
    assert got.dtype == tdt
    _scaled(got, jax.jit(jssm._causal_conv)(jx, jw, jb), rtol)
    y, new = ssm._conv_step(tx[:, 0], ts, tw, tb)
    jy, jnew = jax.jit(jssm._conv_step)(jx[:, 0], js, jw, jb)
    _scaled(y, jy, rtol)
    _scaled(new, jnew, 0.0)                       # a shift: exact
    # stepping the conv through the sequence from a zero state gives the
    # causal conv
    st = torch.zeros_like(ts)
    for i in range(S):
        y, st = ssm._conv_step(tx[:, i], st, tw, tb)
        _scaled(y, got[:, i], rtol)


# ------------------------------------------------------------------- SSD --
@pytest.mark.parametrize("S,chunk,with_h0", [(256, 64, True),
                                             (256, 64, False),
                                             (40, 128, True)])
def test_ssd_chunked_matches_jax(S, chunk, with_h0):
    """Several chunks (and one shorter than the chunk), with and without an
    initial state: y and the final state."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S)
    h0 = h0 if with_h0 else None
    got_y, got_h = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk,
                                   h0=None if h0 is None else _t(h0)[0])
    fn = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))
    want_y, want_h = fn(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                        h0=None if h0 is None else jnp.asarray(h0))
    assert got_y.dtype == torch.float32 and got_h.dtype == torch.float32
    _scaled(got_y, want_y, 1e-5)
    _scaled(got_h, want_h, 1e-5)


def test_ssd_chunked_bf16_keeps_the_casts():
    """bf16 x, dt, B, C: the scan in f32, y back in bf16, h in f32."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(128, seed=2)
    bf = torch.bfloat16
    got_y, got_h = ssm.ssd_chunked(*(a.to(bf) for a in _t(x, dt)),
                                   _t(A)[0], *(a.to(bf) for a in _t(Bm, Cm)),
                                   64, h0=_t(h0)[0])
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dt, Bm, Cm)]
    want_y, want_h = jax.jit(functools.partial(jssm.ssd_chunked, chunk=64))(
        jb[0], jb[1], jnp.asarray(A), jb[2], jb[3], h0=jnp.asarray(h0))
    assert got_y.dtype == bf and got_h.dtype == torch.float32
    _scaled(got_y, want_y, 2e-2)
    _scaled(got_h, want_h, 1e-5)


def test_ssd_chunked_refuses_a_ragged_last_chunk():
    x, dt, A, Bm, Cm, _ = _ssd_inputs(200)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), 128)


def test_ssd_step_matches_jax_and_the_chunked_scan():
    """ssd_step against JAX's, then stepped through a sequence of three
    chunks from h0 against ssd_chunked: every y and the final state."""
    S = 96
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(S, seed=3)
    tx, tdt, tA, tB, tC, th0 = _t(x, dt, A, Bm, Cm, h0)
    y, h = ssm.ssd_step(th0, tx[:, 0], tdt[:, 0], tA, tB[:, 0], tC[:, 0])
    jy, jh = jax.jit(jssm.ssd_step)(*(jnp.asarray(a) for a in (
        h0, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])))
    _scaled(y, jy, 1e-6)
    _scaled(h, jh, 1e-6)
    want_y, want_h = ssm.ssd_chunked(tx, tdt, tA, tB, tC, 32, h0=th0)
    h, ys = th0, []
    for i in range(S):
        y, h = ssm.ssd_step(h, tx[:, i], tdt[:, i], tA, tB[:, i], tC[:, i])
        ys.append(y)
    _scaled(torch.stack(ys, 1), want_y.numpy(), 1e-5)
    _scaled(h, want_h.numpy(), 1e-5)


# ----------------------------------------------------------------- mixer --
@functools.lru_cache(maxsize=None)
def _mixer(dtype):
    """The reduced zamba2 config (d_model 64, d_inner 128, 8 SSD heads of
    16, state 16) in ``dtype``, JAX mamba_init params (numpy) and the
    port's Mamba2 holding them."""
    jcfg = dataclasses.replace(jreduced_config(jget_config("zamba2-2.7b")),
                               dtype=dtype)
    cfg = dataclasses.replace(reduced_config(get_config("zamba2-2.7b")),
                              dtype=dtype)
    params = jax.tree.map(np.asarray, jssm.mamba_init(
        jax.random.PRNGKey(4), jcfg, jnp.dtype(dtype)))
    # nonzero biases, norms and dt_bias, so each is exercised
    rng = np.random.default_rng(4)
    for name in ("conv_bias_w", "gate_norm", "dt_bias"):
        params[name] = (0.1 * rng.standard_normal(params[name].shape)
                        ).astype(params[name].dtype)
    return jcfg, cfg, params, convert.mamba_params_from_jax(params, cfg,
                                                            "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_and_step_match_jax(dtype):
    """mamba_block(return_state=True) over 2 chunks, then one mamba_step
    from that state: outputs and states against JAX's."""
    jcfg, cfg, params, mixer = _mixer(dtype)
    S = 256
    x = np.random.default_rng(5).standard_normal(
        (B, S + 1, cfg.d_model)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx = torch.as_tensor(x).to(tdt)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jp = jax.tree.map(jnp.asarray, params)
    out, (h, conv) = ssm.mamba_block(mixer, cfg, tx[:, :S],
                                     return_state=True)
    jout, (jh, jconv) = jax.jit(functools.partial(
        jssm.mamba_block, cfg=jcfg, return_state=True))(jp, x=jx[:, :S])
    assert out.dtype == tdt and h.dtype == torch.float32
    assert tuple(conv.shape) == (B, cfg.conv_kernel - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)
    rtol = 1e-4 if dtype == "float32" else 2e-2
    _scaled(out, jout, rtol)
    _scaled(h, jh, rtol if dtype == "float32" else 5e-2)
    _scaled(conv, jconv, rtol)
    step, (h2, conv2) = ssm.mamba_step(mixer, cfg, tx[:, S:], (h, conv))
    jstep, (jh2, jconv2) = jax.jit(functools.partial(
        jssm.mamba_step, cfg=jcfg))(jp, x_t=jx[:, S:], state=(jh, jconv))
    _scaled(step, jstep, rtol)
    _scaled(h2, jh2, rtol if dtype == "float32" else 5e-2)
    _scaled(conv2, jconv2, rtol)


def test_mamba_step_after_block_matches_block_over_the_sequence():
    """f32: mamba_block over 128 positions, then 8 mamba_steps, against
    mamba_block over the 136 positions (one chunk of 136 here)."""
    _, cfg, _, mixer = _mixer("float32")
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (B, 136, cfg.d_model)).astype(np.float32))
    full = ssm.mamba_block(mixer, cfg, x, chunk=256)
    out, state = ssm.mamba_block(mixer, cfg, x[:, :128], return_state=True)
    _scaled(out, full[:, :128].numpy(), 1e-5)
    for i in range(128, 136):
        y, state = ssm.mamba_step(mixer, cfg, x[:, i:i + 1], state)
        _scaled(y, full[:, i:i + 1].numpy(), 1e-5)


def test_mamba_state_init_and_short_prompts():
    _, cfg, _, mixer = _mixer("float32")
    h, conv = ssm.mamba_state_init(cfg, 3, torch.bfloat16, "cpu")
    assert tuple(h.shape) == (3, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state) and h.dtype == torch.float32
    assert tuple(conv.shape) == (3, cfg.conv_kernel - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state)
    assert conv.dtype == torch.bfloat16 and not h.any() and not conv.any()
    with pytest.raises(ValueError, match="conv state"):
        ssm.mamba_block(mixer, cfg, torch.zeros(1, 2, cfg.d_model),
                        return_state=True)

"""The Mamba2 block (counterpart of ``repro.models.ssm``): SSD, state-space
duality, chunked.

The prefill and the forward pass run the chunked SSD algorithm: a
decay-masked (Q, Q) product inside each chunk, each chunk's summary state,
and a scan over the chunks carrying the (B, H, P, ds) state (a Python loop:
``nc`` steps of one multiply-add). A decode step is the exact one-token
recurrence. Every cast sits where the JAX package has it: dt, B and C are
f32 inside the scan and x is f32 in its products; y is cast back to x's
dtype, the skip term is added in that dtype and the gate norm is applied to
y * silu(z). All of it is plain PyTorch (the JAX package computes it in
einsums outside any kernel); the sharding constraints are the identity
without a mesh and are left out.

The intra-chunk product is formed head-major, (B, nc, H, Q, Q), so that it
is a batched matrix product with x without a transposed copy: the same
entries as the JAX package's (B, nc, Q, Q, H). At zamba2-2.7b's prefill
(B 4, S 2,048, Q 128, H 80) each such f32 tensor is 336 MB a layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .layers import _normal, dense_init, norm_init, rms_norm

f32 = torch.float32


class Mamba2(nn.Module):
    """in_proj (D -> z, x, B, C, dt), the depthwise causal conv over x, B
    and C (one group), A = -exp(a_log), dt_bias, the skip D, the gate norm
    and out_proj (d_inner -> D)."""

    def __init__(self, cfg: ModelConfig, *, generator, dtype, device):
        super().__init__()
        D, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
        H, K = cfg.n_ssm_heads, cfg.conv_kernel
        conv_dim = di + 2 * ds
        self.in_proj = dense_init(generator, D, 2 * di + 2 * ds + H, dtype,
                                  device)
        conv_w = (torch.empty((K, conv_dim), dtype=dtype, device=device)
                  if generator is None else
                  _normal((K, conv_dim), generator, device, dtype, 1.0 / K))
        self.conv_w = nn.Parameter(conv_w, requires_grad=False)
        self.conv_bias_w = norm_init(conv_dim, dtype, device)
        self.a_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=f32, device=device)), requires_grad=False)
        self.dt_bias = norm_init(H, f32, device)
        self.d_skip = nn.Parameter(torch.ones(H, dtype=f32, device=device),
                                   requires_grad=False)
        self.gate_norm = norm_init(di, dtype, device)
        self.out_proj = dense_init(generator, di, D, dtype, device)


def mamba_init(generator, cfg: ModelConfig, dtype, device) -> Mamba2:
    return Mamba2(cfg, generator=generator, dtype=dtype, device=device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as K shifted adds, in the JAX package's order.
    x (B, S, C), w (K, C)."""
    K = w.shape[0]
    out = x * w[-1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[K - 1 - i]
    return out + bias


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               bias: torch.Tensor):
    """x_t (B, C); conv_state (B, K-1, C) the past inputs. Returns y and the
    new state."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)           # (B, K, C)
    y = torch.einsum("bkc,kc->bc", full, w) + bias
    return y, full[:, 1:]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None):
    """Chunked SSD scan. x (B, S, H, P), dt (B, S, H), A (H,) negative,
    B_ / C_ (B, S, ds), h0 (B, H, P, ds) the initial state. Returns y
    (B, S, H, P) in x's dtype and the final state (f32). S must be a
    multiple of min(chunk, S)."""
    Bsz, S, H, P = x.shape
    ds = B_.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence length {S} is not a "
                         f"multiple of the chunk {Q}")
    nc = S // Q
    xc = x.reshape(Bsz, nc, Q, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32)
    Bc = B_.reshape(Bsz, nc, Q, ds).to(f32)
    Cc = C_.reshape(Bsz, nc, Q, ds).to(f32)

    dA = dtc * A[None, None, None, :]                    # (B, nc, Q, H) <= 0
    E = torch.cumsum(dA, dim=2)                          # inclusive
    dtot = E[:, :, -1, :]                                # (B, nc, H)

    # intra-chunk: attn[t, s] = exp(E_t - E_s) (C_t . B_s) dt_s for s <= t,
    # masked before the exp so no positive difference is exponentiated
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)         # (B, nc, Q, Q)
    Eh = E.transpose(2, 3)                               # (B, nc, H, Q)
    upper = torch.ones(Q, Q, dtype=torch.bool, device=x.device).triu_(1)
    attn = (Eh[..., :, None] - Eh[..., None, :]).masked_fill_(
        upper, -torch.inf).exp_()                        # (B, nc, H, Q, Q)
    attn.mul_(CB[:, :, None]).mul_(dtc.transpose(2, 3)[..., None, :])
    y = torch.matmul(attn, xc.transpose(2, 3))           # (B, nc, H, Q, P)
    del attn

    # chunk summary states: S_c = sum_s exp(E_Q - E_s) dt_s x_s (x) B_s
    w_end = torch.exp(dtot[:, :, None, :] - E) * dtc     # (B, nc, Q, H)
    S_c = torch.einsum("bckhp,bckn->bchpn", w_end[..., None] * xc, Bc)

    # inter-chunk scan over nc, emitting each chunk's starting state
    h = (torch.zeros((Bsz, H, P, ds), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_starts = []
    for c in range(nc):
        h_starts.append(h)
        h = torch.exp(dtot[:, c])[..., None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_starts, dim=1)                # (B, nc, H, P, ds)

    # inter-chunk outputs: y_t += C_t . (exp(E_t) h_chunk_start)
    y_inter = torch.einsum("bcqn,bchpn->bchqp", Cc, h_prev)
    y += y_inter.mul_(torch.exp(Eh)[..., None])
    y = y.transpose(2, 3).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


def ssd_step(h: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor):
    """The exact one-token recurrence. h (B, H, P, ds) f32; x_t (B, H, P);
    dt_t (B, H); B_t / C_t (B, ds). Returns y (B, H, P) and the new h."""
    dt_t = dt_t.to(f32)
    decay = torch.exp(dt_t * A[None, :])[..., None, None]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt_t, x_t.to(f32), B_t.to(f32))
    h_new = decay * h + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, C_t.to(f32))
    return y.to(x_t.dtype), h_new


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """z (d_inner), the conv's input x, B, C (d_inner + 2 ds) and dt (H)."""
    di, ds = cfg.d_inner, cfg.ssm_state
    return torch.split(zxbcdt, [di, di + 2 * ds, cfg.n_ssm_heads], dim=-1)


def mamba_block(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, *,
                chunk: int = 128, h0: torch.Tensor | None = None,
                return_state: bool = False):
    """The full Mamba2 mixer, x (B, S, D) -> (B, S, D); with
    ``return_state`` also (h, conv_state): the final SSD state and the
    *pre-activation* conv inputs of the last K-1 positions. (The JAX
    function's ``conv0`` argument, which it does not read, is left out.)"""
    Bsz, S, D = x.shape
    di, ds, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    K = cfg.conv_kernel
    if return_state and S < K - 1:
        raise ValueError(f"mamba_block: a conv state needs {K - 1} "
                         f"positions, the sequence has {S}")
    z, xBC, dt = _split_in_proj(cfg, p.in_proj(x))
    act = F.silu(_causal_conv(xBC, p.conv_w, p.conv_bias_w))
    xs, B_, C_ = torch.split(act, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.to(f32) + p.dt_bias[None, None, :])
    A = -torch.exp(p.a_log)
    xs = xs.reshape(Bsz, S, H, P)
    y, h_fin = ssd_chunked(xs, dt, A, B_, C_, chunk, h0=h0)
    y = y + xs * p.d_skip[None, None, :, None].to(y.dtype)
    y = rms_norm(y.reshape(Bsz, S, di) * F.silu(z), p.gate_norm)
    out = p.out_proj(y)
    if return_state:
        return out, (h_fin, xBC[:, S - (K - 1):, :])
    return out


def mamba_step(p: Mamba2, cfg: ModelConfig, x_t: torch.Tensor, state):
    """One-token decode. x_t (B, 1, D); state = (h (B, H, P, ds) f32,
    conv_state (B, K-1, conv_dim)). Returns out (B, 1, D) and the new
    state."""
    h, conv_state = state
    Bsz = x_t.shape[0]
    di, ds, H, P = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    z, xBC, dt = _split_in_proj(cfg, p.in_proj(x_t[:, 0])[:, None, :])
    xBC_t, conv_new = _conv_step(xBC[:, 0], conv_state, p.conv_w,
                                 p.conv_bias_w)
    xs, B_t, C_t = torch.split(F.silu(xBC_t), [di, ds, ds], dim=-1)
    dt_t = F.softplus(dt[:, 0].to(f32) + p.dt_bias[None, :])
    A = -torch.exp(p.a_log)
    xs = xs.reshape(Bsz, H, P)
    y, h_new = ssd_step(h, xs, dt_t, A, B_t, C_t)
    y = y + xs * p.d_skip[None, :, None].to(y.dtype)
    y = rms_norm(y.reshape(Bsz, 1, di) * F.silu(z), p.gate_norm)
    return p.out_proj(y), (h_new, conv_new)


def mamba_state_init(cfg: ModelConfig, batch: int, dtype, device) -> tuple:
    """Zeroed (h (B, H, P, ds) f32, conv_state (B, K-1, conv_dim))."""
    H, P, ds = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * ds
    return (torch.zeros((batch, H, P, ds), dtype=f32, device=device),
            torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype,
                        device=device))

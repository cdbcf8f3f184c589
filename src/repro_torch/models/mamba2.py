"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

The JAX package's `models/mamba2.py`. Chunked SSD: within a chunk of
`ssd_chunk` positions the outputs come from the dual (attention-like)
quadratic form; across chunks a Python loop carries the [B, H, P, N]
recurrent state. Decode is the O(1)-a-token recurrent update.

The JAX package writes the within-chunk and state contractions as einsums
of three and four operands. Here each is contracted in a fixed order, two
operands at a time, so that no [B, C, Q, Q, H, P] product is ever built
(at mamba2-2.7b's prefill of 4 x 4,200 tokens it would take about 91 GB
in fp32): the decay-weighted scores are scaled by dt first, then
multiplied with x as one batched matrix product per (b, c, h).

Shapes: B batch, S seq, D d_model, di = expand*D inner, H = di/head_dim
heads, P head_dim, N ssm_state, G(=1) state groups, W conv width, C
chunks, Q chunk length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    h = cfg.ssm_heads
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_ch = di + 2 * n           # channels that pass through the conv (x,B,C)
    return di, h, p, n, conv_ch


class SSM(nn.Module):
    """in_proj [D, 2di + 2N + H] (z, x, B, C, dt), conv_w [W, ch] (std
    0.1), conv_b, norm [di] and out_proj [di, D] in the model's dtype;
    a_log, d_skip and dt_bias [H] in fp32 whatever the model's dtype, as
    in the JAX package."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, generator=None):
        super().__init__()
        d = cfg.d_model
        di, h, p, n, conv_ch = _dims(cfg)
        in_dim = 2 * di + 2 * n + h
        self.in_proj = L.weight((d, in_dim), d ** -0.5, dtype, device,
                                generator)
        self.conv_w = L.weight((cfg.conv_width, conv_ch), 0.1, dtype, device,
                               generator)
        self.conv_b = L.zeros((conv_ch,), dtype, device)
        self.a_log = L.zeros((h,), torch.float32, device)
        self.d_skip = nn.Parameter(
            torch.ones((h,), dtype=torch.float32, device=device),
            requires_grad=False)
        self.dt_bias = L.zeros((h,), torch.float32, device)
        self.norm = L.zeros((di,), dtype, device)
        self.out_proj = L.weight((di, d), di ** -0.5, dtype, device,
                                 generator)


def init_ssm(cfg: ModelConfig, dtype, device=None, generator=None) -> SSM:
    """Random SSM weights with the JAX package's shapes and scales, drawn
    from `generator`; uninitialized when it is None (to be copied in)."""
    return SSM(cfg, dtype, device, generator)


def _split(cfg, zxbcdt):
    di, h, p, n, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    xc = zxbcdt[..., di:di + di + 2 * n]      # conv channels: x | B | C
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xc, dt


def _causal_conv(xc, w, b):
    """Depthwise causal conv of width W over xc [B, S, ch], in fp32, then
    SiLU, cast back to xc's dtype."""
    s = xc.shape[1]
    width = w.shape[0]
    out = torch.zeros(xc.shape, dtype=torch.float32, device=xc.device)
    for i in range(width):
        shift = width - 1 - i
        shifted = F.pad(xc, (0, 0, shift, 0))[:, :s]
        out = out + shifted.float() * w[i].float()
    return F.silu(out + b.float()).to(xc.dtype)


def _gated_norm(y, z, scale, eps):
    y = y * F.silu(z.float())
    var = (y * y).mean(-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * (1.0 + scale.float())


def ssm_forward(params: SSM, x: torch.Tensor, cfg: ModelConfig,
                return_final_state: bool = False):
    """Full-sequence SSD. x: [B, S, D] -> [B, S, D].

    If `return_final_state`, also returns (state [B,H,P,N] fp32, conv tail
    [B, W-1, conv_ch]) for handing off to decode.
    """
    b, s, d = x.shape
    di, h, p, n, conv_ch = _dims(cfg)
    zxbcdt = x @ params.in_proj
    z, xc_raw, dt_raw = _split(cfg, zxbcdt)
    xc = _causal_conv(xc_raw, params.conv_w, params.conv_b)
    y, state = ssd_scan(xc, dt_raw, params.a_log, params.dt_bias,
                        params.d_skip, n, cfg.ssd_chunk)
    y = _gated_norm(y.reshape(b, s, di), z, params.norm, cfg.norm_eps)
    out = y.to(x.dtype) @ params.out_proj
    if return_final_state:
        return out, (state, _conv_tail(xc_raw, cfg))
    return out


def ssd_scan(xc, dt_raw, a_log, dt_bias, d_skip, n: int, q: int):
    """The chunked SSD of H heads: xc [B, S, H*P + 2N] (x | B | C, after
    the conv), dt_raw [B, S, H] and the heads' a_log, dt_bias, d_skip [H],
    in chunks of q positions -> (y [B, S, H, P] fp32 with the D skip, the
    final state [B, H, P, N] fp32). Heads are independent: a block of them
    with its slices of x, dt and the [H] weights gives their y and state.
    """
    b, s, _ = xc.shape
    h = dt_raw.shape[-1]
    di = xc.shape[-1] - 2 * n
    p = di // h
    dev = xc.device
    spad = (-s) % q
    if spad:
        xc = F.pad(xc, (0, 0, 0, spad))
        dt_raw = F.pad(dt_raw, (0, 0, 0, spad))
    sp = s + spad
    nc = sp // q
    xs = xc[..., :di].reshape(b, nc, q, h, p).float()
    bmat = xc[..., di:di + n].reshape(b, nc, q, n).float()
    cmat = xc[..., di + n:].reshape(b, nc, q, n).float()
    dt = F.softplus(dt_raw.float() + dt_bias).reshape(b, nc, q, h)
    # Padded tail: dt=0 -> exp decay 1, no state contribution.
    if spad:
        tmask = (torch.arange(sp, device=dev) < s).reshape(1, nc, q, 1)
        dt = dt * tmask
    a = -torch.exp(a_log)                                 # [h]
    cum = torch.cumsum(dt * a, dim=2)                     # within-chunk cumsum

    # ---- intra-chunk (dual/quadratic form) ----
    # In place without autograd (serving: one [b,c,q,k,h] buffer); out of
    # place when a backward may need the factors.
    grad = torch.is_grad_enabled()
    scores = cmat @ bmat.transpose(-1, -2)                # [b,c,q,k]
    causal = torch.ones((q, q), dtype=torch.bool, device=dev).tril()
    m = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # decay [b,c,q,k,h]
    if grad:
        m = m.clamp(-60.0, 0.0).exp() * scores[..., None] * \
            causal[:, :, None] * dt[:, :, None, :, :]
    else:
        m.clamp_(-60.0, 0.0).exp_()
        m.mul_(scores[..., None]).mul_(causal[:, :, None])
        m.mul_(dt[:, :, None, :, :])                      # m * dt_k first
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m, xs)
    del m

    # ---- inter-chunk state recurrence ----
    chunk_decay = torch.exp((cum[:, :, -1:, :] - cum).clamp(-60.0, 0.0))
    # state contribution of chunk c: sum_j decay_to_end * dt_j * B_j x_j
    wx = xs * (chunk_decay * dt)[..., None]               # [b,c,q,h,p]
    contrib = torch.einsum("bcqhp,bcqn->bchpn", wx, bmat)
    del wx
    total_decay = torch.exp(cum[:, :, -1, :].clamp(-60.0, 0.0))   # [b,c,h]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    prev = []                                             # state BEFORE chunk
    for ci in range(nc):
        prev.append(state)
        state = state * total_decay[:, ci, :, None, None] + contrib[:, ci]
    prev_states = torch.stack(prev, dim=1)                # [b,c,h,p,n]

    in_decay = torch.exp(cum.clamp(-60.0, 0.0))           # decay from chunk start
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cmat, prev_states)
    if grad:
        y_inter = y_inter * in_decay[..., None]
    else:
        y_inter.mul_(in_decay[..., None])

    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    y = y + xs.reshape(b, sp, h, p)[:, :s] * d_skip[None, None, :, None]
    return y, state


def _conv_tail(xc_raw, cfg):
    """The last W-1 conv inputs, copied: a view would keep the whole
    [B, S, 2di + 2N + H] projection of every layer alive in the cache."""
    w = cfg.conv_width
    return (xc_raw[:, -(w - 1):, :] if w > 1 else xc_raw[:, :0, :]).clone()


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> dict:
    di, h, p, n, conv_ch = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(params: SSM, x: torch.Tensor, cache: dict,
                    cfg: ModelConfig):
    """One-token recurrent update. x: [B, 1, D] -> ([B, 1, D], new cache
    {state [B,H,P,N] fp32, conv [B, W-1, ch]}); `cache` is not written."""
    b = x.shape[0]
    di, h, p, n, conv_ch = _dims(cfg)
    zxbcdt = (x @ params.in_proj)[:, 0]
    z = zxbcdt[:, :di]
    xc_new = zxbcdt[:, di:di + di + 2 * n]
    dt_raw = zxbcdt[:, di + di + 2 * n:]
    # conv over the last W-1 inputs + the current one
    hist = torch.cat([cache["conv"], xc_new[:, None]], dim=1)    # [B,W,ch]
    conv = torch.einsum("bwc,wc->bc", hist.float(), params.conv_w.float()) \
        + params.conv_b.float()
    xc = F.silu(conv)
    xs = xc[:, :di].reshape(b, h, p)
    bmat = xc[:, di:di + n]
    cmat = xc[:, di + n:]
    dt = F.softplus(dt_raw.float() + params.dt_bias)             # [b,h]
    a = -torch.exp(params.a_log)
    y, state = ssm_recur(cache["state"], xs, dt, a, bmat, cmat)
    y = y + xs * params.d_skip[None, :, None]
    y = _gated_norm(y.reshape(b, di), z, params.norm, cfg.norm_eps)
    out = y.to(x.dtype) @ params.out_proj
    return out[:, None], {"state": state, "conv": hist[:, 1:]}


def ssm_recur(state, xs, dt, a, bmat, cmat):
    """The recurrence of one token: state [B,H,P,N] fp32 decayed by
    exp(dt * a) (dt [B,H], a [H]) plus (dt * x) [B,H,P] times B [B,N]; its
    read-out y [B,H,P] = C [B,N] . state. -> (y, new state); `state` is
    not written."""
    decay = torch.exp(dt * a)                                    # [b,h]
    state = state * decay[:, :, None, None] + \
        (dt[:, :, None] * xs)[..., None] * bmat[:, None, None, :]
    return torch.einsum("bn,bhpn->bhp", cmat, state), state

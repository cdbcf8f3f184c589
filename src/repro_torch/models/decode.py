"""Serving path: KV and SSM caches, prefill, one-token decode, for every
family.

The JAX package's `models/decode.py`. Cache geometry (leading axis =
layer):
  dense, moe:  k, v                  [L,   B, S,  K, h]
  gemma2:      k/v_local (ring)      [L/2, B, Wc, K, h] (Wc = min(S, window))
               + k/v_global          [L/2, B, S,  K, h]
  llama4:      k/v_dense + k/v_moe   [L/2, B, S,  K, h] (`alt_dense_moe`)
  ssm:         state (fp32)          [L,   B, H,  P, N]
               + conv tail           [L,   B, W-1, ch]
  hybrid:      ring k, v             [L,   B, Wc, K, h] + state + conv
  encdec:      k/v_self              [L,   B, S,  K, h]
               + frozen k/v_cross    [L,   B, S_enc, K, h]

Ring buffers: slot = position % Wc; RoPE is applied at write time with the
absolute position, so storage order is irrelevant to attention. Global
layers write at min(position, S - 1).

The encdec cross-attention query is RoPE'd at prefill (the full-sequence
attention RoPEs every query) but not in `decode_step`, as in the JAX
package; the port keeps both, since it is held against the JAX package's
`decode_step`, not against its forward. The cross caches (the encoder
memory's keys and values, never RoPE'd) are read, never written.

The JAX package's caches are immutable and every step returns new ones.
Here `decode_step` writes each layer's new k and v, SSM state and conv
tail into the caches IN PLACE (no copy of the gigabytes of a full-width
cache per step) and returns the same dict for API parity: clone a cache
before stepping to keep it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as MODEL

Cache = dict


def _window_cache_len(cfg: ModelConfig, ctx_len: int) -> int:
    w = cfg.sliding_window
    return min(ctx_len, w) if w else ctx_len


def init_cache(cfg: ModelConfig, batch: int, ctx_len: int,
               enc_len: int = 0, *, device=None) -> Cache:
    """Zero cache sized for a `ctx_len` context (and, under encdec, an
    encoder memory of `enc_len` positions, `ctx_len` when 0)."""
    dt = L.dtype_of(cfg)
    lyr = cfg.n_layers
    wc = _window_cache_len(cfg, ctx_len)

    def kv(n_l, s):
        shape = (n_l, batch, s, cfg.n_kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def ssm():
        di, h, p, n, ch = M._dims(cfg)
        return {"state": torch.zeros((lyr, batch, h, p, n),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((lyr, batch, cfg.conv_width - 1, ch),
                                    dtype=dt, device=device)}

    if cfg.family == "ssm":
        return ssm()
    if cfg.family == "hybrid":
        k, v = kv(lyr, wc)
        return {"k": k, "v": v, **ssm()}
    if cfg.family == "encdec":
        ks, vs = kv(lyr, ctx_len)
        kc, vc = kv(lyr, enc_len or ctx_len)
        return {"k_self": ks, "v_self": vs, "k_cross": kc, "v_cross": vc}
    if cfg.alt_local_global:
        kl, vl = kv(lyr // 2, wc)
        kg, vg = kv(lyr // 2, ctx_len)
        return {"k_local": kl, "v_local": vl, "k_global": kg, "v_global": vg}
    if cfg.family == "moe" and cfg.alt_dense_moe:
        kd, vd = kv(lyr // 2, ctx_len)
        km, vm = kv(lyr // 2, ctx_len)
        return {"k_dense": kd, "v_dense": vd, "k_moe": km, "v_moe": vm}
    k, v = kv(lyr, ctx_len)
    return {"k": k, "v": v}


# ---------------------------------------------------------------- per-step --

def write_kv(ck, cv, k_new, v_new, slot) -> None:
    """Row b's new key and value k_new/v_new [B, 1, K, h] into the caches
    ck/cv [B, Wc|S, K, h] at position slot[b], in place."""
    rows = torch.arange(ck.shape[0], device=ck.device)
    ck[rows, slot.long()] = k_new[:, 0]
    cv[rows, slot.long()] = v_new[:, 0]


def _attn_decode(cfg: ModelConfig, attn: L.Attention, x, positions, ck, cv,
                 *, window: int):
    """x: [B,1,D]; ck/cv: [B, Wc|S, K, h], written in place at the token's
    slot; positions: int32[B]."""
    pos2 = positions[:, None]                                  # [B,1]
    q, k_new, v_new = attn.qkv(x)
    q = L.rope(q, pos2, cfg.rope_theta)
    k_new = L.rope(k_new, pos2, cfg.rope_theta)
    wc = ck.shape[1]
    slot = positions % wc if window else positions.clamp(max=wc - 1)
    write_kv(ck, cv, k_new, v_new, slot)
    clen = (positions + 1).clamp(max=wc).to(torch.int32)
    out = L.decode_attention(q, ck, cv, clen,
                             logit_cap=cfg.attn_logit_softcap)
    return attn.out(out), ck, cv


def _dense_decode_layer(cfg: ModelConfig, lp: MODEL.DenseLayer, x, positions,
                        ck, cv, *, window: int):
    """A dense or MoE layer's step (their FFN is `lp.ffn`)."""
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    a, ck, cv = _attn_decode(cfg, lp.attn, h, positions, ck, cv,
                             window=window)
    x = x + a
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + lp.ffn(h, cfg), ck, cv


def _ssm_decode(cfg: ModelConfig, ssm: M.SSM, h, cache: Cache, i: int):
    """Layer i's recurrent update of the normed input h [B,1,D], its state
    and conv tail written back into the cache in place: y [B,1,D]."""
    y, nc = M.ssm_decode_step(
        ssm, h, {"state": cache["state"][i], "conv": cache["conv"][i]}, cfg)
    cache["state"][i].copy_(nc["state"])
    cache["conv"][i].copy_(nc["conv"])
    return y


def _cross_decode(cfg: ModelConfig, xattn: L.Attention, x, kx, vx):
    """Cross-attention of x [B,1,D] to the encoder memory's frozen keys and
    values kx/vx [B, S_enc, K, h], every position valid; the query is not
    RoPE'd (the JAX package's `decode_step`), and no soft cap."""
    q = L.project(x, xattn.wq)
    enc_len = torch.full((x.shape[0],), kx.shape[1], dtype=torch.int32,
                         device=x.device)
    return xattn.out(L.decode_attention(q, kx, vx, enc_len, logit_cap=0.0))


def _layer_caches(cfg: ModelConfig, cache: Cache, i: int):
    """Layer i's (k, v) cache views: under `alt_local_global` local layer
    2j and global layer 2j+1, under `alt_dense_moe` dense layer 2j and MoE
    layer 2j+1, take entry j of their stacks; an encdec decoder layer its
    self-attention's."""
    if cfg.alt_local_global:
        side = "local" if i % 2 == 0 else "global"
    elif cfg.family == "moe" and cfg.alt_dense_moe:
        side = MODEL.layer_kind(cfg, i)
    elif cfg.family == "encdec":
        return cache["k_self"][i], cache["v_self"][i]
    else:
        return cache["k"][i], cache["v"][i]
    return cache[f"k_{side}"][i // 2], cache[f"v_{side}"][i // 2]


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: MODEL.Model, cache: Cache, tokens,
                positions):
    """One decode step. tokens [B,1] int32, positions [B] int32 ->
    (logits [B,V] fp32, cache), the cache updated in place (with no
    autograd graph, also for a model whose weights require grad)."""
    x = params.embed.embed(tokens)
    for i, lp in enumerate(params.layers):
        kind = MODEL.layer_kind(cfg, i)
        if kind == "ssm":
            h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
            x = x + _ssm_decode(cfg, lp.ssm, h, cache, i)
            continue
        ck, cv = _layer_caches(cfg, cache, i)
        if kind == "hybrid":
            h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
            a, _, _ = _attn_decode(cfg, lp.attn, h, positions, ck, cv,
                                   window=cfg.sliding_window)
            y = _ssm_decode(cfg, lp.ssm, h, cache, i)
            x = x + 0.5 * (a + y)
            x = x + lp.mlp(L.rms_norm(x, lp.ln2, cfg.norm_eps))
        elif kind == "encdec":
            h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
            a, _, _ = _attn_decode(cfg, lp.attn, h, positions, ck, cv,
                                   window=0)
            x = x + a
            h = L.rms_norm(x, lp.lnx, cfg.norm_eps)
            x = x + _cross_decode(cfg, lp.xattn, h, cache["k_cross"][i],
                                  cache["v_cross"][i])
            x = x + lp.mlp(L.rms_norm(x, lp.ln2, cfg.norm_eps))
        else:
            x, _, _ = _dense_decode_layer(cfg, lp, x, positions, ck, cv,
                                          window=MODEL.layer_window(cfg, i))
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return params.embed.logits(x, cfg)[:, 0], cache


# ----------------------------------------------------------------- prefill --

def _ring_pack(k: torch.Tensor, wc: int) -> torch.Tensor:
    """Last `wc` positions of k [L?,B,S,K,h], rolled to ring order."""
    s = k.shape[-3]
    if s <= wc:
        return F.pad(k, (0, 0, 0, 0, 0, wc - s))
    return torch.roll(k[..., s - wc:, :, :], shifts=(s - wc) % wc, dims=-3)


def _fit(k: torch.Tensor, s_alloc: int) -> torch.Tensor:
    """k [L?,B,S,K,h] grown (zeros) or cut to `s_alloc` positions,
    contiguous (the decode kernel takes contiguous caches)."""
    s = k.shape[-3]
    if s < s_alloc:
        return F.pad(k, (0, 0, 0, 0, 0, s_alloc - s))
    return k[..., :s_alloc, :, :].contiguous()


def last_position(hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, S, D] -> its last position [B, 1, D]."""
    return hidden[:, -1:]


@torch.no_grad()
def prefill(cfg: ModelConfig, params: MODEL.Model, inputs: dict,
            ctx_len: int):
    """Run the full prompt; returns (last-token logits [B,V], cache), with
    no autograd graph (a trained model serves with in-place caches).

    `inputs` as `model.forward_hidden` takes them: tokens, or the frontend
    stub's embeds; encdec also enc_embeds, whose keys and values become
    the cross caches as computed. `ctx_len` sizes the cache (>= prompt length) for subsequent decode.
    Only the last position is unembedded (never materializes [B, S, V]).
    """
    hidden, caches = MODEL.forward_hidden(cfg, params, inputs,
                                          collect_cache=True)
    logits = params.embed.logits(last_position(hidden), cfg)
    wc = _window_cache_len(cfg, ctx_len)
    if cfg.family == "ssm":
        state, conv = caches
        cache = {"state": state, "conv": conv}
    elif cfg.family == "hybrid":
        (k, v), (state, conv) = caches
        cache = {"k": _ring_pack(k, wc), "v": _ring_pack(v, wc),
                 "state": state, "conv": conv}
    elif cfg.family == "encdec":
        (k, v), (kc, vc) = caches
        cache = {"k_self": _fit(k, ctx_len), "v_self": _fit(v, ctx_len),
                 "k_cross": kc, "v_cross": vc}
    elif cfg.family == "moe" and cfg.alt_dense_moe:
        (kd, vd), (km, vm) = caches
        cache = {"k_dense": _fit(kd, ctx_len), "v_dense": _fit(vd, ctx_len),
                 "k_moe": _fit(km, ctx_len), "v_moe": _fit(vm, ctx_len)}
    elif cfg.alt_local_global:
        (kl, vl), (kg, vg) = caches
        cache = {"k_local": _ring_pack(kl, wc), "v_local": _ring_pack(vl, wc),
                 "k_global": _fit(kg, ctx_len), "v_global": _fit(vg, ctx_len)}
    else:
        k, v = caches
        cache = {"k": _fit(k, ctx_len), "v": _fit(v, ctx_len)}
    return logits[:, -1], cache

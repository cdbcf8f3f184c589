"""Serving path of the dense family: KV caches, prefill, one-token decode.

The JAX package's `models/decode.py` for its dense branches. Cache
geometry (leading axis = layer):
  dense:   k, v                  [L,   B, S,  K, h]
  gemma2:  k/v_local (ring)      [L/2, B, Wc, K, h] (Wc = min(S, window))
           + k/v_global          [L/2, B, S,  K, h]

Ring buffers: slot = position % Wc; RoPE is applied at write time with the
absolute position, so storage order is irrelevant to attention. Global
layers write at min(position, S - 1).

The JAX package's caches are immutable and every step returns new ones.
Here `decode_step` writes the new token's k and v into the caches IN PLACE
(`index_put_` into the preallocated tensors, no copy of the gigabytes of a
full-width cache per step) and returns the same dict for API parity:
clone a cache before stepping to keep it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL

Cache = dict


def _window_cache_len(cfg: ModelConfig, ctx_len: int) -> int:
    w = cfg.sliding_window
    return min(ctx_len, w) if w else ctx_len


def init_cache(cfg: ModelConfig, batch: int, ctx_len: int, *,
               device=None) -> Cache:
    """Zero cache sized for a `ctx_len` context."""
    MODEL.check_ported(cfg)
    dt = L.dtype_of(cfg)

    def kv(n_l, s):
        shape = (n_l, batch, s, cfg.n_kv, cfg.head_dim)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    if cfg.alt_local_global:
        kl, vl = kv(cfg.n_layers // 2, _window_cache_len(cfg, ctx_len))
        kg, vg = kv(cfg.n_layers // 2, ctx_len)
        return {"k_local": kl, "v_local": vl, "k_global": kg, "v_global": vg}
    k, v = kv(cfg.n_layers, ctx_len)
    return {"k": k, "v": v}


# ---------------------------------------------------------------- per-step --

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
    rows = torch.arange(x.shape[0], device=x.device)
    ck[rows, slot.long()] = k_new[:, 0]
    cv[rows, slot.long()] = v_new[:, 0]
    clen = (positions + 1).clamp(max=wc).to(torch.int32)
    out = L.decode_attention(q, ck, cv, clen,
                             logit_cap=cfg.attn_logit_softcap)
    return attn.out(out), ck, cv


def _dense_decode_layer(cfg: ModelConfig, lp: MODEL.DenseLayer, x, positions,
                        ck, cv, *, window: int):
    h = L.rms_norm(x, lp.ln1, cfg.norm_eps)
    a, ck, cv = _attn_decode(cfg, lp.attn, h, positions, ck, cv,
                             window=window)
    x = x + a
    h = L.rms_norm(x, lp.ln2, cfg.norm_eps)
    return x + lp.mlp(h), ck, cv


def _layer_caches(cfg: ModelConfig, cache: Cache, i: int):
    """Layer i's (k, v) cache views: local layer 2j and global layer 2j+1
    take entry j of their stacks under `alt_local_global`."""
    if cfg.alt_local_global:
        side = "local" if i % 2 == 0 else "global"
        return cache[f"k_{side}"][i // 2], cache[f"v_{side}"][i // 2]
    return cache["k"][i], cache["v"][i]


def decode_step(cfg: ModelConfig, params: MODEL.Model, cache: Cache, tokens,
                positions):
    """One decode step. tokens [B,1] int32, positions [B] int32 ->
    (logits [B,V] fp32, cache), the cache updated in place."""
    MODEL.check_ported(cfg)
    x = params.embed.embed(tokens)
    for i, lp in enumerate(params.layers):
        ck, cv = _layer_caches(cfg, cache, i)
        x, _, _ = _dense_decode_layer(cfg, lp, x, positions, ck, cv,
                                      window=MODEL.layer_window(cfg, i))
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return params.embed.unembed(x, cfg)[:, 0], cache


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


def prefill(cfg: ModelConfig, params: MODEL.Model, inputs: dict,
            ctx_len: int):
    """Run the full prompt; returns (last-token logits [B,V], cache).

    `ctx_len` sizes the cache (>= prompt length) for subsequent decode.
    Only the last position is unembedded (never materializes [B, S, V]).
    """
    hidden, caches = MODEL.forward_hidden(cfg, params, inputs)
    logits = params.embed.unembed(hidden[:, -1:], cfg)
    if cfg.alt_local_global:
        wc = _window_cache_len(cfg, ctx_len)
        (kl, vl), (kg, vg) = caches
        cache = {"k_local": _ring_pack(kl, wc), "v_local": _ring_pack(vl, wc),
                 "k_global": _fit(kg, ctx_len), "v_global": _fit(vg, ctx_len)}
    else:
        k, v = caches
        cache = {"k": _fit(k, ctx_len), "v": _fit(v, ctx_len)}
    return logits[:, -1], cache

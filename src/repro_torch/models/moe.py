"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The JAX package's `models/moe.py`. Dispatch has static shapes: top-k
assignments are sorted by expert id (stable), ranked within their expert,
and scattered into a dense [E, C, D] buffer (capacity C from
`capacity_factor`; an assignment ranked past C is dropped, standard for
capacity-factor MoE). The three expert products run as batched matrix
products over the E axis, and the outputs are gathered back, scaled by
the renormalised gates and summed per token.

`moe_ffn_a2a`, the JAX package's expert-parallel shard_map schedule,
computes `moe_ffn` off a mesh, which is what one card runs; it waits for
the port of `parallel/sharding.py` (`ROADMAP.md` queue 1 item 12).

Shapes: T tokens (B * S), D d_model, E experts, k top_k, F moe_d_ff,
C capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class MoE(nn.Module):
    """router fp32 [D, E] (whatever the model's dtype, as in the JAX
    package), wg/wi [E, D, F], wo [E, F, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, generator=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = L.weight((d, e), d ** -0.5, torch.float32, device,
                               generator)
        self.wg = L.stacked_weight(e, (d, f), d ** -0.5, dtype, device,
                                   generator)
        self.wi = L.stacked_weight(e, (d, f), d ** -0.5, dtype, device,
                                   generator)
        self.wo = L.stacked_weight(e, (f, d), f ** -0.5, dtype, device,
                                   generator)

    def forward(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return moe_ffn(self, x, cfg)


def init_moe(cfg: ModelConfig, dtype, device=None, generator=None) -> MoE:
    """Random expert weights with the JAX package's shapes and scales, drawn
    from `generator`; uninitialized when it is None (to be copied in)."""
    return MoE(cfg, dtype, device, generator)


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    c = int(cfg.capacity_factor * num_tokens * cfg.top_k / cfg.n_experts) + 1
    return max(c, 1)


def route(params: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """The dispatch of T tokens xf [T, D]: (gates [T, k] renormalised,
    order [T*k] of the stable sort by expert, expert and token of each
    sorted assignment, slot [T*k] in the [E*C] buffer with E*C for a
    dropped one, keep [T*k])."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, t)
    dev = xf.device
    probs = torch.softmax(xf.float() @ params.router, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)       # [T, k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e_flat = idx.reshape(-1)                                     # [T*k]
    tok_flat = torch.arange(t * k, device=dev) // k
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = tok_flat[order]
    starts = torch.searchsorted(e_sorted, torch.arange(e, device=dev),
                                side="left")
    rank = torch.arange(t * k, device=dev) - starts[e_sorted]
    keep = rank < c
    slot = torch.where(keep, e_sorted * c + rank, e * c)         # sentinel
    return gates, order, e_sorted, tok_sorted, slot, keep


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    c = capacity(cfg, t)
    xf = x.reshape(t, d)
    gates, order, _, tok_sorted, slot, keep = route(params, xf, cfg)

    # One spare row takes the dropped assignments (the JAX scatter's
    # mode="drop" of slot E*C) and is cut off.
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = xf[tok_sorted]
    buf = buf[:e * c].reshape(e, c, d)

    gate = F.silu(torch.bmm(buf, params.wg))                     # [E, C, F]
    up = torch.bmm(buf, params.wi)
    out = torch.bmm(gate * up, params.wo).reshape(e * c, d)

    safe_slot = slot.clamp(max=e * c - 1)
    contrib = torch.where(keep[:, None], out[safe_slot], 0)
    g_sorted = gates.reshape(-1)[order]
    contrib = contrib * g_sorted[:, None].to(contrib.dtype)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, tok_sorted, contrib)
    return y.reshape(b, s, d)

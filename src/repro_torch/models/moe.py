"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The JAX package's `models/moe.py`. Dispatch has static shapes: top-k
assignments are sorted by expert id (stable), ranked within their expert,
and scattered into a dense [E, C, D] buffer (capacity C from
`capacity_factor`; an assignment ranked past C is dropped, standard for
capacity-factor MoE). The three expert products run as batched matrix
products over the E axis, and the outputs are gathered back, scaled by
the renormalised gates and summed per token in top-k order (the same
bits on every device).

`moe_ffn_a2a` is the JAX package's expert-parallel schedule: tokens stay
on their rank, one all-to-all over the `model` axis takes each to the
rank that owns its expert and one brings the outputs back. It is
`torch.distributed.tensor.experimental.local_map` over the ambient mesh
(`parallel/sharding.py`) in place of `shard_map`, and falls back to
`moe_ffn` where the reference does: off a mesh, and where the sequence or
the experts do not divide over `model` (decode).

Shapes: T tokens (B * S), D d_model, E experts, k top_k, F moe_d_ff,
C capacity.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as SH


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
    return _route(params.router, xf, cfg, capacity(cfg, xf.shape[0]))


def _route(router: torch.Tensor, xf: torch.Tensor, cfg: ModelConfig,
           c: int):
    """`route` with router [D, E] and capacity `c` given."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    probs = torch.softmax(xf.float() @ router, dim=-1)
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


def _dispatch(xf, slot, tok_sorted, n_slots: int):
    """The [n_slots, D] buffer of the kept assignments' tokens. One spare
    row takes the dropped ones (the JAX scatter's mode="drop" of slot
    n_slots) and is cut off."""
    buf = torch.zeros((n_slots + 1, xf.shape[1]), dtype=xf.dtype,
                      device=xf.device)
    buf[slot] = SH.constrain_spec(xf[tok_sorted], "batch", None)
    return buf[:n_slots]


def _experts(buf, wg, wi, wo):
    """The SwiGLU expert products on [E, C, D] -> [E, C, D]."""
    gate = F.silu(torch.bmm(buf, wg))                            # [E, C, F]
    up = torch.bmm(buf, wi)
    return torch.bmm(gate * up, wo)


def _combine(out, gates, order, slot, keep, t: int):
    """y [T, D]: each kept assignment's expert output out [E*C, D],
    scaled by its gate and summed into its token in a fixed order. The
    scaled contributions go back to their (token, k) places (`order` is a
    permutation, so this moves them exactly) and each token's k are added
    one at a time in top-k order, in the outputs' dtype. Each add rounds
    alike everywhere, so the result is the same bits on every device and
    run: an `index_add_` on a card sums in no fixed order, and a `sum`
    over k adds in fp32 in whatever order each device's reduction takes."""
    safe_slot = slot.clamp(max=out.shape[0] - 1)
    contrib = torch.where(keep[:, None], out[safe_slot], 0)
    contrib = SH.constrain_spec(contrib, "batch", None)
    g_sorted = gates.reshape(-1)[order]
    contrib = contrib * g_sorted[:, None].to(contrib.dtype)
    k = gates.shape[1]
    by_token = torch.empty_like(contrib)
    by_token[order] = contrib
    by_token = by_token.reshape(t, k, -1)
    y = by_token[:, 0]
    for j in range(1, k):
        y = y + by_token[:, j]
    return SH.constrain_spec(y, "batch", None)


def moe_ffn(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    c = capacity(cfg, t)
    xf = x.reshape(t, d)
    gates, order, _, tok_sorted, slot, keep = _route(params.router, xf, cfg,
                                                     c)
    buf = _dispatch(xf, slot, tok_sorted, e * c).reshape(e, c, d)
    buf = SH.constrain_spec(buf, "tp", None, None)   # experts on model (EP)
    out = _experts(buf, params.wg, params.wi, params.wo).reshape(e * c, d)
    return _combine(out, gates, order, slot, keep, t).reshape(b, s, d)


# ---------------------------------------------------- explicit-a2a dispatch --

def _gather(ws, dims, groups) -> list:
    """Each of `ws` all-gathered along its dim in `dims` (the one sharded
    over the fsdp axes, of one size in all) over `groups` (the fsdp axes'
    groups, minor axis first, so that a dim sharded over (pod, data)
    comes back in mesh order), with autograd (backward: a reduce-scatter).
    The weights travel as one buffer: one collective a group each way,
    so no two ranks can issue a group's collectives in different orders
    (backward runs the host-staged ones on the host's autograd thread)."""
    import torch.distributed._functional_collectives as fc
    dev = ws[0].device
    flat = [w.movedim(d, 0) for w, d in zip(ws, dims)]
    shapes = [f.shape for f in flat]
    buf = torch.cat([f.reshape(f.shape[0], -1) for f in flat], dim=1)
    for group in reversed(groups):
        buf = fc.wait_tensor(fc.all_gather_tensor_autograd(
            C.staged(buf, group), 0, group))
    parts = buf.to(dev).split([math.prod(sh[1:]) for sh in shapes], dim=1)
    return [p.reshape(-1, *sh[1:]).movedim(0, d)
            for p, sh, d in zip(parts, shapes, dims)]


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block p of t's leading axis to rank p of `group`, with autograd
    (backward: the all-to-all back)."""
    import torch.distributed._functional_collectives as fc
    return fc.wait_tensor(fc.all_to_all_single_autograd(t, None, None,
                                                        group))


def moe_ffn_a2a(params: MoE, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Expert-parallel MoE with an explicit all-to-all schedule.

    Tokens are disjoint per rank (batch over the batch axes, sequence over
    `model`). Each rank routes its own tokens with the capacity of its own
    token count, buckets them by destination expert, one all-to-all over
    `model` delivers them to the experts' owners, the expert products run
    on [E/P, P*cap, D], and a second all-to-all returns the outputs to the
    tokens' home ranks; the expert weights are all-gathered over the fsdp
    axes first. x and the weights are DTensors on the ambient mesh,
    redistributed to the reference's `in_specs`; the result is a DTensor
    with x's spec.

    Falls back to `moe_ffn` off a mesh, without a `model` axis, or when
    the sequence or the experts do not divide over `model` (decode).
    """
    mesh, rules = SH._ambient()
    b, s, d = x.shape
    if mesh is None or rules.tp_axis is None:
        return moe_ffn(params, x, cfg)
    ax_m = rules.tp_axis
    p_model = SH.axis_size(mesh, ax_m)
    e, k = cfg.n_experts, cfg.top_k
    if s % p_model != 0 or e % p_model != 0:
        return moe_ffn(params, x, cfg)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    e_loc = e // p_model
    fsdp = rules.fsdp_axes
    fsdp_groups = [mesh.get_group(a) for a in fsdp]
    m_group = mesh.get_group(ax_m)

    def body(x_loc, router, wg, wi, wo):
        bl, sl, _ = x_loc.shape
        t = bl * sl
        cap = int(cfg.capacity_factor * t * k / e) + 1
        xf = x_loc.reshape(t, d)
        wg, wi, wo = _gather((wg, wi, wo), (1, 1, 2), fsdp_groups)
        gates, order, _, tok_sorted, slot, keep = _route(router, xf, cfg,
                                                         cap)
        send = _dispatch(xf, slot, tok_sorted, e * cap)
        # block p -> model rank p (each rank owns e_loc experts)
        recv = _all_to_all(send, m_group)                  # [P*e_loc*cap, d]
        buf = recv.reshape(p_model, e_loc, cap, d).transpose(0, 1)
        buf = buf.reshape(e_loc, p_model * cap, d)
        out = _experts(buf, wg, wi, wo)
        out = out.reshape(e_loc, p_model, cap, d).transpose(0, 1)
        back = _all_to_all(out.reshape(p_model * e_loc * cap, d), m_group)
        y = _combine(back, gates, order, slot, keep, t)
        return y.reshape(bl, sl, d)

    bat = rules.batch_axes or None
    fs = fsdp or None
    specs = [(bat, ax_m, None), (None, None), (ax_m, fs, None),
             (ax_m, fs, None), (ax_m, None, fs)]
    place = [SH.placements(sp, mesh) for sp in specs]
    # The replicated router's gradient is each rank's part of the sum
    # (shard_map's transpose psums it).
    grads = list(place)
    grads[1] = tuple(Partial() for _ in range(mesh.ndim))
    fn = local_map(body, out_placements=list(place[0]), in_placements=place,
                   in_grad_placements=grads, redistribute_inputs=True,
                   device_mesh=mesh)
    return fn(x, params.router, params.wg, params.wi, params.wo)

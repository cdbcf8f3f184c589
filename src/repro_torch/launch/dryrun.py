"""Multi-pod dry-run on the CPU: run every (arch x shape x mesh) cell's step
on DTensors of the production mesh, with no data (the JAX package's
`launch/dryrun.py`).

For each cell this shows that the sharding rules hold together at
production scale (every parameter, input and cache takes its placements,
the step runs on them) and records what a rank would hold, compute and
send. The mesh lives in a `fake` process group (`launch.mesh.fake_world`:
this process is the last rank of 256 or 512) and every tensor is a
`FakeTensor` (`torch._subclasses.fake_tensor.FakeTensorMode`): shapes,
dtypes and placements, no storage. Nothing is timed and nothing is lowered.

A record holds, beside `arch`, `shape`, `mesh`, `status` (`ok`,
`skipped` with `cell_applicable`'s reason, or `error` with the exception
and the aten op it names), `params_total`, `params_active`,
`model_flops` and `n_devices` (the reference's):
  * `param_bytes_per_rank`, `grad_bytes_per_rank`, `moment_bytes_per_rank`
    and `cache_bytes_per_rank`, from the placements at full depth;
  * `step_peak_bytes_per_rank_est`: the most bytes one rank's step holds
    at once beyond its arguments (activations, gradients, temporaries and
    gathered weights: every storage an op allocates, until it is freed);
  * `bytes_per_rank_est`: that peak plus the parameters, moments and
    caches a rank holds;
  * `flops_per_rank_est`: the FLOPs of one rank's local ops (the
    counterpart of the JAX package's per-device HLO FLOPs: compute
    replicated over a mesh dim counts on every rank of it), from
    `torch.utils.flop_counter`'s formulas;
  * `collective_bytes_per_rank_est`: the bytes each collective returns on
    one rank, by the reference's kind names (all-gather, all-reduce,
    reduce-scatter, all-to-all).
The `_est` numbers come, as in the reference, from probes at one and two
scan bodies (`probe_cfg`, `n_bodies`), extrapolated to the full depth:
total = probe(1) + (n - 1) * (probe(2) - probe(1)). The reference's
XLA-only fields (`hlo_*`, `lower_s`, `compile_s`, `temp_bytes`) have no
counterpart.

`mesh_device` is "cpu": on a CPU mesh DTensor carries out a Shard(i) ->
Shard(j) redistribution as an all-gather and a chunk, so those count as
all-gather bytes where a card would send an all-to-all (the explicit MoE
all-to-alls of `moe_ffn_a2a` count as all-to-all).

The dry-run runs every cell under the reference's own rules
(`AxisRules()`: batch on (pod, data), FSDP over `fsdp_axes`, tensor and
expert parallelism over `model`, and sequence parallelism: the sequence on
`model` between layers). Its counts are those of the last rank of the
mesh: under sequence parallelism its block of queries sees every key, so
it does the most causal attention work of any rank. Where it departs from
the reference:
  * the embedding's output enters the first layer with its sequence on
    `model` (`_scatter_sequence`: each rank keeps its block, no
    communication), where the reference leaves that dim to GSPMD;
  * the decode body for a cache whose head_dim is sharded (the partial
    scores all-reduced over `model`, `_head_dim_attention`) is plain
    PyTorch on every device: no kernel computes partial scores.

The train and prefill steps run the bodies of `sharded_forwards` under
sequence parallelism (the column- and row-parallel products gather the
sequence and reduce-scatter it back, attention by heads or by blocks of
queries, the SSD's chunked scan on the gathered sequence for a block of
its heads, the CE's sequence fallback); the decode step runs on the
caches `cache_specs` places (`_sharded_write_kv`,
`_sharded_decode_attention`, `_sharded_ssm_recur`; the MoE at one token a
row through `_sharded_moe_ffn`).

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import re
import traceback
import weakref
from collections import defaultdict

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.launch import mesh as MESH
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as MODEL
from repro_torch.models import moe as MOE
from repro_torch.parallel import collectives as C
from repro_torch.parallel import sharding as SH
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch.json"

# Giant-MoE memory recipe: FSDP over (pod, data) + bf16 moments.
GIANT = {"qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"}


# ------------------------------------------------------- analytic model flops

def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_params(cfg, model: nn.Module) -> int:
    """Active params a token (MoE discounts the inactive experts)."""
    total = count_params(model)
    if cfg.n_experts and cfg.top_k:
        expert = 3 * cfg.d_model * cfg.moe_d_ff
        n_moe_layers = cfg.n_layers // (2 if cfg.alt_dense_moe else 1)
        total -= n_moe_layers * (cfg.n_experts - cfg.top_k) * expert
    return total


def model_flops(cfg, model: nn.Module, shape_name: str) -> float:
    """6*N_active*D for train; 2*N_active*D for prefill; 2*N_active*B +
    the attention over the cache for decode."""
    cell = SHAPES[shape_name]
    n_act = active_params(cfg, model)
    tokens = cell.global_batch * cell.seq_len
    if cell.kind == "train":
        return 6.0 * n_act * tokens
    if cell.kind == "prefill":
        return 2.0 * n_act * tokens
    attn = 0.0
    if cfg.n_heads:
        attn = (4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim
                * cell.seq_len * cell.global_batch)
    return 2.0 * n_act * cell.global_batch + attn


def n_bodies(cfg) -> int:
    if cfg.alt_local_global or cfg.alt_dense_moe:
        return cfg.n_layers // 2
    return cfg.n_layers


def probe_cfg(cfg, bodies: int):
    per = 2 if (cfg.alt_local_global or cfg.alt_dense_moe) else 1
    lyr = bodies * per
    rep = {"n_layers": lyr}
    if cfg.n_enc_layers:
        rep["n_enc_layers"] = lyr
    return dataclasses.replace(cfg, **rep)


# ----------------------------------------------------------- what a rank holds

def _local_numel(shape, spec, mesh) -> int:
    return math.prod(d // SH._size(mesh, ax) for d, ax in zip(shape, spec))


def _bytes_per_rank(tensors: dict, specs: dict, mesh) -> int:
    return sum(_local_numel(t.shape, specs[n], mesh) * t.element_size()
               for n, t in tensors.items())


def _setup(rules, multi_pod: bool, arch: str):
    """The cell's rules and optimizer config: the giant MoEs' FSDP over
    (pod, data) on the multi-pod mesh and bf16 moments."""
    fsdp = ("pod", "data") if (arch in GIANT and multi_pod) else ("data",)
    rules = dataclasses.replace(rules, fsdp_axes=fsdp)
    ocfg = OptConfig(moment_dtype="bfloat16" if arch in GIANT
                     else "float32")
    return rules, ocfg


def shard_model(model: nn.Module, cfg, mesh, rules) -> nn.Module:
    """`model` with every parameter made a DTensor of its spec (each rank
    keeps its shard of the whole tensor it holds), in place."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = SH.param_specs(cfg, shapes, mesh, rules)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(SH.distribute(p.data, mesh,
                                                    specs[name]),
                                        requires_grad=False))
    return model


def shard_cache(cache: dict, mesh, rules) -> dict:
    """Each cache tensor (the whole one) as a DTensor of its
    `cache_specs` spec."""
    specs = SH.cache_specs(cache, mesh, rules)
    return {k: SH.distribute(v, mesh, specs[k]) for k, v in cache.items()}


def shard_batch(batch: dict, mesh, rules) -> dict:
    """Each input (the whole tensor, the same on every rank) as a DTensor
    of its `batch_specs` spec."""
    specs = SH.batch_specs(batch, mesh, rules)
    return {k: SH.distribute(v, mesh, specs[k]) for k, v in batch.items()}


def _inputs(cfg, shape: str, mesh, rules) -> dict:
    return shard_batch({k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                        input_specs(cfg, shape).items()}, mesh, rules)


@contextlib.contextmanager
def on_mesh(mesh, rules):
    """The model code run on DTensors of `mesh`: the mesh ambient with
    `rules`, plain tensors taken as replicated, and `sharded_forwards`."""
    from torch.distributed.tensor.experimental import implicit_replication
    with SH.activate(mesh, rules), implicit_replication(), \
            sharded_forwards():
        yield


# ------------------------------------------------------- DTensor forwards
#
# DTensor has no sharding rule for some of the model's products: einsum
# flattenings of a sharded dim, uneven head splits, a gather over a
# vocab-sharded dim, the SSD's batched products on strided shards. While a
# cell runs, `sharded_forwards` swaps the layers' module functions for
# versions that run them as blocks under `local_map`; the model code keeps
# its one plain path. Under sequence parallelism the activations between
# layers come with their sequence on `model`: the blocks gather it and
# scatter it back with the explicit collectives of `parallel/collectives.py`
# (host-staged on gloo ranks that share a card), never through a DTensor
# redistribution.

def _axes(entry) -> tuple:
    """The mesh axes of a spec entry (None, a name, or names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _on_axis(t, mesh, axis, dim: int) -> bool:
    """Whether DTensor t's dim `dim` is sharded over mesh axis `axis`."""
    from torch.distributed.tensor import Shard
    if axis is None:
        return False
    return t.placements[mesh.mesh_dim_names.index(axis)] == Shard(dim)


def _ambient():
    """`sharding._ambient()` for the sequence-parallel bodies. They sum the
    partials of a split over the tensor-parallel axis (vocab, heads, d_ff)
    in the same collective that gathers or scatters the sequence, over the
    sequence axis's group, so the two axes must be one (`AxisRules()`:
    both `model`) where the sequence is split."""
    mesh, r = SH._ambient()
    if r.seq_axis not in (None, r.tp_axis):
        raise ValueError(f"sequence on {r.seq_axis!r}, tensor parallelism "
                         f"on {r.tp_axis!r}: the sharded bodies need one "
                         f"axis for both")
    return mesh, r


def _sharded_lookup(plain, table, tokens):
    """`layers.lookup` (the token embedding) of tokens [B, S] whose S
    divides the sequence axis, batch on the batch axes: each rank looks up
    its own tokens. Where the vocab divides the tensor-parallel axis, each
    rank holds a block of the table's rows and looks up every position of
    its batch in it (zeros where a token lies outside), and the partial
    sums are reduce-scattered onto the sequence (Megatron's vocab-parallel
    embedding); else the table is whole and each rank takes its block of
    the sequence. Either way the result comes with its sequence on the
    axis, as the carry between layers does. Otherwise (decode) `plain`."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    ax = r.seq_axis
    if not SH._fit(tokens.shape[1], mesh, ax):
        return plain(table, tokens)
    bq = SH._fit(tokens.shape[0], mesh, r.batch_axes)
    vt = SH._fit(table.shape[0], mesh, r.tp_axis)
    group = mesh.get_group(ax)
    batch = _axes(bq)

    def body(tl, ids):
        if vt is None:
            return tl[ids.chunk(SH.axis_size(mesh, ax), 1)[
                mesh.get_local_rank(ax)].long()]
        n = tl.shape[0]
        i = ids.long() - mesh.get_local_rank(vt) * n
        hit = (i >= 0) & (i < n)
        rows = torch.where(hit[..., None], tl[i.clamp(0, n - 1)], 0.0)
        return C.reduce_scatter_seq(rows, 1, group)

    t_spec = (vt, None)
    return local_map(
        body, out_placements=list(SH.placements((bq, ax, None), mesh)),
        in_placements=(SH.placements(t_spec, mesh),
                       SH.placements((bq, None), mesh)),
        in_grad_placements=(SH.placements(t_spec, mesh, batch + (
            () if vt else (ax,))), SH.placements((bq, None), mesh)),
        redistribute_inputs=True, device_mesh=mesh)(table, tokens)


def _scatter_sequence(plain, x, batch_dim: int = 0):
    """`constrain_batch` (the embedding's output) under sequence
    parallelism: batch on the batch axes, then each rank's block of the
    sequence of an activation [B, S, D] whose S divides the sequence axis
    (`split_seq`: no communication; its gradient is all-gathered back), so
    that the first layer takes what the carry between layers is. An
    activation that comes so (`_sharded_lookup`'s) is left as it is."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    if batch_dim == 0 and x.ndim == 3 and _on_axis(x, mesh, r.seq_axis, 1):
        return x
    x = plain(x, batch_dim)
    if batch_dim != 0 or x.ndim != 3 or not x.is_floating_point() or \
            not SH._fit(x.shape[1], mesh, r.seq_axis):
        return x
    bq = SH._fit(x.shape[0], mesh, r.batch_axes)
    group = mesh.get_group(r.seq_axis)
    return local_map(
        lambda t: C.split_seq(t, 1, group),
        out_placements=list(SH.placements((bq, r.seq_axis, None), mesh)),
        in_placements=(SH.placements((bq, None, None), mesh),),
        redistribute_inputs=True, device_mesh=mesh)(x)


def _tensor_parallel(fn, a, weights, w_dims, n: int, *, a_dim=None,
                     out_dim=None, out_ndim: int = 3):
    """`fn(a, *weights)` on DTensors as a Megatron tensor-parallel block:
    weight i split over the tensor-parallel axis at dim `w_dims[i]`, `a`
    at `a_dim` (None: not split there), the result at `out_dim` (None:
    each rank's partial sum). `n` is the size the axis splits (heads,
    d_ff). `a` may come with its sequence (dim 1) on the sequence axis:
      * where n divides the axis, the sequence is all-gathered before the
        product (`gather_seq`) and a partial result is reduce-scattered
        onto it (`reduce_scatter_seq`; left a partial sum where the
        sequence does not divide, as at decode);
      * where it does not, the weights are whole on the axis and each rank
        projects its own tokens (with the sequence whole, every rank
        computes the whole block).
    Batch goes on the batch axes, the weights are gathered over the others,
    and each rank runs `fn` on its own block."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    tp = r.tp_axis if SH._fit(n, mesh, r.tp_axis) else None
    bq = SH._fit(a.shape[0], mesh, r.batch_axes)
    sq = r.seq_axis if _on_axis(a, mesh, r.seq_axis, 1) else None
    s_fit = SH._fit(a.shape[1], mesh, r.seq_axis)
    # an `a` whole on the axis (an input, the encoder's embeddings) that
    # meets weights whole on it: each rank takes its block of tokens
    split = s_fit if not (tp or sq) and a_dim is None else None
    out_sq = s_fit if tp and out_dim is None else None
    own = sq or split               # each rank projects its own tokens
    group = mesh.get_group(r.seq_axis) if sq or out_sq or split else None

    def spec(ndim, at: dict, first=bq):
        out = [first] + [None] * (ndim - 1)
        for dim, ax in at.items():
            if dim is not None and ax:
                out[dim] = ax
        return tuple(out)
    a_spec = spec(a.ndim, {a_dim: tp, 1: sq})
    w_specs = [spec(w.ndim, {d: tp}, None) for w, d in zip(weights, w_dims)]
    if out_sq:
        out_p = SH.placements(spec(out_ndim, {1: out_sq}), mesh)
    elif out_dim is None and tp:
        out_p = SH.placements(spec(out_ndim, {}), mesh, (tp,))
    else:
        out_p = SH.placements(spec(out_ndim, {out_dim: tp, 1: own if not tp
                                              else None}), mesh)
    batch = _axes(bq)
    # the gradient of an `a` that is whole on the axis is a partial sum
    # where the axis splits the weights; a weight's is one over the batch
    # axes, and over the axis too where each rank saw its own tokens
    a_grad = SH.placements(a_spec, mesh, (tp,) if tp and a_dim is None
                           and not sq else ())
    w_grad = batch + ((r.seq_axis,) if own and not tp else ())

    def body(al, *wl):
        if sq and tp:
            al = C.gather_seq(al, 1, group)
        if split:
            al = C.split_seq(al, 1, group)
        out = fn(al, *wl)
        return C.reduce_scatter_seq(out, 1, group) if out_sq else out

    fn_ = local_map(
        body, out_placements=list(out_p),
        in_placements=(SH.placements(a_spec, mesh),
                       *(SH.placements(sp, mesh) for sp in w_specs)),
        in_grad_placements=(a_grad, *(SH.placements(sp, mesh, w_grad)
                                      for sp in w_specs)),
        redistribute_inputs=True, device_mesh=mesh)
    return fn_(a, *weights)


def _sharded_attention(flash, q, k, v, **kw):
    """`flash` (the plain `flash_attention`) on DTensors, batch on the
    batch axes:
      * where the query heads divide the tensor-parallel axis, each rank
        attends for its heads over the whole sequence; where the KV heads
        do not divide it, each rank takes the ones its query heads read;
      * where they do not, each rank attends for its own block of queries
        by sequence (the sequence-parallel carry's), with the block's first
        position as `q_offset`: the causal mask, the local window and the
        skipped key blocks follow it.
    Keys and values that come with their sequence on the axis are
    all-gathered along it first (`gather_seq`), non-causal encoder and
    cross attention alike."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    hq, hk = q.shape[2], k.shape[2]
    tp = r.tp_axis if SH._fit(hq, mesh, r.tp_axis) else None
    kv_tp = tp if SH._fit(hk, mesh, tp) else None
    bq = SH._fit(q.shape[0], mesh, r.batch_axes)
    q_sq = r.seq_axis if _on_axis(q, mesh, r.seq_axis, 1) else None
    kv_sq = r.seq_axis if (_on_axis(k, mesh, r.seq_axis, 1) and
                           _on_axis(v, mesh, r.seq_axis, 1)) else None
    q_spec = (bq, q_sq, tp, None)
    kv_spec = (bq, kv_sq, kv_tp, None)
    group = mesh.get_group(r.seq_axis) if kv_sq else None
    # KV heads whole on the axis, each rank reading some: a partial sum
    kv_grad = SH.placements(kv_spec, mesh, (tp,) if tp and not kv_tp
                            and not kv_sq else ())

    def body(ql, kl, vl):
        if kv_sq:
            kl, vl = (C.gather_seq(t, 1, group) for t in (kl, vl))
        if tp is not None and kv_tp is None:
            # this rank's query heads and the KV head each one reads
            n = ql.shape[2]
            first = mesh.get_local_rank(tp) * n
            heads = torch.arange(first, first + n, device=ql.device)
            pick = heads // (hq // hk)
            kl, vl = kl[:, :, pick], vl[:, :, pick]
        off = _offset(mesh, q_sq, ql.shape[1]) if q_sq else 0
        return flash(ql, kl, vl, q_offset=off, **kw)

    fn = local_map(body, out_placements=list(SH.placements(q_spec, mesh)),
                   in_placements=tuple(SH.placements(sp, mesh) for sp in
                                       (q_spec, kv_spec, kv_spec)),
                   in_grad_placements=(SH.placements(q_spec, mesh), kv_grad,
                                       kv_grad),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(q, k, v)


def _model_spec(t, mesh, axis) -> tuple:
    """DTensor t's spec with only `axis` kept: the block a rank takes once
    the other axes (the fsdp ones) are gathered."""
    from torch.distributed.tensor import Shard
    p = t.placements[mesh.mesh_dim_names.index(axis)]
    return tuple(axis if isinstance(p, Shard) and p.dim == d else None
                 for d in range(t.ndim))


def _sharded_ssm(plain, params, x, cfg, return_final_state: bool = False):
    """`ssm_forward` (the SSD mixer) on DTensors, x [B, S, D] with its
    sequence on the sequence axis: each rank gathers the sequence
    (`gather_seq`) and runs the chunked scan, sequential across chunks, on
    the whole of it for its block of SSD heads (where the heads divide the
    axis; else for all of them). The weights come whole on the axis
    (explicit gathers of the blocks it holds) and each rank takes its
    heads' columns of the input projection (z, x and dt; B and C are
    shared), conv channels, [H] weights and out_proj rows; the gated
    norm's sum of squares is all-reduced over the axis, and the partial
    out-projections are reduce-scattered back onto the sequence. With
    `return_final_state`, the state [B, H, P, N] keeps the heads on the
    axis and the conv tail is whole (computed from the last W-1 inputs,
    without autograd: only prefill asks for it)."""
    import torch.nn.functional as F
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    ax = r.tp_axis
    di, h, p, n, _ = M._dims(cfg)
    split = SH._fit(h, mesh, ax) is not None
    sq = _on_axis(x, mesh, ax, 1)
    out_sq = SH._fit(x.shape[1], mesh, ax) is not None
    if not (split or out_sq):
        # the heads and the sequence whole on every rank of the axis
        return plain(params, x, cfg, return_final_state)
    m = SH.axis_size(mesh, ax)
    bq = SH._fit(x.shape[0], mesh, r.batch_axes)
    group = mesh.get_group(ax)
    names = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
             "norm", "out_proj")
    ws = [getattr(params, k) for k in names]
    w_specs = [_model_spec(w, mesh, ax) for w in ws]
    batch = _axes(bq)
    # a weight whole on the axis, each rank using its heads' part or its
    # own tokens: a partial sum over it too
    w_grads = [SH.placements(sp, mesh, batch + (() if ax in sp else (ax,)))
               for sp in w_specs]
    x_spec = (bq, ax if sq else None, None)

    def whole(t, spec, dim):
        return C.gather_seq(t, dim, group) if spec[dim] else t

    def body(xl, in_proj, conv_w, conv_b, a_log, d_skip, dt_bias, norm,
             out_proj):
        if sq:
            xl = C.gather_seq(xl, 1, group)
        b, s, _ = xl.shape
        dev = xl.device
        k = mesh.get_local_rank(ax) if split else 0
        hl = h // m if split else h
        heads = torch.arange(k * hl, (k + 1) * hl, device=dev)
        ch = (heads[:, None] * p + torch.arange(p, device=dev)).reshape(-1)
        cl = ch.numel()
        bc = torch.arange(2 * n, device=dev) + di
        in_proj = whole(in_proj, w_specs[0], 1)
        cols = torch.cat([ch, di + ch, di + bc, 2 * di + 2 * n + heads])
        z, xo, bcs, dt_raw = (xl @ in_proj[:, cols]).split(
            [cl, cl, 2 * n, hl], dim=-1)
        conv = torch.cat([ch, bc])
        xc = M._causal_conv(torch.cat([xo, bcs], dim=-1),
                            whole(conv_w, w_specs[1], 1)[:, conv],
                            whole(conv_b, w_specs[2], 0)[conv])
        y, state = M.ssd_scan(xc, dt_raw, a_log[heads], dt_bias[heads],
                              d_skip[heads], n, cfg.ssd_chunk)
        g = y.reshape(b, s, cl) * F.silu(z.float())
        sumsq = (g * g).sum(-1, keepdim=True)
        if split:
            sumsq = C.all_reduce_sum(sumsq, group)
        g = g * torch.rsqrt(sumsq / di + cfg.norm_eps) * \
            (1.0 + whole(norm, w_specs[6], 0)[ch].float())
        own = split and w_specs[7][0]       # out_proj's rows are the heads'
        w_out = out_proj if own else whole(out_proj, w_specs[7], 0)[ch]
        out = g.to(xl.dtype) @ w_out
        if out_sq and split:
            out = C.reduce_scatter_seq(out, 1, group)
        elif out_sq:
            sl = s // m
            out = out[:, mesh.get_local_rank(ax) * sl:][:, :sl]
        if not return_final_state:
            return out
        wc = cfg.conv_width - 1
        with torch.no_grad():
            tail = M._conv_tail(xl[:, s - wc:] @ in_proj[:, di:2 * di + 2 * n],
                                cfg)
        return out, state, tail

    if out_sq:
        out_p = SH.placements((bq, ax, None), mesh)
    else:
        out_p = SH.placements((bq, None, None), mesh, (ax,))
    outs = [out_p]
    if return_final_state:
        outs += [SH.placements((bq, ax if split else None, None, None),
                               mesh), SH.placements((bq, None, None), mesh)]
    x_grad = SH.placements(x_spec, mesh, () if sq else (ax,))
    fn = local_map(body, out_placements=tuple(outs) if return_final_state
                   else list(outs[0]),
                   in_placements=(SH.placements(x_spec, mesh),
                                  *(SH.placements(sp, mesh)
                                    for sp in w_specs)),
                   in_grad_placements=(x_grad, *w_grads),
                   redistribute_inputs=True, device_mesh=mesh)
    res = fn(x, *ws)
    if not return_final_state:
        return res
    out, state, tail = res
    return out, (state, tail)


def _vocab_nll(wl, x, labels, v0: int, cfg, group):
    """The summed CE of x [B, c, D] against labels [B, c] with this rank's
    block of the vocab, wl [D, V/m] from row v0: the log-sum-exp and the
    gold logit summed over the ranks' blocks (Megatron's vocab-parallel
    cross-entropy)."""
    logits = L.unembed_logits(x, wl, cfg)                      # [B, c, V/m]
    top = C.all_reduce_max(logits.amax(-1), group)
    lse = top + torch.log(C.all_reduce_sum(
        torch.exp(logits - top[..., None]).sum(-1), group))
    n = logits.shape[-1]
    i = labels.long() - v0
    hit = (i >= 0) & (i < n)
    gold = torch.where(hit, torch.gather(logits, -1, i.clamp(0, n - 1)[
        ..., None])[..., 0], 0.0)
    return torch.sum(lse - C.all_reduce_sum(gold, group))


def _sharded_nll(plain, w, x, labels, cfg, c: int):
    """`model.nll_sum` (the chunked CE) on x [B, S, D] with its sequence on
    the sequence axis, as `constrain_ce` places the chunks' logits:
      * where the vocab divides the tensor-parallel axis, each chunk's
        positions whole and the vocab split: the sequence is all-gathered
        and each rank computes the chunks' logits for its block of the
        vocab (`_vocab_nll`), every rank then holding the same sum;
      * where it does not, the chunks' sequence on the axis: each rank sums
        the CE of its own positions, in chunks of c / axis size (the
        [B, c / axis, V] logits a rank holds in the reference), with the
        unembedding whole.
    The sums are all-reduced (each rank hands in its own, or 1/m of the
    common one, as a partial sum)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    from torch.utils.checkpoint import checkpoint

    mesh, r = _ambient()
    ax = r.seq_axis
    if not _on_axis(x, mesh, ax, 1):
        return plain(w, x, labels, cfg, c)
    bq = SH._fit(x.shape[0], mesh, r.batch_axes)
    group = mesh.get_group(ax)
    m = SH.axis_size(mesh, ax)
    vt = SH._fit(w.shape[1], mesh, r.tp_axis)
    batch = _axes(bq)
    x_spec = (bq, ax, None)
    w_spec = (None, vt)
    l_spec = (bq, None if vt else ax)

    def body(wl, xl, ll):
        if vt is None:
            return plain(wl, xl, ll, cfg, c // m if c % m == 0 else
                         xl.shape[1])
        xs = C.gather_seq(xl, 1, group)
        v0 = mesh.get_local_rank(vt) * wl.shape[1]
        total = torch.zeros((), dtype=torch.float32, device=xs.device)
        for c0 in range(0, xs.shape[1], c):
            total = total + checkpoint(_vocab_nll, wl, xs[:, c0:c0 + c],
                                       ll[:, c0:c0 + c], v0, cfg, group,
                                       use_reentrant=False)
        return total / m

    fn = local_map(
        body, out_placements=list(SH.placements((), mesh, batch + (ax,))),
        in_placements=(SH.placements(w_spec, mesh),
                       SH.placements(x_spec, mesh),
                       SH.placements(l_spec, mesh)),
        in_grad_placements=(SH.placements(w_spec, mesh, batch + (
            () if vt else (ax,))), SH.placements(x_spec, mesh),
            SH.placements(l_spec, mesh)),
        redistribute_inputs=True, device_mesh=mesh)
    return fn(w, x, labels).redistribute(mesh, [Replicate()] * mesh.ndim)


def _sharded_last(plain, hidden):
    """`decode.last_position` of hidden [B, S, D] with its sequence on the
    sequence axis: the last rank's last row, gathered to every rank."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    ax = r.seq_axis
    if not _on_axis(hidden, mesh, ax, 1):
        return plain(hidden)
    bq = SH._fit(hidden.shape[0], mesh, r.batch_axes)
    group = mesh.get_group(ax)
    return local_map(
        lambda t: C.gather_seq(t[:, -1:], 1, group)[:, -1:],
        out_placements=list(SH.placements((bq, None, None), mesh)),
        in_placements=(SH.placements((bq, ax, None), mesh),),
        redistribute_inputs=True, device_mesh=mesh)(hidden)


def _sharded_ring_pack(plain, k, wc: int):
    """`decode._ring_pack` of prefill's keys or values [L, B, S, K, h] with
    the sequence on the sequence axis: each rank puts its positions among
    the last `wc` into their ring slots (position % wc) of a zero ring,
    and the rings are summed over the axis (an all-reduce: each slot comes
    from one rank)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    ax = r.seq_axis
    dim = k.ndim - 3
    if not _on_axis(k, mesh, ax, dim):
        return plain(k, wc)
    spec = list(_spec_of(k))
    s = k.shape[dim]

    def body(kl):
        nl = kl.shape[dim]
        off = mesh.get_local_rank(ax) * nl
        lo, hi = max(s - wc, off), off + nl           # this rank's kept
        ring = kl.new_zeros(kl.shape[:dim] + (wc,) + kl.shape[dim + 1:])
        if lo < hi:
            slots = torch.arange(lo, hi, device=kl.device) % wc
            ring.index_copy_(dim, slots, kl.narrow(dim, lo - off, hi - lo))
        return ring

    ring_spec = list(spec)
    ring_spec[dim] = None
    ring = local_map(body, out_placements=list(SH.placements(
        ring_spec, mesh, (ax,))), in_placements=(SH.placements(spec, mesh),),
        redistribute_inputs=True, device_mesh=mesh)(k)
    return ring.redistribute(mesh, [Replicate() if i == mesh.mesh_dim_names
                                    .index(ax) else p for i, p in
                                    enumerate(ring.placements)])


def _spec_of(t) -> tuple:
    """DTensor t's spec (see `parallel.sharding`): for each dim None, the
    mesh axis sharding it, or those axes in mesh order. A Partial or an
    uneven (strided) shard is a layout no decode body takes: it raises."""
    from torch.distributed.tensor import Shard
    spec = [[] for _ in range(t.ndim)]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if p.is_replicate():
            continue
        if type(p) is not Shard:
            raise ValueError(f"decode on a mesh: placement {p} of a "
                             f"{tuple(t.shape)} tensor is not taken")
        spec[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)


def _kv_spec(kc, vc) -> tuple:
    """The spec of a layer's K and V caches [B, S, K, h] (one for both)."""
    spec = _spec_of(kc)
    if _spec_of(vc) != spec:
        raise ValueError(f"decode on a mesh: k cache {spec}, v cache "
                         f"{_spec_of(vc)}")
    return spec


def _axis(spec_entry, what: str):
    """The one mesh axis of a cache dim a decode body communicates over."""
    if spec_entry is not None and not isinstance(spec_entry, str):
        raise ValueError(f"decode on a mesh: the cache's {what} is sharded "
                         f"over {spec_entry}; the bodies take one axis")
    return spec_entry


def _replicated(t, mesh):
    """A plain tensor made on every rank alike (the encoder memory's
    lengths) as a replicated DTensor; a DTensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _offset(mesh, axis: str, n: int) -> int:
    """The first position of this rank's block of n along `axis`."""
    return mesh.get_local_rank(axis) * n


def _sharded_write_kv(plain, ck, cv, k_new, v_new, slot):
    """`write_kv` on caches [B, S, K, h] placed by `cache_specs`: each rank
    writes its block (batch on the batch axes, KV heads or head_dim on
    `model`), no communication. Where the sequence is sharded, only the
    rank whose block holds a row's slot changes it: the others write that
    row's old values back, so their caches stay as they were bit for
    bit."""
    from torch.distributed.tensor.experimental import local_map

    mesh = ck.device_mesh
    bx, sx, kx, hx = spec = _kv_spec(ck, cv)
    sx = _axis(sx, "sequence")

    def body(ckl, cvl, kl, vl, sl):
        if sx is None:
            plain(ckl, cvl, kl, vl, sl)
            return ckl, cvl
        n = ckl.shape[1]
        at = sl.long() - _offset(mesh, sx, n)
        own = ((at >= 0) & (at < n))[:, None, None]
        at = at.clamp(0, n - 1)
        rows = torch.arange(ckl.shape[0], device=ckl.device)
        for cache, new in ((ckl, kl), (cvl, vl)):
            cache[rows, at] = torch.where(own, new[:, 0], cache[rows, at])
        return ckl, cvl

    cache_p = SH.placements(spec, mesh)
    new_p = SH.placements((bx, None, kx, hx), mesh)
    local_map(body, out_placements=(cache_p, cache_p),
              in_placements=(cache_p, cache_p, new_p, new_p,
                             SH.placements((bx,), mesh)),
              redistribute_inputs=True, device_mesh=mesh)(
        ck, cv, k_new, v_new, slot)


def _head_dim_attention(ql, kl, vl, ll, hd: int, logit_cap: float, group,
                        return_lse: bool):
    """Decode attention on a block whose head_dim is one shard of `group`:
    the partial scores are summed over the group before the scale, the
    cap, the mask and the softmax (what the reference's einsum gets from
    GSPMD), and p.V stays on this rank's head_dim. Plain PyTorch on every
    device: no kernel computes partial scores."""
    import torch.distributed._functional_collectives as fc
    from repro_torch.kernels import decode_attn as DA

    b, _, hq, hl = ql.shape
    hk = kl.shape[2]
    part = torch.einsum("bkgh,bskh->bkgs",
                        ql.reshape(b, hk, hq // hk, hl).float(), kl.float())
    scores = fc.wait_tensor(fc.all_reduce(part, "sum", group))
    res = DA.attend(scores * hd ** -0.5, vl, ll, logit_cap=logit_cap,
                    dtype=torch.float32 if return_lse else ql.dtype,
                    return_lse=return_lse)
    if not return_lse:
        return res.reshape(b, 1, hq, hl)
    return res[0].reshape(b, 1, hq, hl), res[1].reshape(b, 1, hq)


def _sharded_decode_attention(plain, q, kc, vc, clen, *, logit_cap=0.0):
    """`decode_attention` of q [B, 1, H, h] on caches [B, S, K, h] placed
    by `cache_specs`, one body per layout:
      * batch and/or KV heads sharded: each rank attends on its block
        (`plain`: the kernel on a CUDA block, the plain form on a CPU one;
        q's heads follow their KV heads), no communication;
      * head_dim sharded: `_head_dim_attention`, the partial scores
        all-reduced over that axis;
      * sequence sharded: each rank attends over its positions with its
        own cache_len (0 where its block lies past it), giving its output
        and log-sum-exp, and `layers.combine_partials` combines the
        all-gathered partials over the sequence axis. With head_dim also
        sharded the two compose.
    The result keeps q's batch and the cache's KV-head or head_dim
    sharding."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor.experimental import local_map

    mesh = kc.device_mesh
    bx, sx, kx, hx = spec = _kv_spec(kc, vc)
    sx, hx = _axis(sx, "sequence"), _axis(hx, "head_dim")
    hd = q.shape[-1]

    def body(ql, kl, vl, ll):
        if sx is not None:
            n = kl.shape[1]
            ll = (ll - _offset(mesh, sx, n)).clamp(0, n).to(torch.int32)
        lse = sx is not None
        if hx is None:
            res = plain(ql, kl, vl, ll, logit_cap=logit_cap, return_lse=lse)
        else:
            res = _head_dim_attention(ql, kl, vl, ll, hd, logit_cap,
                                      mesh.get_group(hx), lse)
        if sx is None:
            return res
        group = mesh.get_group(sx)
        outs, lses = (fc.wait_tensor(fc.all_gather_single(t[None], 0, group))
                      for t in res)
        return L.combine_partials(outs, lses, ql.dtype)

    q_p = SH.placements((bx, None, kx, hx), mesh)
    cache_p = SH.placements(spec, mesh)
    fn = local_map(body, out_placements=list(q_p),
                   in_placements=(q_p, cache_p, cache_p,
                                  SH.placements((bx,), mesh)),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(q, kc, vc, _replicated(clen, mesh))


def _sharded_ssm_recur(plain, state, xs, dt, a, bmat, cmat):
    """`ssm_recur` on the state [B, H, P, N] placed by `cache_specs`
    (batch on the batch axes, or heads on `data` at batch 1, and `model`
    on P, else N, else H): the update is elementwise in (b, h, p, n), so
    each rank runs it on its block, with x, dt, a, B and C cut to match;
    the read-out y [B, H, P] is a partial sum where N is sharded, and is
    returned whole over P and N. The new state keeps the cache's
    placements, so the write-back is a local copy."""
    from torch.distributed.tensor.experimental import local_map

    mesh = state.device_mesh
    bx, hx, px, nx = spec = _spec_of(state)
    nx = _axis(nx, "state dim")
    y_p = SH.placements((bx, hx, px), mesh, (nx,) if nx else ())
    fn = local_map(
        plain, out_placements=(y_p, SH.placements(spec, mesh)),
        in_placements=tuple(SH.placements(sp, mesh) for sp in (
            spec, (bx, hx, px), (bx, hx), (hx,), (bx, nx), (bx, nx))),
        redistribute_inputs=True, device_mesh=mesh)
    y, new = fn(state, xs, dt, a, bmat, cmat)
    # whole over P (and summed over N): the gated norm reads y as [B, H*P]
    return y.redistribute(mesh, SH.placements((bx, hx, None), mesh)), new


def _sharded_moe_ffn(params, x, cfg):
    """`moe_ffn` on DTensors, where `moe_ffn_a2a` hands off to it (decode:
    one token a row does not divide over `model`): the tokens gathered
    whole on every rank and routed there as `moe_ffn` routes them (the
    capacity of the global token count), each `model` rank running the
    experts it owns on its slice of the dispatch buffer (their weights
    gathered over the fsdp axes), and the ranks' contributions summed over
    `model`."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = _ambient()
    e = cfg.n_experts
    tp = r.tp_axis if SH._fit(e, mesh, r.tp_axis) else None

    def body(xl, router, wg, wi, wo):
        b, s, d = xl.shape
        t = b * s
        c = MOE.capacity(cfg, t)
        xf = xl.reshape(t, d)
        gates, order, _, tok_sorted, slot, keep = MOE._route(router, xf, cfg,
                                                             c)
        buf = MOE._dispatch(xf, slot, tok_sorted, e * c).reshape(e, c, d)
        first = mesh.get_local_rank(tp) * wg.shape[0] if tp else 0
        mine = slice(first, first + wg.shape[0])
        out = torch.zeros_like(buf)
        out[mine] = MOE._experts(buf[mine], wg, wi, wo)
        return MOE._combine(out.reshape(e * c, d), gates, order, slot, keep,
                            t).reshape(b, s, d)

    whole = SH.placements((None, None, None), mesh)
    experts = SH.placements((tp, None, None), mesh)
    fn = local_map(
        body, out_placements=list(SH.placements((None, None, None), mesh,
                                                (tp,) if tp else ())),
        in_placements=(whole, SH.placements((None, None), mesh), experts,
                       experts, experts),
        redistribute_inputs=True, device_mesh=mesh)
    return fn(x, params.router, params.wg, params.wi, params.wo)


def _masked_gold(logits, labels):
    """`model._gold` by a masked sum: DTensor's gather over a sharded
    vocab fails (its masked partial result takes the index's placement for
    the output's); the sum gives the same value."""
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)


@contextlib.contextmanager
def sharded_forwards():
    """Within the block, the token embedding (`lookup`), the layers'
    projections (`project`, `_out`), the MLP (`_mlp`), `flash_attention`,
    the SSD mixer (`ssm_forward`), the embedding's constraint
    (`constrain_batch`), the chunked CE
    (`model.nll_sum`) and its label pick (`model._gold`), prefill's last
    position and ring packing, and the decode step's bodies take their
    DTensor versions when handed DTensors; restored on exit."""
    from torch.distributed.tensor import DTensor
    plain = {(L, "lookup"): L.lookup,
             (L, "project"): L.project, (L, "_out"): L._out,
             (L, "_mlp"): L._mlp, (L, "flash_attention"): L.flash_attention,
             (M, "ssm_forward"): M.ssm_forward,
             (SH, "constrain_batch"): SH.constrain_batch,
             (MODEL, "nll_sum"): MODEL.nll_sum, (MODEL, "_gold"): MODEL._gold,
             (D, "last_position"): D.last_position,
             (D, "_ring_pack"): D._ring_pack,
             (L, "decode_attention"): L.decode_attention,
             (D, "write_kv"): D.write_kv, (M, "ssm_recur"): M.ssm_recur,
             (MOE, "moe_ffn"): MOE.moe_ffn}

    def on_dtensor(key, sharded):
        def fn(*args, **kw):
            if any(isinstance(t, DTensor) for t in (*args, *kw.values())):
                return sharded(*args, **kw)
            return plain[key](*args, **kw)
        return fn
    swaps = {
        (L, "lookup"): lambda t, ids: _sharded_lookup(plain[L, "lookup"], t,
                                                      ids),
        (L, "project"): lambda x, w: _tensor_parallel(
            plain[L, "project"], x, (w,), (1,), w.shape[1], out_dim=2,
            out_ndim=4),
        (L, "_out"): lambda o, wo: _tensor_parallel(
            plain[L, "_out"], o, (wo,), (0,), wo.shape[0], a_dim=2),
        (L, "_mlp"): lambda x, *w: _tensor_parallel(
            plain[L, "_mlp"], x, w, (1, 1, 0), w[0].shape[1]),
        (L, "flash_attention"): lambda q, k, v, **kw: _sharded_attention(
            plain[L, "flash_attention"], q, k, v, **kw),
        (M, "ssm_forward"): lambda *a, **kw: _sharded_ssm(
            plain[M, "ssm_forward"], *a, **kw),
        (SH, "constrain_batch"): lambda *a: _scatter_sequence(
            plain[SH, "constrain_batch"], *a),
        (MODEL, "nll_sum"): lambda *a: _sharded_nll(
            plain[MODEL, "nll_sum"], *a),
        (MODEL, "_gold"): _masked_gold,
        (D, "last_position"): lambda h: _sharded_last(
            plain[D, "last_position"], h),
        (D, "_ring_pack"): lambda k, wc: _sharded_ring_pack(
            plain[D, "_ring_pack"], k, wc),
        (L, "decode_attention"): lambda q, k, v, n, **kw:
            _sharded_decode_attention(plain[L, "decode_attention"], q, k, v,
                                      n, **kw),
        (D, "write_kv"): lambda *a: _sharded_write_kv(plain[D, "write_kv"],
                                                      *a),
        (M, "ssm_recur"): lambda *a: _sharded_ssm_recur(
            plain[M, "ssm_recur"], *a),
        (MOE, "moe_ffn"): _sharded_moe_ffn,
    }
    try:
        for key, sharded in swaps.items():
            setattr(*key, on_dtensor(key, sharded))
        yield
    finally:
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)


# ------------------------------------------------------------- the counters

def _collective_kinds() -> dict:
    ops = {}
    for ns in ("_c10d_functional", "_c10d_functional_autograd"):
        lib = getattr(torch.ops, ns)
        for name, kind in (("all_gather_into_tensor", "all-gather"),
                           ("all_reduce", "all-reduce"),
                           ("reduce_scatter_tensor", "reduce-scatter"),
                           ("all_to_all_single", "all-to-all")):
            if hasattr(lib, name):
                ops[getattr(lib, name)] = (ns, kind)
    return ops


class Tally(TorchDispatchMode):
    """What one rank does in the ops run under it: FLOPs, collective bytes
    by kind, and the peak bytes of the storages the ops allocate that are
    alive at once. An op on DTensors is handed on (NotImplemented), so
    DTensor runs it as this rank's local ops and collectives, which come
    back through here: every count is of local tensors. The global-shape
    ops DTensor runs to infer an output's shape (its sharding
    propagation, cached after the first time) are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.collectives = _collective_kinds()
        self.flops = 0.0
        self.coll: dict = defaultdict(int)
        self.live: dict = {}          # id(storage) -> weakref to it
        self.bytes = self.peak = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        self._meta = SP._propagate_tensor_meta_non_cached
        self.paused = 0

        def meta(prop, schema):
            self.paused += 1
            try:
                return self._meta(prop, schema)
            finally:
                self.paused -= 1
        SP._propagate_tensor_meta_non_cached = meta
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        SP._propagate_tensor_meta_non_cached = self._meta
        return super().__exit__(*exc)

    def _free(self, key: int, n: int):
        self.live.pop(key, None)
        self.bytes -= n

    def _hold(self, t):
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if id(st) in self.live:
            return
        n = st.nbytes()
        self.live[id(st)] = weakref.ref(
            st, lambda _, k=id(st), n=n: self._free(k, n))
        self.bytes += n
        self.peak = max(self.peak, self.bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs,
                                                out_val=out)
        # a view or an in-place result allocates nothing: its storage is an
        # input's (an argument of the step, such as a cache, or counted)
        given = {id(t.untyped_storage()) for t in
                 torch.utils._pytree.tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)}
        seen = self.collectives.get(packet)
        # the autograd collectives dispatch the plain ones: count those
        if seen is not None and seen[0] == "_c10d_functional":
            self.coll[seen[1]] += out.numel() * out.element_size()
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and \
                    id(t.untyped_storage()) not in given:
                self._hold(t)
        return out


def _aten_op(exc: BaseException) -> str | None:
    """The aten op an error names, if any: the one DTensor's sharding
    propagation failed for, else the first named."""
    for pattern in (r"propagation failed for (aten\.[\w.]+)",
                    r"(aten\.[\w.]+)"):
        for e in (exc, exc.__cause__, exc.__context__):
            m = e and re.search(pattern, str(e))
            if m:
                return m.group(1)
    return None


# ------------------------------------------------------------- cell running

def _step(cfg, cell, shape: str, mesh, rules, ocfg) -> dict:
    """One run of the cell's step at `cfg`'s depth: its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        model = shard_model(MODEL.Model(cfg, device="cpu"), cfg, mesh,
                            rules)
        inputs = _inputs(cfg, shape, mesh, rules)
        args = [model]
        if cell.kind == "train":
            opt = init_opt_state(model, ocfg)
            fn = make_train_step(cfg, ocfg)
            args += [opt, inputs]
        elif cell.kind == "prefill":
            fn = make_prefill_step(cfg, ctx_len=cell.seq_len)
            args += [inputs]
        else:
            fn = make_decode_step(cfg)
            cache = D.init_cache(cfg, cell.global_batch, cell.seq_len,
                                 enc_len=min(cell.seq_len, 32768))
            args += [shard_cache(cache, mesh, rules), inputs["tokens"],
                     inputs["positions"]]
        tally = Tally()
        with on_mesh(mesh, rules), tally:
            fn(*args)
    return {"flops": tally.flops, "coll": dict(tally.coll),
            "step_bytes": tally.peak}


def _extrapolate(p1: dict, p2: dict, n: int) -> dict:
    def est(a, b):
        return max(a + (n - 1) * (b - a), a)
    kinds = sorted(set(p1["coll"]) | set(p2["coll"]))
    return {
        "flops_per_rank_est": est(p1["flops"], p2["flops"]),
        "step_peak_bytes_per_rank_est": int(est(p1["step_bytes"],
                                                p2["step_bytes"])),
        "collective_bytes_per_rank_est": {
            k: int(est(p1["coll"].get(k, 0), p2["coll"].get(k, 0)))
            for k in kinds},
    }


def held_bytes(cfg, full: nn.Module, shape: str, mesh, rules,
               ocfg) -> dict:
    """What one rank holds of a cell's arguments at full depth (`full`:
    the model's parameters, on the meta device), from their placements:
    `param_bytes_per_rank`, and `grad_bytes_per_rank` and
    `moment_bytes_per_rank` (train) or `cache_bytes_per_rank` (decode)."""
    cell = SHAPES[shape]
    named = dict(full.named_parameters())
    specs = SH.param_specs(cfg, {n: tuple(p.shape) for n, p in
                                 named.items()}, mesh, rules)
    out = {"param_bytes_per_rank": _bytes_per_rank(named, specs, mesh)}
    if cell.kind == "train":
        out["grad_bytes_per_rank"] = out["param_bytes_per_rank"]
        mbytes = 2 if ocfg.moment_dtype == "bfloat16" else 4
        out["moment_bytes_per_rank"] = 2 * mbytes * sum(
            _local_numel(p.shape, specs[n], mesh) for n, p in named.items())
    if cell.kind == "decode":
        cache = D.init_cache(cfg, cell.global_batch, cell.seq_len,
                             enc_len=min(cell.seq_len, 32768), device="meta")
        out["cache_bytes_per_rank"] = _bytes_per_rank(
            cache, SH.cache_specs(cache, mesh, rules), mesh)
    return out


def run_cell(arch: str, shape: str, multi_pod: bool, cfg=None) -> dict:
    """The record of one cell (`cfg` overrides the arch's config: tests
    run smoke configs). Raises when the step fails (`main` records it)."""
    rec = {"arch": arch, "shape": shape, "mesh": MESH.mesh_name(multi_pod),
           "status": "ok", "mesh_device": "cpu"}
    cfg = cfg or get_config(arch)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    cell = SHAPES[shape]
    full = MODEL.param_shapes(cfg)
    with MESH.production_mesh(multi_pod=multi_pod) as mesh:
        rules, ocfg = _setup(SH.AxisRules(), multi_pod, arch)
        rec.update(held_bytes(cfg, full, shape, mesh, rules, ocfg))
        probes = [_step(probe_cfg(cfg, b), cell, shape, mesh, rules, ocfg)
                  for b in (1, 2)]
        rec["n_devices"] = mesh.size()
    rec["fsdp_axes"] = list(rules.fsdp_axes)
    rec["seq_axis"] = rules.seq_axis
    rec["probe_bodies"] = {1: probes[0], 2: probes[1]}
    rec.update(_extrapolate(*probes, n_bodies(cfg)))
    rec["bytes_per_rank_est"] = rec["step_peak_bytes_per_rank_est"] + sum(
        rec.get(k, 0) for k in ("param_bytes_per_rank",
                                "moment_bytes_per_rank",
                                "cache_bytes_per_rank"))
    rec["params_total"] = count_params(full)
    rec["params_active"] = active_params(cfg, full)
    rec["model_flops"] = model_flops(cfg, full, shape)
    return rec


def error_record(arch: str, shape: str, multi_pod: bool,
                 exc: BaseException) -> dict:
    return {"arch": arch, "shape": shape, "mesh": MESH.mesh_name(multi_pod),
            "status": "error", "mesh_device": "cpu",
            "error": f"{type(exc).__name__}: {str(exc)[:500]}",
            "op": _aten_op(exc),
            "traceback": traceback.format_exc()[-2000:]}


def append_result(rec: dict, out: pathlib.Path):
    """Write `rec` into the JSON list at `out`, replacing the record of
    the same (arch, shape, mesh)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = json.loads(out.read_text()) if out.exists() else []
    rows = [r for r in rows if (r["arch"], r["shape"], r["mesh"]) !=
            (rec["arch"], rec["shape"], rec["mesh"])]
    rows.append(rec)
    out.write_text(json.dumps(rows, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=[a.replace("_", "-") for a in ARCHS])
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    if args.all:
        cells = [(a.replace("_", "-"), s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    mesh_name = MESH.mesh_name(args.multi_pod)
    done = set()
    if args.skip_done and out.exists():
        done = {(r["arch"], r["shape"]) for r in json.loads(out.read_text())
                if r["mesh"] == mesh_name and r["status"] in ("ok",
                                                              "skipped")}
    for arch, shape in cells:
        if (arch, shape) in done:
            print(f"[dryrun] {arch} x {shape}: already done, skipping")
            continue
        print(f"[dryrun] {arch} x {shape} multi_pod={args.multi_pod} ...",
              flush=True)
        try:
            rec = run_cell(arch, shape, args.multi_pod)
        except Exception as e:      # recorded, and the next cell runs
            rec = error_record(arch, shape, args.multi_pod, e)
        append_result(rec, out)
        msg = {k: v for k, v in rec.items()
               if k not in ("traceback", "probe_bodies")}
        print(f"[dryrun] -> {json.dumps(msg)[:600]}", flush=True)


if __name__ == "__main__":
    main()

"""Multi-pod dry-run on the CPU: run every (arch x shape x mesh) cell's step
on DTensors of the production mesh, with no data (the JAX package's
`launch/dryrun.py`).

For each cell this shows that the sharding rules hold together at
production scale (every parameter, input and cache takes its placements,
the step runs on them) and records what a rank would hold, compute and
send. The mesh lives in a `fake` process group (`launch.mesh.fake_world`:
this process is rank 0 of 256 or 512) and every tensor is a `FakeTensor`
(`torch._subclasses.fake_tensor.FakeTensorMode`): shapes, dtypes and
placements, no storage. Nothing is timed and nothing is lowered.

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

Where the dry-run departs from the reference's policy:
  * sequence parallelism is off (`seq_axis` null): a matrix product over
    a (batch, sequence) flattening sharded on two mesh dims has no
    DTensor sharding rule. So the archs whose head counts do not divide
    over `model` (yi-34b, internvl2, llama4, hymba, seamless) replicate
    attention on every `model` rank, where the reference shards it by
    sequence: their FLOPs and bytes a rank describe that fallback;
  * the decode body for a cache whose head_dim is sharded (the partial
    scores all-reduced over `model`, `_head_dim_attention`) is plain
    PyTorch on every device: no kernel computes partial scores.

The decode step runs on the caches `cache_specs` places
(`_sharded_write_kv`, `_sharded_decode_attention`, `_sharded_ssm_recur`;
the MoE at one token a row through `_sharded_moe_ffn`); the SSD's chunked
scan of the train and prefill steps has no DTensor rule in some cells
(`aten.bmm` on strided shards: mamba2's train_4k, hymba's multi-pod
train_4k).

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


def _inputs(cfg, shape: str, mesh, rules) -> dict:
    specs = input_specs(cfg, shape)
    bspecs = SH.batch_specs(specs, mesh, rules)
    return {k: SH.distribute(torch.zeros(v.shape, dtype=v.dtype), mesh,
                           bspecs[k]) for k, v in specs.items()}


# ------------------------------------------------------- DTensor forwards
#
# DTensor has no sharding rule for some of the model's products: einsum
# flattenings of a sharded dim, uneven head splits, a gather over a
# vocab-sharded dim. While a cell runs, `sharded_forwards` swaps the
# layers' module functions for versions that run them as blocks under
# `local_map`; the model code keeps its one plain path.

def _tensor_parallel(fn, a, weights, w_dims, n: int, *, a_dim=None,
                     out_dim=None, out_ndim: int = 3):
    """`fn(a, *weights)` on DTensors as a Megatron tensor-parallel block:
    weight i split over the tensor-parallel axis at dim `w_dims[i]`, `a`
    at `a_dim` (None: whole on every rank of the axis), the result at
    `out_dim` (None: each rank's partial sum, reduced later). `n` is the
    size the axis splits (heads, d_ff): where it does not divide, the axis
    replicates the block. Batch goes on the batch axes, the weights are
    gathered over the others, and each rank runs `fn` on its own block."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = SH._ambient()
    tp = r.tp_axis if SH._fit(n, mesh, r.tp_axis) else None
    bq = SH._fit(a.shape[0], mesh, r.batch_axes)

    def spec(ndim, dim, first=None):
        out = [first] + [None] * (ndim - 1)
        if dim is not None:
            out[dim] = tp
        return tuple(out)
    a_spec = spec(a.ndim, a_dim, bq)
    w_specs = [spec(w.ndim, d) for w, d in zip(weights, w_dims)]
    by_tp = (tp,) if tp else ()
    batch = tuple(x for x in (bq if isinstance(bq, tuple) else (bq,)) if x)
    # a contraction over a split dim leaves each rank a partial sum: the
    # result when it is not split, the gradient of an `a` that is whole,
    # each weight's gradient over the batch axes
    fn = local_map(
        fn,
        out_placements=list(SH.placements(
            spec(out_ndim, out_dim, bq), mesh,
            by_tp if out_dim is None else ())),
        in_placements=(SH.placements(a_spec, mesh),
                       *(SH.placements(sp, mesh) for sp in w_specs)),
        in_grad_placements=(
            SH.placements(a_spec, mesh, by_tp if a_dim is None else ()),
            *(SH.placements(sp, mesh, batch) for sp in w_specs)),
        redistribute_inputs=True, device_mesh=mesh)
    return fn(a, *weights)


def _sharded_attention(flash, q, k, v, **kw):
    """`flash` (the plain `flash_attention`) on DTensors: each (batch,
    head) attends on its own, so every rank runs it on its block, batch on
    the batch axes and heads on the tensor-parallel axis. Where the KV
    heads do not divide over it but the query heads do, the KV heads stay
    whole and each rank takes the ones its query heads read; where the
    query heads do not divide either, the heads are replicated (every rank
    of the axis attends for all: the reference's sequence parallelism is
    off, see the module's docstring)."""
    from torch.distributed.tensor.experimental import local_map

    mesh, r = SH._ambient()
    hq, hk = q.shape[2], k.shape[2]
    tp = r.tp_axis if SH._fit(hq, mesh, r.tp_axis) else None
    kv_tp = tp if SH._fit(hk, mesh, tp) else None
    bq = SH._fit(q.shape[0], mesh, r.batch_axes)
    q_spec = (bq, None, tp, None)
    kv_spec = (bq, None, kv_tp, None)

    def body(ql, kl, vl):
        if tp is not None and kv_tp is None:
            # this rank's query heads and the KV head each one reads
            n = ql.shape[2]
            first = mesh.get_local_rank(tp) * n
            heads = torch.arange(first, first + n, device=ql.device)
            pick = heads // (hq // hk)
            kl, vl = kl[:, :, pick], vl[:, :, pick]
        return flash(ql, kl, vl, **kw)

    fn = local_map(body, out_placements=list(SH.placements(q_spec, mesh)),
                   in_placements=tuple(SH.placements(sp, mesh) for sp in
                                       (q_spec, kv_spec, kv_spec)),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(q, k, v)


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

    mesh, r = SH._ambient()
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
    """Within the block, the layers' projections (`project`, `_out`), the
    MLP (`_mlp`), `flash_attention` and the CE label pick (`model._gold`)
    take their DTensor versions when handed DTensors; restored on exit."""
    from torch.distributed.tensor import DTensor
    plain = {(L, "project"): L.project, (L, "_out"): L._out,
             (L, "_mlp"): L._mlp, (L, "flash_attention"): L.flash_attention,
             (MODEL, "_gold"): MODEL._gold,
             (L, "decode_attention"): L.decode_attention,
             (D, "write_kv"): D.write_kv, (M, "ssm_recur"): M.ssm_recur,
             (MOE, "moe_ffn"): MOE.moe_ffn}

    def on_dtensor(key, sharded):
        def fn(*args, **kw):
            if any(isinstance(t, DTensor) for t in args):
                return sharded(*args, **kw)
            return plain[key](*args, **kw)
        return fn
    swaps = {
        (L, "project"): lambda x, w: _tensor_parallel(
            plain[L, "project"], x, (w,), (1,), w.shape[1], out_dim=2,
            out_ndim=4),
        (L, "_out"): lambda o, wo: _tensor_parallel(
            plain[L, "_out"], o, (wo,), (0,), wo.shape[0], a_dim=2),
        (L, "_mlp"): lambda x, *w: _tensor_parallel(
            plain[L, "_mlp"], x, w, (1, 1, 0), w[0].shape[1]),
        (L, "flash_attention"): lambda q, k, v, **kw: _sharded_attention(
            plain[L, "flash_attention"], q, k, v, **kw),
        (MODEL, "_gold"): _masked_gold,
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
    from torch.distributed.tensor.experimental import implicit_replication

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
        with SH.activate(mesh, rules), implicit_replication(), \
                sharded_forwards(), tally:
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
        rules, ocfg = _setup(SH.AxisRules(seq_axis=None), multi_pod, arch)
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

"""Sharding policy: logical-axis rules -> a spec for every parameter, input
and cache, and the activation constraints (the JAX package's
`parallel/sharding.py`).

Mesh: a `torch.distributed.device_mesh.DeviceMesh` with named dims
(`pod`, `data`, `model`; `launch/mesh.py` builds them). Policy:

* **FSDP/ZeRO-3**: parameters and optimizer moments sharded over
  `fsdp_axes` (default `("data",)`; the giant MoEs widen it to
  `("pod", "data")`).
* **TP** over `model`: MLP d_ff, MoE experts (EP), vocab, and attention
  heads *when they divide*; the awkward head counts (yi-34b 56, internvl2
  14, hymba 25, llama4 40) keep their attention weights whole on `model`.
* **SP** (Megatron-style sequence parallelism, on by default: `seq_axis`
  "model"): the activations between layers keep their sequence on
  `model`. A column-parallel product all-gathers the sequence first and a
  row-parallel one reduce-scatters its partial sums back onto it; where
  the heads do not divide, each rank projects its own tokens and attends
  for its own block of queries over the gathered keys and values; the CE
  chunks fall back to the sequence on `model` where the vocab does not
  divide (`constrain_ce`). The bodies are `launch/dryrun.py`'s
  `sharded_forwards`, the collectives `parallel/collectives.py`'s.
* **Batch** over (`pod`, `data`). `long_500k` (batch 1) shards the KV
  cache over `data` along the sequence instead.

Divisibility is always checked; a rule that does not divide falls back to
replication on that axis.

A spec is a tuple with one entry per tensor dim, as a `PartitionSpec` is:
`None`, a mesh-axis name, or a tuple of names (one dim sharded over
several mesh dims, in mesh order: major to minor). `placements` turns it
into DTensor placements, one per mesh dim. The port's layers are separate
modules, not a scan stack, so a spec has no leading scan entry, and
`param_specs` is keyed by `named_parameters()` names: it takes the config
and `{name: shape}`, and imports nothing of `models` or `configs`.

The constraints (`constrain`, `constrain_batch`, `constrain_ce`,
`constrain_spec`) return their input itself when no mesh is ambient or the
input is not a DTensor; on a mesh they redistribute it to the spec's
placements. `activate(mesh, rules)` makes a mesh ambient for the model
code, which stays mesh-agnostic: the constraints and `moe_ffn_a2a` read
it, nothing else in `models/` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class AxisRules:
    batch_axes: tuple = ("pod", "data")
    fsdp_axes: tuple = ("data",)
    tp_axis: str = "model"
    seq_axis: str = "model"     # sequence parallelism axis (attention)

    def present(self, mesh) -> "AxisRules":
        names = mesh.mesh_dim_names
        return AxisRules(
            batch_axes=tuple(a for a in self.batch_axes if a in names),
            fsdp_axes=tuple(a for a in self.fsdp_axes if a in names),
            tp_axis=self.tp_axis if self.tp_axis in names else None,
            seq_axis=self.seq_axis if self.seq_axis in names else None,
        )


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(axis_size(mesh, a) for a in axes) if axes else 1


def _fit(dim: int, mesh, axes):
    """axes if they divide dim, else None (replicate)."""
    if axes is None:
        return None
    n = _size(mesh, axes)
    if n > 1 and dim % n == 0:
        return axes if isinstance(axes, str) else tuple(axes)
    return None


def placements(spec, mesh, partial=()) -> tuple:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh dim
    named at tensor dim d, `Partial()` on those named in `partial`,
    `Replicate()` on the others. A dim sharded over several mesh dims
    must name them in mesh order."""
    names = mesh.mesh_dim_names
    out = [Partial() if a in partial else Replicate() for a in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"named twice")
            out[i] = Shard(d)
    return tuple(out)


def param_specs(cfg, shapes: dict, mesh, rules: AxisRules) -> dict:
    """{name: spec} for `shapes` ({`named_parameters()` name: shape}),
    with the JAX package's path rules applied to the names."""
    r = rules.present(mesh)
    tp, fsdp = r.tp_axis, (r.fsdp_axes or None)

    def spec_for(path: str, dims: tuple) -> tuple:
        leaf = path.rsplit(".", 1)[-1]

        def mk(*entries):
            out = [None] * len(dims)
            for i, ax in enumerate(entries):
                if i < len(dims):
                    out[i] = _fit(dims[i], mesh, ax)
            return tuple(out)

        if leaf == "table":                       # [V, D]
            return mk(tp, fsdp)
        if leaf == "unembed":                     # [D, V]
            return mk(fsdp, tp)
        if leaf in ("wq", "wk", "wv"):            # [D, N, h]
            if _fit(dims[1], mesh, tp):
                return mk(fsdp, tp, None)
            # The awkward head counts replicate over `model` rather than
            # shard head_dim (which would contract attention over a
            # sharded dim); the reference's sequence parallelism shards
            # the compute.
            return mk(fsdp, None, None)
        if leaf == "wo" and len(dims) == 3 and "attn" in path:  # [N, h, D]
            if _fit(dims[0], mesh, tp):
                return mk(tp, None, fsdp)
            return mk(None, None, fsdp)
        if leaf == "router":                      # [D, E]
            return mk(fsdp, None)
        if leaf in ("wg", "wi") and len(dims) == 3:   # moe [E, D, F]
            return mk(tp, fsdp, None)
        if leaf == "wo" and len(dims) == 3:           # moe [E, F, D]
            return mk(tp, None, fsdp)
        if leaf in ("wg", "wi"):                  # mlp [D, F]
            return mk(fsdp, tp)
        if leaf == "wo":                          # mlp [F, D]
            return mk(tp, fsdp)
        if leaf == "in_proj":                     # [D, X]
            return mk(fsdp, tp)
        if leaf == "out_proj":                    # [di, D]
            return mk(tp, fsdp)
        if leaf in ("conv_w", "conv_b"):          # [W, ch] / [ch]
            return mk(None, tp) if len(dims) == 2 else mk(tp)
        if leaf == "norm" and len(dims) == 1 and dims[0] > 8192:
            return mk(tp)
        return mk(*([None] * len(dims)))          # scalars / norms: replicate

    return {name: spec_for(name, tuple(shape))
            for name, shape in shapes.items()}


def batch_specs(inputs: dict, mesh, rules: AxisRules) -> dict:
    """Shard every input on its batch dim (dim 0), when divisible."""
    r = rules.present(mesh)

    def spec(shape):
        ax = _fit(shape[0], mesh, r.batch_axes)
        if ax is None and len(r.batch_axes) == 1:
            ax = _fit(shape[0], mesh, r.batch_axes[0])
        return (ax,) + (None,) * (len(shape) - 1)

    return {k: spec(tuple(v.shape)) for k, v in inputs.items()}


def cache_specs(cache_shapes: dict, mesh, rules: AxisRules,
                seq_shard_axis: str = "data") -> dict:
    """KV cache specs: batch over batch_axes when divisible, else sequence
    over `seq_shard_axis` (long_500k flash-decode mode). Layout:
    [L, B, S, K, h] / ssm [L, B, ...]. The KV caches also spread over the
    model axis: KV heads, then head_dim, then sequence."""
    r = rules.present(mesh)

    def spec(dims):
        out = [None] * len(dims)
        b = dims[1]
        bx = _fit(b, mesh, r.batch_axes) or _fit(
            b, mesh, r.batch_axes[-1:] if r.batch_axes else None)
        if bx is not None:
            out[1] = bx
        elif len(dims) >= 5:  # batch=1 kv cache: shard sequence instead
            out[2] = _fit(dims[2], mesh, seq_shard_axis)
        if len(dims) >= 5 and r.tp_axis:
            for dim in (3, 4, 2):
                if out[dim] is None and _fit(dims[dim], mesh, r.tp_axis):
                    out[dim] = r.tp_axis
                    break
        return tuple(out)

    return {k: spec(tuple(v.shape)) for k, v in cache_shapes.items()}


def constrain(x, mesh_or_none, spec):
    """Redistribute a DTensor to `spec` on the mesh; `x` itself off a mesh
    or when it is a plain tensor."""
    if mesh_or_none is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh_or_none, placements(spec, mesh_or_none))


# ----------------------------------------------- ambient activation sharding

_ACTIVE: list = []   # stack of (mesh, AxisRules)


class activate:
    """Context manager making a mesh ambient for model-code constraints:
    `constrain_batch` etc. are no-ops unless the model runs inside
    `with sharding.activate(mesh, rules):` (as `launch/dryrun.py` does)."""

    def __init__(self, mesh, rules: AxisRules):
        self.mesh, self.rules = mesh, rules.present(mesh)

    def __enter__(self):
        _ACTIVE.append((self.mesh, self.rules))
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def _ambient():
    return _ACTIVE[-1] if _ACTIVE else (None, None)


def _on_mesh(x):
    """The ambient (mesh, rules) when `x` is a DTensor, else None."""
    mesh, r = _ambient()
    if mesh is None or not isinstance(x, DTensor):
        return None
    return mesh, r


def constrain_batch(x, batch_dim: int = 0):
    """Constrain dim `batch_dim` to the batch axes (the rest replicated)."""
    amb = _on_mesh(x)
    if amb is None:
        return x
    mesh, r = amb
    ax = _fit(x.shape[batch_dim], mesh, r.batch_axes)
    if ax is None:
        return x
    spec = [None] * x.ndim
    spec[batch_dim] = ax
    return constrain(x, mesh, spec)


def constrain_ce(logits):
    """CE-chunk logits [B, c, V]: V on `model` when divisible, else the
    chunk (sequence) dim on `model`: either way no model rank replicates
    the unembedding."""
    amb = _on_mesh(logits)
    if amb is None:
        return logits
    mesh, r = amb
    b, c, v = logits.shape
    bx = _fit(b, mesh, r.batch_axes)
    if _fit(v, mesh, r.tp_axis):
        spec = (bx, None, r.tp_axis)
    else:
        spec = (bx, _fit(c, mesh, r.seq_axis), None)
    return constrain(logits, mesh, spec)


def constrain_spec(x, *logical):
    """Constrain with logical names: 'batch'|'fsdp'|'tp'|'seq'|None per
    dim."""
    amb = _on_mesh(x)
    if amb is None:
        return x
    mesh, r = amb
    name_map = {"batch": r.batch_axes, "fsdp": r.fsdp_axes,
                "tp": r.tp_axis, "seq": r.seq_axis}
    spec = [_fit(x.shape[dim], mesh, name_map.get(l) if l else None)
            for dim, l in enumerate(logical)]
    return constrain(x, mesh, spec)


def distribute(t: torch.Tensor, mesh, spec) -> DTensor:
    """`t` (the whole tensor, the same on every rank) as a DTensor with
    `spec`'s placements: each rank keeps its own shard, no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)

"""Carry state from the JAX package into the port, as numpy arrays.

Both packages can then compute on identical inputs: the graph, its ELL
tiles, a mid-search `BatchState` or `BFSState` or one rank's partitioned
stepper state (the BFS system has no
weights; the graph and the search state take their place), and the LLM
path's weights, caches (KV, SSM state and conv tail) and optimizer state.
Only numpy crosses over; this module imports nothing of the JAX package,
and loads the LLM modules only when weights, caches or optimizer state
are carried (the BFS side never needs them).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bfs import (BATCH_STATE_FIELDS, BFS_STATE_FIELDS,
                                  BatchState, BFSState)
from repro_torch.core.ell import EllBucket
from repro_torch.core.graph import Graph
from repro_torch.core.hybrid_bfs import HYBRID_STATE_FIELDS


def graph_from_arrays(num_vertices: int, indptr, indices,
                      degrees) -> Graph:
    """A `Graph` from CSR arrays (int64 indptr, int32 indices/degrees)."""
    g = Graph(int(num_vertices), np.asarray(indptr, dtype=np.int64),
              np.asarray(indices, dtype=np.int32),
              np.asarray(degrees, dtype=np.int32))
    g.validate()
    return g


def ell_from_arrays(buckets, device) -> tuple:
    """ELL tiles from `[(rows, deg, nbrs), ...]` numpy triples."""
    return tuple(
        EllBucket(rows=torch.from_numpy(np.array(rows, np.int32)).to(device),
                  deg=torch.from_numpy(np.array(deg, np.int32)).to(device),
                  nbrs=torch.from_numpy(np.array(nbrs, np.int32)).to(device))
        for rows, deg, nbrs in buckets)


def _state(cls, fields, arrays: dict, device):
    missing = [f for f in fields if f not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {missing}")
    return cls(*[torch.from_numpy(np.array(arrays[f])).to(device)
                 for f in fields])


def batch_state_from_arrays(arrays: dict, device) -> BatchState:
    """A `BatchState` from a dict of numpy arrays keyed by field name.

    The 20 fields are those of the JAX package's `BatchState.tree_flatten`,
    in that order (`BATCH_STATE_FIELDS`); each keeps its dtype (uint8
    flags, int32 ids and counters, bool masks).
    """
    return _state(BatchState, BATCH_STATE_FIELDS, arrays, device)


def bfs_state_from_arrays(arrays: dict, device) -> BFSState:
    """A single-root `BFSState` from a dict of numpy arrays keyed by field
    name: the 10 fields of the JAX package's `BFSState.tree_flatten`, in
    that order (`BFS_STATE_FIELDS`), each with its dtype."""
    return _state(BFSState, BFS_STATE_FIELDS, arrays, device)


def hybrid_state_from_arrays(arrays: dict, rank: int, device) -> dict:
    """Rank `rank`'s partitioned stepper state (`core.hybrid_bfs`) from the
    JAX package's `make_hybrid_stepper` state dict of numpy arrays: the
    11 fields of `HYBRID_STATE_FIELDS`, each with its dtype; the stacked
    `pcand` [n, v_pad] gives its row `rank`, the rank's own candidates."""
    missing = [f for f in HYBRID_STATE_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"hybrid stepper state fields missing: {missing}")
    out = {}
    for f in HYBRID_STATE_FIELDS:
        arr = np.array(arrays[f])
        if f == "pcand":
            arr = arr[rank]
        out[f] = torch.from_numpy(arr).to(device)
    return out


def _as(arr, dtype, device) -> torch.Tensor:
    """A numpy (or array-like, bf16 included) array as a `dtype` tensor,
    through float32, which holds every bf16 value exactly."""
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
        device=device, dtype=dtype)


def _stack_entry(cfg, tree: dict, stack: str, i: int):
    """The JAX tree's stack and index holding the port's layer i of
    `stack` ("layers" or "enc"): under `alt_dense_moe` dense layer 2j is
    entry j of `layers_dense`, MoE layer 2j+1 entry j of `layers_moe`;
    under encdec the decoder's layers are `dec`'s; else entry i of the
    stack of the same name."""
    if stack == "layers" and cfg.family == "moe" and cfg.alt_dense_moe:
        return tree["layers_dense" if i % 2 == 0 else "layers_moe"], i // 2
    if stack == "layers" and cfg.family == "encdec":
        return tree["dec"], i
    return tree[stack], i


def arrays_by_name(cfg, tree: dict, model) -> dict:
    """The numpy array of the JAX package's param-shaped pytree (the params,
    a moment, the gradients) for each of `model`'s `named_parameters()`:
    the layers' L axes split (`_stack_entry`), each checked against the
    parameter's shape."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "enc"):
            node, index = _stack_entry(cfg, tree, parts[0], int(parts[1]))
            parts = parts[2:]
        else:
            node, index = tree, None
        for part in parts:
            node = node[part]
        arr = node if index is None else np.asarray(node)[index]
        if tuple(np.shape(arr)) != tuple(p.shape):
            raise ValueError(f"{name}: shape {np.shape(arr)}, the port "
                             f"wants {tuple(p.shape)}")
        out[name] = arr
    return out


def params_from_arrays(cfg, tree: dict, device=None):
    """The port's `models.model.Model` from the JAX package's param pytree
    as nested dicts of numpy arrays: `embed.table` (and `embed.unembed`
    when the embeddings are untied), `final_norm`, and the layers stacked
    on a leading L axis (as `init_params` builds them: `layers`, or
    `layers_dense` and `layers_moe`, or encdec's `enc` and `dec` with
    `enc_norm`; the MoE experts on a second, E, axis). Each weight takes
    the dtype the port's module gives it: the config's, but fp32 for the
    MoE router and the SSM's `a_log`, `d_skip` and `dt_bias`, as in the
    JAX package."""
    from repro_torch.models import model as MODEL
    model = MODEL.Model(cfg, device=device)
    arrays = arrays_by_name(cfg, tree, model)
    for name, p in model.named_parameters():
        p.copy_(_as(arrays[name], p.dtype, device))
    return model


def opt_state_from_arrays(cfg, tree: dict, device=None) -> dict:
    """The port's optimizer state (`train.optimizer`: `m` and `v` keyed by
    parameter name, `step` int32) from the JAX package's `opt_state` as
    numpy arrays: its `m` and `v` param-shaped pytrees split as
    `params_from_arrays` splits the weights, each moment in its array's
    dtype (bfloat16 under `moment_dtype="bfloat16"`, else fp32)."""
    from repro_torch.models import model as MODEL
    shapes = MODEL.param_shapes(cfg)

    def moments(key):
        return {n: _as(a, torch.bfloat16 if str(np.asarray(a).dtype) ==
                       "bfloat16" else torch.float32, device)
                for n, a in arrays_by_name(cfg, tree[key], shapes).items()}
    return {"m": moments("m"), "v": moments("v"),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=device)}


def cache_from_arrays(cfg, tree: dict, device=None) -> dict:
    """A cache dict (`k`/`v`; `k_local`/`v_local`/`k_global`/`v_global`;
    `k_dense`/`v_dense`/`k_moe`/`v_moe`; `state`/`conv`, with `k`/`v` for
    the hybrid family; `k_self`/`v_self`/`k_cross`/`v_cross` for encdec)
    from numpy arrays: the JAX package's prefill or
    decode cache, to decode on from it. Each key takes the config's dtype,
    but the SSM `state` stays fp32, as in the JAX package."""
    from repro_torch.models import layers as L
    return {k: _as(v, torch.float32 if k == "state" else L.dtype_of(cfg),
                   device) for k, v in tree.items()}

"""Carry state from the JAX package into the port, as numpy arrays.

Both packages can then compute on identical inputs: the graph, its ELL
tiles, a mid-search `BatchState` or `BFSState` or one rank's partitioned
stepper state (the BFS system has no
weights; the graph and the search state take their place), and the LLM
serving path's weights and KV caches. Only numpy crosses over; this
module imports nothing of the JAX package, and loads the LLM modules only
when weights or caches are carried (the BFS side never needs them).
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


def params_from_arrays(cfg, tree: dict, device=None):
    """The port's `models.model.Model` from the JAX package's param pytree
    as nested dicts of numpy arrays: `embed.table`, `final_norm`, and
    `layers.*` stacked on a leading L axis (as `init_params` builds them),
    cast to the config's dtype."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as MODEL
    model = MODEL.Model(cfg, device=device)
    dt = L.dtype_of(cfg)
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            node, index = tree["layers"], int(parts[1])
            parts = parts[2:]
        else:
            node, index = tree, None
        for part in parts:
            node = node[part]
        arr = node if index is None else np.asarray(node)[index]
        if tuple(np.shape(arr)) != tuple(p.shape):
            raise ValueError(f"{name}: shape {np.shape(arr)}, the port "
                             f"wants {tuple(p.shape)}")
        p.copy_(_as(arr, dt, device))
    return model


def cache_from_arrays(cfg, tree: dict, device=None) -> dict:
    """A KV cache dict (`k`/`v`, or `k_local`/`v_local`/`k_global`/
    `v_global`) from numpy arrays, cast to the config's dtype: the JAX
    package's prefill or decode cache, to decode on from it."""
    from repro_torch.models import layers as L
    return {k: _as(v, L.dtype_of(cfg), device) for k, v in tree.items()}

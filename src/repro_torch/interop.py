"""Carry state from the JAX package into the port, as numpy arrays.

Both packages can then compute on identical inputs: the graph, its ELL
tiles and a mid-search `BatchState` or `BFSState` (this system has no
weights; the graph and the search state take their place). Only numpy
crosses over; this module imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bfs import (BATCH_STATE_FIELDS, BFS_STATE_FIELDS,
                                  BatchState, BFSState)
from repro_torch.core.ell import EllBucket
from repro_torch.core.graph import Graph


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

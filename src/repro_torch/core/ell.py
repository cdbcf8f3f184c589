"""Degree-bucketed ELL adjacency tiles: the kernels' graph format.

The kernels (`repro_torch.kernels`) want fixed-shape `[R, W]` neighbour
tiles, not ragged CSR. Rows are bucketed by degree class: bucket widths grow
geometrically from `base` and each row lands in the narrowest bucket that
fits. Within a bucket rows are sorted by descending degree, and every row
keeps its CSR slot order, which is what makes first-hit parents equal to a
CSR slab scan bit for bit.

Built on the host (numpy) once per graph, then moved to a device;
`GraphSession.ell_tiles` and `GraphSession.hybrid_ell` own the cache (and
`DeviceGraph` memoizes the tiles a one-shot `core.bfs.bfs()` builds). The
layout equals the JAX package's `core/ell.py` array for array.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_BASE = 32      # narrowest bucket width == one bottom-up slab
DEFAULT_GROWTH = 2     # geometric bucket-width growth factor


class EllBucket(NamedTuple):
    """One degree class as a fixed-shape tile.

    rows: int32[R] vertex ids (scatter targets; global new ids on the
      partitioned path, where padding rows carry the out-of-range id
      `v_pad` and degree 0).
    deg:  int32[R] true row degrees (0 < deg <= nbrs.shape[1] for real
      rows).
    nbrs: int32[R, W] neighbour ids in CSR slot order, 0-padded past deg.
    """
    rows: torch.Tensor
    deg: torch.Tensor
    nbrs: torch.Tensor


EllTiles = tuple  # tuple[EllBucket, ...]


def bucket_widths(max_degree: int, base: int = DEFAULT_BASE,
                  growth: int = DEFAULT_GROWTH) -> list[int]:
    """Ascending bucket widths covering degrees 1..max_degree."""
    widths = [base]
    while widths[-1] < max_degree:
        widths.append(widths[-1] * growth)
    return widths


def hub_width(hub_deg: int, base: int = DEFAULT_BASE,
              growth: int = DEFAULT_GROWTH) -> int:
    """Narrowest ladder width >= `hub_deg`: the hub side's first bucket."""
    w = base
    while w < hub_deg:
        w *= growth
    return w


def hub_degree_floor(hub_deg: int, base: int = DEFAULT_BASE,
                     growth: int = DEFAULT_GROWTH) -> int:
    """Degree floor T of the snapped hub threshold: a row is hub iff deg > T.

    T is the ladder width below `hub_width`, or 0 when `hub_deg` fits the
    base bucket (then every positive-degree row is hub).
    """
    w = hub_width(hub_deg, base, growth)
    return 0 if w == base else w // growth


def split_tiles(ell: EllTiles, hub_deg: int, *, base: int = DEFAULT_BASE,
                growth: int = DEFAULT_GROWTH) -> tuple[EllTiles, EllTiles]:
    """Partition ELL buckets into (tail, hub) sides by the snapped threshold.

    Bucket membership is decided by tile width, which agrees with the
    per-row `deg > hub_degree_floor(...)` predicate by construction.
    """
    w_h = hub_width(hub_deg, base, growth)
    tail = tuple(t for t in ell if t.nbrs.shape[-1] < w_h)
    hub = tuple(t for t in ell if t.nbrs.shape[-1] >= w_h)
    return tail, hub


def build_ell(indptr: np.ndarray, indices: np.ndarray, degrees: np.ndarray,
              row_ids: np.ndarray | None = None, *, device,
              base: int = DEFAULT_BASE,
              growth: int = DEFAULT_GROWTH) -> EllTiles:
    """CSR (host numpy) -> tuple of `EllBucket` tiles on `device`.

    Degree-0 rows are dropped: they can neither push nor pull, and they
    stay discoverable as scatter targets of other rows' tiles.
    `row_ids` maps local row index -> scatter-target id (identity if None).
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    degrees = np.asarray(degrees)
    if row_ids is None:
        row_ids = np.arange(len(degrees), dtype=np.int32)
    if degrees.size == 0 or degrees.max() == 0:
        return ()
    widths = bucket_widths(int(degrees.max()), base, growth)
    return tuple(EllBucket(rows=torch.from_numpy(rows).to(device),
                           deg=torch.from_numpy(deg).to(device),
                           nbrs=torch.from_numpy(tile).to(device))
                 for rows, deg, tile in _ell_numpy(indptr, indices, degrees,
                                                   row_ids, widths)
                 if len(rows))


def build_graph_ell(graph, *, device, base: int = DEFAULT_BASE,
                    growth: int = DEFAULT_GROWTH) -> EllTiles:
    """`repro_torch.core.graph.Graph` -> single-partition ELL tiles."""
    return build_ell(graph.indptr, graph.indices, graph.degrees,
                     device=device, base=base, growth=growth)


def build_device_graph_ell(dg, *, base: int = DEFAULT_BASE,
                           growth: int = DEFAULT_GROWTH) -> EllTiles:
    """`repro_torch.core.bfs.DeviceGraph` -> ELL tiles on its device (the
    CSR comes back to the host once for the bucketing)."""
    indptr = dg.indptr.cpu().numpy()
    return build_ell(indptr, dg.indices.cpu().numpy(),
                     np.diff(indptr).astype(np.int32), device=dg.device,
                     base=base, growth=growth)


def _hybrid_layout(pg, base: int, growth: int):
    """(widths, per-partition degrees, padded rows per bucket) shared by
    every partition, or None when no partition has an edge.

    Bucket widths come from the global max local-row degree, and each
    bucket's row count is the largest any partition has in it, so every
    rank's tiles have the same shapes; the counts come from the degrees
    alone, without building the other ranks' tiles.
    """
    per_dev_deg = np.diff(pg.local_indptr.astype(np.int64), axis=1)
    max_deg = int(per_dev_deg.max()) if per_dev_deg.size else 0
    if max_deg == 0:
        return None
    widths = bucket_widths(max_deg, base, growth)
    counts = [np.bincount(np.searchsorted(widths, d[d > 0]),
                          minlength=len(widths)) for d in per_dev_deg]
    return widths, per_dev_deg.astype(np.int32), np.max(counts, axis=0)


def _hybrid_rank_numpy(pg, rank: int, layout):
    """Partition `rank`'s non-empty buckets as padded numpy triples:
    padding rows have id `v_pad`, degree 0 and zero neighbours."""
    widths, per_dev_deg, r_max = layout
    v_pad = pg.plan.v_pad
    out = []
    for (rw, dg, nb), w, rm in zip(
            _ell_numpy(pg.local_indptr[rank], pg.local_indices[rank],
                       per_dev_deg[rank], pg.local_row_gid[rank], widths),
            widths, r_max):
        if rm == 0:
            continue
        rows = np.full(rm, v_pad, dtype=np.int32)
        deg = np.zeros(rm, dtype=np.int32)
        nbrs = np.zeros((rm, w), dtype=np.int32)
        rows[:len(rw)] = rw
        deg[:len(rw)] = dg
        nbrs[:len(rw)] = nb
        out.append((rows, deg, nbrs))
    return out


def build_hybrid_ell(pg, rank: int, *, device, base: int = DEFAULT_BASE,
                     growth: int = DEFAULT_GROWTH) -> EllTiles:
    """`PartitionedGraph` -> partition `rank`'s ELL buckets on `device`.

    Every rank gets the same bucket count and tile shapes: bucket widths
    come from the global max local-row degree, and each bucket's row count
    is padded to the largest partition's with degree-0 rows whose id is
    the out-of-range `v_pad` (the steps of `core.hybrid_bfs` drop them).
    Columns are global new ids. `hybrid_ell_numpy` stacks every rank's.
    """
    layout = _hybrid_layout(pg, base, growth)
    if layout is None:
        return ()
    return tuple(EllBucket(rows=torch.from_numpy(rows).to(device),
                           deg=torch.from_numpy(deg).to(device),
                           nbrs=torch.from_numpy(nbrs).to(device))
                 for rows, deg, nbrs in _hybrid_rank_numpy(pg, rank, layout))


def hybrid_ell_numpy(pg, *, base: int = DEFAULT_BASE,
                     growth: int = DEFAULT_GROWTH) -> list:
    """Every partition's buckets stacked on axis 0, as numpy triples
    (rows int32[P, R], deg int32[P, R], nbrs int32[P, R, W]): the layout of
    the JAX package's `build_hybrid_ell`."""
    layout = _hybrid_layout(pg, base, growth)
    if layout is None:
        return []
    per_rank = [_hybrid_rank_numpy(pg, p, layout) for p in range(pg.n_parts)]
    return [tuple(np.stack(arrs) for arrs in zip(*buckets))
            for buckets in zip(*per_rank)]


def _ell_numpy(indptr, indices, degrees, row_ids, widths):
    """Host-side bucketing against a fixed width ladder.

    Returns one (rows, deg, tile) numpy triple per width, empty buckets
    included (`build_ell` drops them; the hybrid builder pads them to the
    partitions' common shapes).
    """
    out = []
    lo = 0
    for w in widths:
        sel = np.flatnonzero((degrees > lo) & (degrees <= w))
        lo = w
        sel = sel[np.argsort(-degrees[sel].astype(np.int64), kind="stable")]
        d = degrees[sel].astype(np.int64)
        tile = np.zeros((len(sel), w), dtype=np.int32)
        if len(sel):
            rowrep = np.repeat(np.arange(len(sel)), d)
            col = np.arange(d.sum()) - np.repeat(np.cumsum(d) - d, d)
            tile[rowrep, col] = indices[np.repeat(indptr[sel].astype(np.int64), d) + col]
        out.append((np.asarray(row_ids)[sel].astype(np.int32),
                    degrees[sel].astype(np.int32), tile))
    return out

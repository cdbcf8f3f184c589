"""Graph partitioning and workload specialization (paper §3.2), host numpy.

The port's own copy of the JAX package's `core/partition.py`: the same
strategies, plan and per-partition CSR blocks, array for array.

Strategies
----------
* ``random``    — vertex-balanced random assignment (the paper's baseline).
* ``hub0``      — the paper's heterogeneous layout: the high-degree hubs
  (and their edge mass) sit on partition 0, the low-degree vertices are
  dealt to the other partitions, degree-snake-ordered for balance.
* ``specialized`` — hub delegation (Pearce et al., which the paper cites as
  the homogeneous-platform counterpart): each hub's adjacency list is cut
  evenly across all partitions, so every rank owns a 1/P slice of every hub
  row plus a degree-balanced (snake-dealt) set of low-degree leaves. The
  once-per-round OR exchange and the deferred parent min-reduction merge the
  slices; delegation needs no extra communication.

Layout
------
The plan is a vertex permutation (the paper's local-id permutation, §3.4):
hubs take new ids [0, H); each partition's leaves are contiguous after
that, padded with phantom (degree-0) vertices to a common count. Every rank
addresses vertices by global new id; a rank's rows are described by
`local_row_gid`, so owned leaves and delegated hub slices are handled alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph, sort_adjacency_by_degree

STRATEGIES = ("random", "hub0", "specialized")


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    strategy: str
    n_parts: int
    v_orig: int
    v_pad: int                     # n_parts * leaves_per_part + hub_count
    hub_count: int                 # hubs occupy new ids [0, hub_count)
    leaves_per_part: int           # padded equal leaf count per partition
    perm_new_to_old: np.ndarray    # int64[v_pad]; -1 for phantom pad vertices


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Per-partition CSR blocks (stacked on axis 0) + replicated globals."""
    plan: PartitionPlan
    num_local_rows: int            # R = delegated hubs + leaves (per rank)
    # Stacked per-partition arrays ([P, ...]); columns are global new ids.
    local_indptr: np.ndarray       # int32[P, R+1]
    local_indices: np.ndarray      # int32[P, Emax] (0-padded tail)
    local_row_gid: np.ndarray      # int32[P, R]; == v_pad for phantom rows
    # Replicated:
    deg_ext: np.ndarray            # int32[v_pad+1]; deg_ext[v_pad] == 0
    total_directed_edges: int

    @property
    def n_parts(self) -> int:
        return self.plan.n_parts


def hub_tail_masses(degrees: np.ndarray, hub_deg: int, *, base: int = 32,
                    growth: int = 2) -> dict:
    """Row and edge mass on each side of the snapped hub threshold.

    `hub_deg` snaps to the ELL bucket ladder as `BFSConfig.hub_split` does
    (`ell.hub_degree_floor`), so the masses describe the rows the hub and
    tail passes own.
    """
    from repro_torch.core.ell import hub_degree_floor
    deg = np.asarray(degrees).astype(np.int64)
    floor = hub_degree_floor(hub_deg, base, growth)
    hub = deg > floor
    tail = ~hub & (deg > 0)
    return dict(
        hub_degree_floor=int(floor),
        n_hub=int(hub.sum()), n_tail=int(tail.sum()),
        n_zero=int((deg == 0).sum()),
        e_hub=int(deg[hub].sum()), e_tail=int(deg[tail].sum()),
    )


def _snake_deal(order: np.ndarray, n_parts: int) -> list[np.ndarray]:
    """Deal `order` (degree-desc) to partitions in snake order: edge balance."""
    idx = np.arange(len(order))
    round_ = idx // n_parts
    pos = idx % n_parts
    dest = np.where(round_ % 2 == 0, pos, n_parts - 1 - pos)
    return [order[dest == p] for p in range(n_parts)]


def make_plan(g: Graph, n_parts: int, strategy: str = "specialized",
              hub_edge_fraction: float = 0.5, seed: int = 0) -> PartitionPlan:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; want one of {STRATEGIES}")
    v = g.num_vertices
    deg_desc = np.argsort(-g.degrees.astype(np.int64), kind="stable")

    hub_count = 0
    if strategy in ("hub0", "specialized") and n_parts > 1:
        # Hubs = top-degree vertices holding `hub_edge_fraction` of all edges.
        csum = np.cumsum(g.degrees[deg_desc].astype(np.int64))
        hub_count = int(np.searchsorted(
            csum, hub_edge_fraction * g.num_directed_edges) + 1)
        hub_count = min(hub_count, v // 2)

    hubs = deg_desc[:hub_count]
    leaves = deg_desc[hub_count:]

    if strategy == "random":
        rng = np.random.default_rng(seed)
        leaves = rng.permutation(leaves)
        dealt = np.array_split(leaves, n_parts)
    elif strategy == "hub0":
        # Leaves go to partitions 1..P-1 only; partition 0 keeps the hubs.
        # P == 1 degenerates to everything on 0.
        if n_parts == 1:
            dealt = [leaves]
        else:
            dealt = [np.array([], dtype=leaves.dtype)]
            dealt += _snake_deal(leaves, n_parts - 1)
    else:  # specialized: delegated hubs + snake-dealt leaves
        dealt = _snake_deal(leaves, n_parts)

    leaves_per_part = max((len(d) for d in dealt), default=0)
    v_pad = hub_count + n_parts * leaves_per_part
    perm = np.full(v_pad, -1, dtype=np.int64)
    perm[:hub_count] = hubs
    for p, d in enumerate(dealt):
        base = hub_count + p * leaves_per_part
        perm[base:base + len(d)] = d
    return PartitionPlan(strategy, n_parts, v, v_pad, hub_count,
                         leaves_per_part, perm)


def _relabel_padded(g: Graph, plan: PartitionPlan) -> Graph:
    """Relabel to new-id space, with phantom degree-0 rows for padding."""
    v_pad = plan.v_pad
    inv = np.full(g.num_vertices, -1, dtype=np.int64)
    real = plan.perm_new_to_old >= 0
    inv[plan.perm_new_to_old[real]] = np.flatnonzero(real)
    degrees = np.zeros(v_pad, dtype=np.int32)
    degrees[real] = g.degrees[plan.perm_new_to_old[real]]
    indptr = np.zeros(v_pad + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    row_of_edge = np.repeat(np.arange(v_pad, dtype=np.int64), degrees)
    offset = np.arange(len(g.indices), dtype=np.int64) - indptr[row_of_edge]
    old_rows = plan.perm_new_to_old[row_of_edge]
    new_indices = inv[g.indices[g.indptr[old_rows] + offset]].astype(np.int32)
    out = Graph(v_pad, indptr, new_indices, degrees)
    out = sort_adjacency_by_degree(out)   # §3.4 ordering in the new id space
    out.validate()
    return out


def _rows_of(plan: PartitionPlan, p: int, delegate: bool) -> np.ndarray:
    """Global new ids of partition `p`'s rows, in local row order.

    specialized: [h delegated hub slices] + [lpp owned leaves];
    hub0/random: partition 0 [h hubs] + [lpp leaves], the others [lpp
    leaves] (every partition is then padded to the same R).
    """
    h, lpp = plan.hub_count, plan.leaves_per_part
    leaves = np.arange(h + p * lpp, h + (p + 1) * lpp, dtype=np.int64)
    if delegate or p == 0:
        return np.concatenate([np.arange(h, dtype=np.int64), leaves])
    return leaves


def apply_plan(g: Graph, plan: PartitionPlan) -> PartitionedGraph:
    """Materialize per-partition CSR blocks for `hybrid_bfs`.

    Vectorized over rows (the JAX package walks them in a Python loop);
    the arrays are equal to its, array for array.
    """
    gp = _relabel_padded(g, plan)
    p_, h = plan.n_parts, plan.hub_count
    v_pad = plan.v_pad
    delegate = plan.strategy == "specialized" and h > 0

    rows_per_dev = [_rows_of(plan, p, delegate) for p in range(p_)]
    r = max(len(rows) for rows in rows_per_dev)

    local_indptr = np.zeros((p_, r + 1), dtype=np.int64)
    local_row_gid = np.full((p_, r), v_pad, dtype=np.int32)
    spans = []
    for p, rows in enumerate(rows_per_dev):
        local_row_gid[p, :len(rows)] = rows
        lo, hi = gp.indptr[rows], gp.indptr[rows + 1]
        if delegate:
            # This partition's slice of each delegated hub row.
            d = hi - lo
            hub = rows < h
            lo, hi = (np.where(hub, lo + (d * p) // p_, lo),
                      np.where(hub, lo + (d * (p + 1)) // p_, hi))
        degs = np.zeros(r, dtype=np.int64)
        degs[:len(rows)] = hi - lo
        local_indptr[p, 1:] = np.cumsum(degs)
        spans.append((lo, hi - lo))

    emax = int(local_indptr[:, -1].max())
    local_indices = np.zeros((p_, max(emax, 1)), dtype=np.int32)
    for p, (lo, d) in enumerate(spans):
        n = int(d.sum())
        # Edge k of row i sits at lo[i] + (k - start of row i).
        gather = np.repeat(lo - (np.cumsum(d) - d), d) + np.arange(n)
        local_indices[p, :n] = gp.indices[gather]

    deg_ext = np.zeros(v_pad + 1, dtype=np.int32)
    deg_ext[:v_pad] = gp.degrees
    assert local_indptr[:, -1].max() < np.iinfo(np.int32).max
    return PartitionedGraph(
        plan=plan,
        num_local_rows=r,
        local_indptr=local_indptr.astype(np.int32),
        local_indices=local_indices,
        local_row_gid=local_row_gid,
        deg_ext=deg_ext,
        total_directed_edges=gp.num_directed_edges,
    )


def unpermute(plan: PartitionPlan, arr_new: np.ndarray,
              fill=-1) -> np.ndarray:
    """Map a v_pad-sized per-new-id array back to original vertex ids.

    Values that are vertex *ids* must be mapped through perm separately —
    see `unpermute_ids`.
    """
    out = np.full(plan.v_orig, fill, dtype=arr_new.dtype)
    real = plan.perm_new_to_old >= 0
    out[plan.perm_new_to_old[real]] = arr_new[real]
    return out


def unpermute_ids(plan: PartitionPlan, id_arr_new: np.ndarray) -> np.ndarray:
    """As `unpermute`, but element *values* are new ids needing translation."""
    vals = id_arr_new.copy().astype(np.int64)
    ok = (vals >= 0) & (vals < plan.v_pad)
    vals[ok] = plan.perm_new_to_old[vals[ok]]
    return unpermute(plan, vals.astype(np.int64))

"""Structured result of an engine traversal query (single- or multi-root).

The port's own copy of the JAX package's `engine/result.py`. All arrays are
host numpy in original vertex ids with Graph500 conventions (-1 =
unreached); the batch dimension is always present, even for a single root.

TEPS accounting follows the Graph500 rule: a search is credited only with
the edges it actually traversed — half the degree sum over the *reached*
vertex set (the reached set is the root's whole component, so that sum
counts each intra-component undirected edge exactly twice). The
whole-graph figure survives as `teps_global`.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Optional, Sequence

import numpy as np


def edges_traversed_from_levels(degrees: np.ndarray,
                                level: np.ndarray) -> np.ndarray:
    """Undirected edges traversed per root: half the reached degree sum.

    `degrees` is int32[V] (directed degree = undirected incident edges);
    `level` is int32[B, V] with -1 for unreached. Every edge incident to a
    reached vertex stays inside the component, so the degree sum over
    `level[b] >= 0` counts each traversed undirected edge twice.
    """
    deg = np.asarray(degrees, dtype=np.int64)
    reached = np.asarray(level) >= 0
    return (reached @ deg) // 2


@dataclasses.dataclass
class TraversalResult:
    """Parent/level trees + timing for a batch of BFS roots.

    Attributes:
      roots: int64[B] original-id roots, in query order.
      parent: int32[B, V]; parent[b, v] == -1 iff v unreached from roots[b].
      level: int32[B, V]; BFS depth, -1 unreached.
      num_levels: int32[B] BFS tree depth per root (deepest reached level;
        0 when only the root's own component member is itself).
      seconds: wall-clock for the whole batch, compile/warmup excluded.
      per_root_seconds: float64[B]. Measured individually when the backend
        ran roots one at a time with per-root blocking; an even split of
        `seconds` when the batch executed as one fused program.
      backend: "fused" | "sharded" | "stepper" (resolved, never "auto").
      n_parts: partition count the query ran with.
      edges_undirected: whole-graph undirected edge count (`teps_global`).
      per_level_stats: stepper backend only — one list of per-level dicts per
        root (level, direction, frontier_size, frontier_edges, compute_s,
        exchange_s, seconds).
      timings: stepper backend only — one dict per root with out-of-loop
        phase times (init_s, agg_s, driver_overhead_s — the level loop's
        host-side cost outside the timed device work).
      edges_traversed: int64[B] undirected edges actually traversed per root
        (Graph500 accounting; the engine fills it from the reached set).
      batch_level_stats: batched fused (cohort) path only — ONE flat list of
        per-level rows describing the whole batch: the level driver's schema plus
        `direction` in {"td","bu","mixed"}, cohort sizes
        (`td_lanes`/`bu_lanes`/`active_lanes`/`batch`), and per-lane
        vectors (`lane_frontier`, `lane_edges`, `lane_direction`,
        `lane_active` — pad lanes included, always inactive). Dropped by
        `split` (the rows describe the merged dispatch, not any slice).
    """

    roots: np.ndarray
    parent: np.ndarray
    level: np.ndarray
    num_levels: np.ndarray
    seconds: float
    per_root_seconds: np.ndarray
    backend: str
    n_parts: int
    edges_undirected: int
    per_level_stats: Optional[list] = None
    timings: Optional[list] = None
    edges_traversed: Optional[np.ndarray] = None
    batch_level_stats: Optional[list] = None

    @property
    def batch_size(self) -> int:
        return int(self.roots.shape[0])

    def _edges_per_root(self) -> np.ndarray:
        if self.edges_traversed is not None:
            return np.asarray(self.edges_traversed, dtype=np.float64)
        return np.full(self.batch_size, self.edges_undirected, np.float64)

    @property
    def teps(self) -> float:
        """Aggregate throughput: *traversed* undirected edges per second."""
        return float(self._edges_per_root().sum()) / max(self.seconds, 1e-12)

    @property
    def teps_per_root(self) -> np.ndarray:
        return self._edges_per_root() / np.maximum(self.per_root_seconds,
                                                   1e-12)

    @property
    def teps_hmean(self) -> float:
        """Harmonic-mean per-root TEPS (the Graph500 reporting statistic).

        Zero-TEPS roots — isolated or edgeless roots that traversed no
        edges — are excluded: the harmonic mean over any set containing a
        zero is identically zero (and `statistics.harmonic_mean` raised on
        some interpreter versions), which erases every other root's
        throughput. A batch where *no* root traversed anything reports 0.0.
        """
        t = self.teps_per_root
        pos = t[t > 0.0]
        if pos.size == 0:
            return 0.0
        return float(statistics.harmonic_mean(pos.tolist()))

    @property
    def teps_global(self) -> float:
        """Pre-component-accounting figure: whole-graph E / batch seconds.

        Kept for trajectory continuity in `benchmarks/bench_teps.py`; it
        over-credits roots whose component is smaller than the graph.
        """
        return (self.batch_size * self.edges_undirected
                / max(self.seconds, 1e-12))

    def reached(self, i: int = 0) -> np.ndarray:
        """Vertex ids reached from roots[i]."""
        return np.flatnonzero(self.level[i] >= 0)

    def split(self, sizes: Sequence[int]) -> list["TraversalResult"]:
        """Slice a coalesced batch back into per-query results.

        `sizes` must sum to `batch_size` (in query order). Each part keeps
        the batch's backend/partitioning; `seconds` is the sum of the
        part's `per_root_seconds` (an even split when the batch ran as one
        fused dispatch). The server uses this to return every coalesced
        client its own result.
        """
        if int(np.sum(sizes)) != self.batch_size:
            raise ValueError(
                f"split sizes {list(sizes)} do not sum to batch "
                f"{self.batch_size}")
        parts, lo = [], 0
        for n in sizes:
            hi = lo + int(n)
            sl = slice(lo, hi)
            parts.append(TraversalResult(
                roots=self.roots[sl], parent=self.parent[sl],
                level=self.level[sl], num_levels=self.num_levels[sl],
                seconds=float(self.per_root_seconds[sl].sum()),
                per_root_seconds=self.per_root_seconds[sl],
                backend=self.backend, n_parts=self.n_parts,
                edges_undirected=self.edges_undirected,
                per_level_stats=(self.per_level_stats[sl]
                                 if self.per_level_stats is not None else None),
                timings=(self.timings[sl]
                         if self.timings is not None else None),
                edges_traversed=(self.edges_traversed[sl]
                                 if self.edges_traversed is not None else None),
            ))
            lo = hi
        return parts

    def validate(self, graph, sample: Optional[int] = None) -> "TraversalResult":
        """Graph500-style parent-tree validation against the python oracle.

        Checks every root, or `sample` evenly spaced roots when set (large
        batches). Raises AssertionError on any invalid tree; returns self so
        it chains: `engine.bfs(roots).validate(g)`.
        """
        from repro_torch.core import ref
        idx = np.arange(self.batch_size)
        if sample is not None and sample < self.batch_size:
            idx = idx[np.linspace(0, self.batch_size - 1, sample).astype(int)]
        for b in idx:
            ref.validate_parents(graph, int(self.roots[b]),
                                 self.parent[b], self.level[b])
        return self

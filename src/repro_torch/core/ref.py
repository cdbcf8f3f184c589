"""Pure-Python/numpy BFS oracle and Graph500-style result validation.

The port's own copy of the JAX package's `core/ref.py`. A Python loop: use
it at test sizes; `chip_smoke.py` checks full-size trees with a vectorised
check of its own.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.graph import Graph


def bfs_levels(g: Graph, root: int) -> np.ndarray:
    """Classic queue BFS. Returns int32 levels, -1 for unreachable."""
    level = np.full(g.num_vertices, -1, dtype=np.int32)
    level[root] = 0
    q = deque([root])
    while q:
        v = q.popleft()
        for n in g.neighbours(v):
            if level[n] < 0:
                level[n] = level[v] + 1
                q.append(int(n))
    return level


def validate_parents(g: Graph, root: int, parent: np.ndarray,
                     level: np.ndarray | None = None) -> None:
    """Graph500-style validation of a BFS parent tree.

    Checks:
      1. parent[root] == root.
      2. Exactly the reachable vertices have a parent.
      3. Every non-root parent is an actual neighbour.
      4. Tree edges span exactly one BFS level: level[v] == level[parent]+1.
    """
    ref_level = bfs_levels(g, root)
    reachable = ref_level >= 0
    has_parent = parent >= 0
    assert parent[root] == root, "root must be its own parent"
    np.testing.assert_array_equal(
        has_parent, reachable, err_msg="parent-tree coverage != reachable set")
    vs = np.flatnonzero(reachable)
    vs = vs[vs != root]
    for v in vs:
        p = parent[v]
        assert p in g.neighbours(v), f"parent[{v}]={p} is not a neighbour"
        assert ref_level[v] == ref_level[p] + 1, (
            f"tree edge {p}->{v} spans levels {ref_level[p]}->{ref_level[v]}")
    if level is not None:
        np.testing.assert_array_equal(level, ref_level)


def teps(g: Graph, seconds: float) -> float:
    """Undirected traversed-edges-per-second (Graph500 reporting rule)."""
    return g.num_undirected_edges / max(seconds, 1e-12)

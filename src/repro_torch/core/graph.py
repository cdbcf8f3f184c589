"""Graph substrate: generation and CSR construction (host-side numpy).

The port's own copy of the JAX package's `core/graph.py`: the same
generators and the same CSR layout, so a seed gives the same arrays in both
packages. Construction stays on the host; the traversal runs on tensors
(`repro_torch.core.bfs`).

Conventions
-----------
* Graphs are undirected; each undirected edge is stored as two directed CSR
  edges, and TEPS divide directed-edge counts by 2.
* Adjacency within each row is sorted by descending neighbour degree
  (paper §3.4), so bottom-up scans meet likely frontier members first.
* Vertex ids are int32 (V < 2**31).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Graph500 reference R-MAT parameters.
RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19
EDGEFACTOR = 16


@dataclasses.dataclass(frozen=True)
class Graph:
    """Compressed-sparse-row undirected graph.

    Attributes:
      num_vertices: V.
      indptr: int64[V+1] row offsets.
      indices: int32[E] column ids, each row sorted by descending neighbour
        degree.
      degrees: int32[V] (== indptr diff, cached).
    """

    num_vertices: int
    indptr: np.ndarray
    indices: np.ndarray
    degrees: np.ndarray

    @property
    def num_directed_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_undirected_edges(self) -> int:
        return self.num_directed_edges // 2

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.num_vertices else 0

    def neighbours(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self) -> None:
        assert self.indptr.shape == (self.num_vertices + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == len(self.indices)
        assert (np.diff(self.indptr) == self.degrees).all()
        if len(self.indices):
            assert self.indices.min() >= 0
            assert self.indices.max() < self.num_vertices


def _dedupe_edges(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop self loops and duplicate (undirected) edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    key = lo << 32 | hi
    _, first = np.unique(key, return_index=True)
    return src[first], dst[first]


def from_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int,
               symmetrize: bool = True, sort_by_degree: bool = True) -> Graph:
    """Build a CSR `Graph` from an edge list.

    Args:
      src, dst: integer endpoint arrays (directed as given).
      symmetrize: add the reverse of every edge (undirected storage).
      sort_by_degree: order each adjacency list by descending neighbour
        degree (paper §3.4).
    """
    src, dst = _dedupe_edges(np.asarray(src), np.asarray(dst))
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    src = src.astype(np.int64)
    dst = dst.astype(np.int32)
    degrees = np.bincount(src, minlength=num_vertices).astype(np.int32)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    g = Graph(num_vertices, indptr, indices, degrees)
    if sort_by_degree:
        g = sort_adjacency_by_degree(g)
    g.validate()
    return g


def sort_adjacency_by_degree(g: Graph) -> Graph:
    """Reorder each adjacency list by descending neighbour degree (§3.4)."""
    row_of_edge = np.repeat(
        np.arange(g.num_vertices, dtype=np.int64), g.degrees)
    neg_deg = -g.degrees[g.indices].astype(np.int64)
    # lexsort: the last key is the primary one.
    order = np.lexsort((neg_deg, row_of_edge))
    return Graph(g.num_vertices, g.indptr, g.indices[order], g.degrees)


def rmat(scale: int, edgefactor: int = EDGEFACTOR, seed: int = 0,
         a: float = RMAT_A, b: float = RMAT_B, c: float = RMAT_C,
         permute: bool = True, sort_by_degree: bool = True) -> Graph:
    """Graph500-style Kronecker/R-MAT generator (vectorized numpy).

    Recursive quadrant selection per bit, then a random vertex permutation
    so ids carry no locality.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edgefactor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for _ in range(scale):
        u = rng.random(m)
        v = rng.random(m)
        ii = u > ab
        jj = np.where(ii, v > c_norm, v > a_norm)
        src = (src << 1) | ii
        dst = (dst << 1) | jj
    if permute:
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    return from_edges(src, dst, n, sort_by_degree=sort_by_degree)


def uniform_random(num_vertices: int, num_edges: int, seed: int = 0,
                   sort_by_degree: bool = True) -> Graph:
    """Erdos–Renyi-style generator (low skew)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    return from_edges(src, dst, num_vertices, sort_by_degree=sort_by_degree)


# Scaled-down stand-ins for the paper's real-world workloads (Table 1 / §4):
# published V/E ratios preserved, |V| scaled by ~256x. Twitter is strongly
# scale-free (RMAT); Wikipedia/LiveJournal less so (milder RMAT parameters).
REAL_WORLD_STANDINS = {
    # name: (generator, kwargs)  — V, E ratios from the paper §4 Workloads.
    "twitter_x256": ("rmat", dict(scale=17, edgefactor=18, a=0.57, b=0.19, c=0.19)),
    "wikipedia_x256": ("rmat", dict(scale=17, edgefactor=11, a=0.50, b=0.22, c=0.22)),
    "livejournal_x256": ("rmat", dict(scale=14, edgefactor=17, a=0.48, b=0.23, c=0.23)),
}


def real_world_standin(name: str, seed: int = 0) -> Graph:
    kind, kw = REAL_WORLD_STANDINS[name]
    if kind != "rmat":
        raise ValueError(f"stand-in {name!r}: unknown generator {kind!r}")
    return rmat(seed=seed, **kw)


def relabel(g: Graph, perm_new_to_old: np.ndarray,
            sort_by_degree: bool = True) -> Graph:
    """Apply a vertex permutation: new vertex i is old vertex perm[i].

    This is the paper's local-ID permutation (§3.4): partitioning emits a
    permutation placing each partition's vertices contiguously; the CSR is
    rebuilt in the new id space.
    """
    v = g.num_vertices
    inv = np.empty(v, dtype=np.int64)
    inv[perm_new_to_old] = np.arange(v)
    new_degrees = g.degrees[perm_new_to_old]
    new_indptr = np.zeros(v + 1, dtype=np.int64)
    np.cumsum(new_degrees, out=new_indptr[1:])
    # Vectorized row gather: for each new edge slot, locate (new_row,
    # offset) and read the old row's neighbour, remapped.
    old_starts = g.indptr[perm_new_to_old]
    row_of_edge = np.repeat(np.arange(v, dtype=np.int64), new_degrees)
    offset = np.arange(len(g.indices), dtype=np.int64) - new_indptr[row_of_edge]
    new_indices = inv[g.indices[old_starts[row_of_edge] + offset]].astype(np.int32)
    out = Graph(v, new_indptr, new_indices, new_degrees.astype(np.int32))
    if sort_by_degree:
        out = sort_adjacency_by_degree(out)
    out.validate()
    return out

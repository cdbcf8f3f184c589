"""Graph500 inputs made by the benchmark: the Kronecker graph, its search
keys and each component's edge count, in plain PyTorch.

The graph is made on the device from the seed (one `torch.Generator` on
that device, a few large calls), in the layout the port's `Graph`
documents: an undirected CSR with each edge stored both ways, self-loops
and duplicates dropped, and each row's neighbours ordered by descending
neighbour degree (ties by ascending id). Nothing here imports the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT31 = (1 << 31) - 1


@dataclasses.dataclass
class Csr:
    """The benchmark's own copy of the graph: host arrays (what the port
    is handed) and the row count."""
    num_vertices: int
    indptr: np.ndarray      # int64[V + 1]
    indices: np.ndarray     # int32[E]
    degrees: np.ndarray     # int32[V]

    @property
    def num_directed_edges(self) -> int:
        return int(self.indices.shape[0])

    def on(self, device) -> tuple:
        """(indptr int64, indices int64) on `device`."""
        return (torch.from_numpy(self.indptr).to(device),
                torch.from_numpy(self.indices).to(device).long())


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, gen: torch.Generator, device) -> tuple:
    """Graph500's Kronecker edge list: `edgefactor * 2**scale` (src, dst)
    pairs, each bit of both ends drawn by the quadrant probabilities
    A, B, C, 1 - A - B - C, then the vertex labels permuted."""
    n = 1 << scale
    m = edgefactor * n
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for _ in range(scale):
        u = torch.rand(m, generator=gen, device=device)
        v = torch.rand(m, generator=gen, device=device)
        ii = u > ab
        jj = torch.where(ii, v > c_norm, v > a_norm)
        del u, v
        src.mul_(2).add_(ii)
        dst.mul_(2).add_(jj)
        del ii, jj
    perm = torch.randperm(n, generator=gen, device=device)
    return perm[src], perm[dst]


def csr_from_edges(src: torch.Tensor, dst: torch.Tensor, n: int) -> Csr:
    """Drop self-loops and duplicate undirected edges, store each edge both
    ways, order rows by id and each row by descending neighbour degree
    (ties by ascending id); return the host CSR."""
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    del keep
    key = torch.unique(lo << 32 | hi)
    del lo, hi
    lo, hi = key >> 32, key & 0xFFFFFFFF
    del key
    s = torch.cat([lo, hi])
    d = torch.cat([hi, lo])
    del lo, hi
    deg = torch.bincount(s, minlength=n)
    order = torch.sort(d, stable=True).indices
    s, d = s[order], d[order]
    order = torch.sort(s << 32 | (INT31 - deg[d]), stable=True).indices
    d = d[order]
    del s, order
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=d.device)
    torch.cumsum(deg, 0, out=indptr[1:])
    return Csr(n, indptr.cpu().numpy(), d.to(torch.int32).cpu().numpy(),
               deg.to(torch.int32).cpu().numpy())


def make_graph(gen_cfg: dict, seed: int, device) -> Csr:
    """The configuration's Kronecker graph from `seed`, made on `device`."""
    if gen_cfg.get("kind", "kronecker") != "kronecker":
        raise ValueError(f"unknown generator {gen_cfg.get('kind')!r}")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    src, dst = kronecker_edges(int(gen_cfg["scale"]),
                               int(gen_cfg["edgefactor"]),
                               float(gen_cfg["a"]), float(gen_cfg["b"]),
                               float(gen_cfg["c"]), gen, device)
    return csr_from_edges(src, dst, 1 << int(gen_cfg["scale"]))


def sample_roots(degrees: np.ndarray, roots: int, seed) -> np.ndarray:
    """Graph500 search keys: `roots` distinct non-isolated vertices drawn
    from the seed (a copy of the port's `launch/bfs_run.sample_roots`,
    without its clamp: a graph with fewer candidates raises)."""
    rng = np.random.default_rng(seed)
    candidates = np.flatnonzero(degrees > 0)
    return rng.choice(candidates, size=roots, replace=False)


def component_edges(csr: Csr, device) -> tuple:
    """(label int64[V], edges int64[V]): each vertex's component label (its
    smallest vertex id, by min-label propagation with pointer jumping over
    the CSR) and, per label, the component's undirected edges (half its
    degree sum). A search from `r` traverses `edges[label[r]]` Graph500
    edges."""
    indptr, indices = csr.on(device)
    n = csr.num_vertices
    deg = indptr[1:] - indptr[:-1]
    rows = torch.repeat_interleave(torch.arange(n, device=indptr.device), deg)
    lab = torch.arange(n, device=indptr.device)
    while True:
        nxt = lab.clone()
        nxt.scatter_reduce_(0, rows, lab[indices], "amin")
        while True:
            jumped = nxt[nxt]
            if torch.equal(jumped, nxt):
                break
            nxt = jumped
        if torch.equal(nxt, lab):
            break
        lab = nxt
    del rows, indices
    edges = torch.zeros(n, dtype=torch.int64, device=lab.device)
    edges.index_add_(0, lab, deg)
    return lab, edges // 2

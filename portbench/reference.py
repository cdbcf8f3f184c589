"""The plain reference BFS and the comparison that decides `correct`.

Plain PyTorch over the benchmark's own CSR (`graph500.Csr`), level by
level top-down, importing nothing of the port. A search the program
answered is judged against it:

* `level_mismatches`: vertices whose level differs from the reference's
  (-1 where unreached), so coverage counts too;
* `parent_faults`: the root not its own parent, an unreached vertex with a
  parent, or a reached vertex whose parent is not a neighbour one level up
  (Graph500's tree rules, with the reference's levels);
* `unanswered`: queries that never came back;
* `ranks_failed` (a cell on more than one chip): ranks other than 0
  that raised, wherever in the run.

Every number has the limit 0: the guarantee is an exact BFS tree. The
control (`control_search`) breaks it the way a search that ends one level
early would: the reference with its deepest level dropped.
"""
from __future__ import annotations

import numpy as np
import torch

LIMITS = {"level_mismatches": 0, "parent_faults": 0, "unanswered": 0,
          # a cell on more than one chip: followers that raised
          "ranks_failed": 0}


def plain_bfs(indptr: torch.Tensor, indices: torch.Tensor, root: int):
    """(parent int64[V], level int64[V]), -1 where unreached; a vertex's
    parent is its smallest-id neighbour on the level above."""
    n = indptr.numel() - 1
    dev = indptr.device
    level = torch.full((n,), -1, dtype=torch.int64, device=dev)
    parent = torch.full((n,), -1, dtype=torch.int64, device=dev)
    level[root] = 0
    parent[root] = root
    frontier = torch.tensor([root], dtype=torch.int64, device=dev)
    depth = 0
    while frontier.numel():
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        first = torch.cumsum(counts, 0) - counts
        slot = (torch.repeat_interleave(starts - first, counts,
                                        output_size=total)
                + torch.arange(total, device=dev))
        owner = torch.repeat_interleave(frontier, counts, output_size=total)
        nbr = indices[slot]
        del slot
        fresh = level[nbr] < 0
        nbr, owner = nbr[fresh], owner[fresh]
        if nbr.numel() == 0:
            break
        best = torch.full((n,), n, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, nbr, owner, "amin")
        frontier = torch.unique(nbr)
        depth += 1
        level[frontier] = depth
        parent[frontier] = best[frontier]
    return parent, level


def control_search(indptr, indices, root: int):
    """The control: the reference ending one level early (its deepest
    level unreached), which breaks the guarantee that every vertex
    reachable from the key is reached."""
    parent, level = plain_bfs(indptr, indices, root)
    deepest = level == level.max()
    if int(level.max()) > 0:
        parent[deepest] = -1
        level[deepest] = -1
    return parent, level


def edge_keys(indptr: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Sorted `row * V + col` of every directed CSR edge."""
    n = indptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   indptr[1:] - indptr[:-1])
    return torch.sort(rows * n + indices).values


class Judge:
    """Judges the program's answers against the reference on one graph."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor):
        self.indptr = indptr
        self.indices = indices
        self.n = indptr.numel() - 1
        self.keys = edge_keys(indptr, indices)

    def faults(self, root: int, parent, level, ref_level=None) -> dict:
        """{level_mismatches, parent_faults} of one answer (`parent`,
        `level`: numpy or tensors of V entries, -1 unreached)."""
        dev = self.indptr.device
        if ref_level is None:
            ref_level = plain_bfs(self.indptr, self.indices, root)[1]
        parent = torch.as_tensor(np.asarray(parent)).to(dev).long()
        level = torch.as_tensor(np.asarray(level)).to(dev).long()
        if parent.shape != (self.n,) or level.shape != (self.n,):
            return {"level_mismatches": self.n, "parent_faults": self.n}
        mism = int((level != ref_level).sum())
        reached = ref_level >= 0
        faults = int(parent[root] != root)
        faults += int((~reached & (parent != -1)).sum())
        v = torch.nonzero(reached).flatten()
        v = v[v != root]
        p = parent[v]
        ok = (p >= 0) & (p < self.n)
        ps = p.clamp(0, self.n - 1)
        ok &= ref_level[ps] == ref_level[v] - 1
        key = v * self.n + ps
        pos = torch.searchsorted(self.keys, key).clamp(max=self.keys.numel() - 1)
        ok &= self.keys[pos] == key
        faults += int((~ok).sum())
        return {"level_mismatches": mism, "parent_faults": faults}

    def reference_level(self, root: int):
        return plain_bfs(self.indptr, self.indices, root)[1]


def judge_answers(judge: Judge, answers, unanswered: int) -> dict:
    """Sum the faults of `answers` [(root, parent, level), ...] and add the
    queries that never came back."""
    out = {"level_mismatches": 0, "parent_faults": 0,
           "unanswered": int(unanswered)}
    for root, parent, level in answers:
        got = judge.faults(int(root), parent, level)
        out["level_mismatches"] += got["level_mismatches"]
        out["parent_faults"] += got["parent_faults"]
    return out


def check_lines(numbers: dict) -> dict:
    """{name: {value, limit}} for the result line's last key."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}


def is_correct(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())

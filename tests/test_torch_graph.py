"""The port's graph generators and numpy oracle against the JAX package's.

Same seed, same arrays: every comparison is exact (integers throughout).
"""
import numpy as np
import pytest

from repro.core import graph as JG
from repro.core import ref as JR
from repro.engine import Engine as JaxEngine
from repro_torch.core import graph as TG
from repro_torch.core import ref as TR


def _same(a, b):
    assert a.num_vertices == b.num_vertices
    for field in ("indptr", "indices", "degrees"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("scale,seed,kw", [
    (6, 0, {}), (8, 1, {}), (9, 7, {}), (8, 3, dict(edgefactor=4)),
    (7, 5, dict(a=0.5, b=0.22, c=0.22)), (7, 2, dict(permute=False)),
    (7, 4, dict(sort_by_degree=False)),
])
def test_rmat_matches_reference(scale, seed, kw):
    _same(TG.rmat(scale, seed=seed, **kw), JG.rmat(scale, seed=seed, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_random_matches_reference(seed):
    _same(TG.uniform_random(300, 900, seed=seed),
          JG.uniform_random(300, 900, seed=seed))


@pytest.mark.parametrize("seed", [0, 3])
def test_from_edges_matches_reference(seed):
    """Self loops, duplicates and both orientations of an edge collapse the
    same way; with and without degree sorting and symmetrisation."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    for kw in ({}, dict(sort_by_degree=False), dict(symmetrize=False)):
        _same(TG.from_edges(src, dst, 60, **kw),
              JG.from_edges(src, dst, 60, **kw))
    empty = np.array([], np.int64)
    _same(TG.from_edges(empty, empty, 9), JG.from_edges(empty, empty, 9))


def test_sort_adjacency_matches_reference():
    g = TG.rmat(8, seed=9, sort_by_degree=False)
    jg = JG.rmat(8, seed=9, sort_by_degree=False)
    _same(TG.sort_adjacency_by_degree(g), JG.sort_adjacency_by_degree(jg))


@pytest.mark.parametrize("seed", [0, 7])
def test_port_oracle_matches_reference(seed):
    g, jg = TG.rmat(8, seed=seed), JG.rmat(8, seed=seed)
    for root in (0, 17, int(np.argmax(g.degrees))):
        np.testing.assert_array_equal(TR.bfs_levels(g, root),
                                      JR.bfs_levels(jg, root))
    assert TR.teps(g, 0.5) == JR.teps(jg, 0.5)


def test_port_validate_parents_accepts_and_rejects():
    g, jg = TG.rmat(8, seed=2), JG.rmat(8, seed=2)
    root = int(np.argmax(g.degrees))
    res = JaxEngine(jg).bfs(root)
    parent, level = res.parent[0], res.level[0]
    TR.validate_parents(g, root, parent, level)
    bad = parent.copy()
    child = int(np.flatnonzero(level == 2)[0])
    bad[child] = root                       # root is not a neighbour of child
    with pytest.raises(AssertionError):
        TR.validate_parents(g, root, bad)
    with pytest.raises(AssertionError):
        TR.validate_parents(g, root, parent, np.where(level > 0, 1, level))

"""The plain reference BFS and the comparison that decides `correct`, on
hand-made graphs and a scale-10 Kronecker graph on the CPU; and the
control, which the comparison has to fail."""
from collections import deque

import numpy as np
import pytest

import portbench_tiny  # noqa: F401  (puts the repo and src on sys.path)
from portbench import graph500, reference


def _csr(n, edges):
    adj = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(a) for a in adj])
    indices = np.array([x for a in adj for x in a], np.int32)
    return graph500.Csr(n, indptr, indices, np.diff(indptr).astype(np.int32))


def _levels(csr, root):
    level = np.full(csr.num_vertices, -1)
    level[root] = 0
    q = deque([root])
    while q:
        v = q.popleft()
        for u in csr.indices[csr.indptr[v]:csr.indptr[v + 1]]:
            if level[u] < 0:
                level[u] = level[v] + 1
                q.append(int(u))
    return level


HAND = {
    "path": (5, [(0, 1), (1, 2), (2, 3), (3, 4)], 2, [2, 1, 0, 1, 2]),
    "star": (5, [(0, 1), (0, 2), (0, 3), (0, 4)], 3, [1, 2, 2, 0, 2]),
    "two parts": (6, [(0, 1), (1, 2), (3, 4)], 4, [-1, -1, -1, 1, 0, -1]),
    "cycle": (6, [(i, (i + 1) % 6) for i in range(6)], 0,
              [0, 1, 2, 3, 2, 1]),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_plain_bfs_hand_made(name):
    n, edges, root, want = HAND[name]
    csr = _csr(n, edges)
    parent, level = reference.plain_bfs(*csr.on("cpu"), root)
    assert level.tolist() == want
    judge = reference.Judge(*csr.on("cpu"))
    assert judge.faults(root, parent.numpy(), level.numpy()) == {
        "level_mismatches": 0, "parent_faults": 0}


@pytest.fixture(scope="module")
def rmat():
    gen = {"kind": "kronecker", "scale": 10, "edgefactor": 16,
           "a": 0.57, "b": 0.19, "c": 0.19}
    csr = graph500.make_graph(gen, 99, "cpu")
    return csr, reference.Judge(*csr.on("cpu")), \
        graph500.sample_roots(csr.degrees, 6, [99, 1])


def test_plain_bfs_rmat_levels_and_graph500_tree(rmat):
    csr, judge, keys = rmat
    for k in keys:
        parent, level = reference.plain_bfs(judge.indptr, judge.indices,
                                            int(k))
        np.testing.assert_array_equal(level.numpy(), _levels(csr, int(k)))
        p, lv = parent.numpy(), level.numpy()
        assert p[k] == k
        assert ((p >= 0) == (lv >= 0)).all()
        for v in np.flatnonzero(lv > 0):
            row = csr.indices[csr.indptr[v]:csr.indptr[v + 1]]
            assert p[v] in row and lv[p[v]] == lv[v] - 1
        assert judge.faults(int(k), p, lv)["parent_faults"] == 0


def test_judge_takes_any_valid_parent(rmat):
    csr, judge, keys = rmat
    k = int(keys[0])
    parent, level = reference.plain_bfs(judge.indptr, judge.indices, k)
    p, lv = parent.numpy().copy(), level.numpy()
    # the largest-id neighbour one level up is as good as the smallest
    for v in np.flatnonzero(lv > 0):
        row = csr.indices[csr.indptr[v]:csr.indptr[v + 1]]
        p[v] = max(u for u in row if lv[u] == lv[v] - 1)
    assert judge.faults(k, p, lv) == {"level_mismatches": 0,
                                      "parent_faults": 0}


def _broken(kind, p, lv, csr):
    p, lv = p.copy(), lv.copy()
    v = int(np.flatnonzero(lv == lv.max())[0])
    if kind == "parent not a neighbour":
        row = set(csr.indices[csr.indptr[v]:csr.indptr[v + 1]].tolist())
        p[v] = next(u for u in range(csr.num_vertices)
                    if u not in row and lv[u] == lv[v] - 1)
    elif kind == "parent on the same level":
        p[v] = int(np.flatnonzero((lv == lv[v]) & (np.arange(len(lv)) != v))[0])
    elif kind == "vertex left unreached":
        p[v], lv[v] = -1, -1
    elif kind == "level off by one":
        lv[v] += 1
    elif kind == "root not its own parent":
        root = int(np.flatnonzero(lv == 0)[0])
        p[root] = -1
    elif kind == "unreached vertex with a parent":
        u = int(np.flatnonzero(lv < 0)[0])
        p[u] = v
    return p, lv


@pytest.mark.parametrize("kind", [
    "parent not a neighbour", "parent on the same level",
    "vertex left unreached", "level off by one", "root not its own parent",
    "unreached vertex with a parent"])
def test_judge_catches(rmat, kind):
    csr, judge, keys = rmat
    k = int(keys[1])
    parent, level = reference.plain_bfs(judge.indptr, judge.indices, k)
    p, lv = _broken(kind, parent.numpy(), level.numpy(), csr)
    got = reference.judge_answers(judge, [(k, p, lv)], 0)
    assert not reference.is_correct(got), got


def test_control_fails_the_comparison_on_every_key(rmat):
    # the control at test size: the reference ending one level early
    _csr_, judge, keys = rmat
    for k in keys:
        parent, level = reference.control_search(judge.indptr, judge.indices,
                                                 int(k))
        got = reference.judge_answers(
            judge, [(int(k), parent.numpy(), level.numpy())], 0)
        assert got["level_mismatches"] > 0
        assert not reference.is_correct(got)


def test_unanswered_queries_fail():
    assert not reference.is_correct(
        {"level_mismatches": 0, "parent_faults": 0, "unanswered": 1})
    lines = reference.check_lines(
        {"level_mismatches": 0, "parent_faults": 0, "unanswered": 0})
    assert list(lines) == ["level_mismatches", "parent_faults", "unanswered"]
    assert all(x["limit"] == 0 for x in lines.values())


def test_answer_of_the_wrong_shape_fails(rmat):
    _csr_, judge, keys = rmat
    got = judge.faults(int(keys[0]), np.zeros(3, np.int32),
                       np.zeros(3, np.int32))
    assert got["level_mismatches"] > 0


def test_reference_imports_nothing_of_the_port():
    import ast
    import inspect
    for mod in (reference, graph500):
        tree = ast.parse(inspect.getsource(mod))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [x for x in names if x.split(".")[0] in
                    ("repro_torch", "repro", "jax")], names

"""The benchmark's Graph500 inputs at scale 10 on the CPU: the generator's
determinism, the port's `Graph` conventions, the search keys and each
component's edge count."""
from collections import deque

import numpy as np
import pytest
import torch

import portbench_tiny  # noqa: F401  (puts the repo and src on sys.path)
from portbench import graph500

GEN = {"kind": "kronecker", "scale": 10, "edgefactor": 16,
       "a": 0.57, "b": 0.19, "c": 0.19}


@pytest.fixture(scope="module")
def csr():
    return graph500.make_graph(GEN, 2**31 + 3, "cpu")


def test_same_seed_same_graph_other_seed_other(csr):
    again = graph500.make_graph(GEN, 2**31 + 3, "cpu")
    other = graph500.make_graph(GEN, 2**31 + 4, "cpu")
    np.testing.assert_array_equal(csr.indptr, again.indptr)
    np.testing.assert_array_equal(csr.indices, again.indices)
    assert not (csr.indices.shape == other.indices.shape
                and np.array_equal(csr.indices, other.indices))


def test_port_graph_conventions(csr):
    from repro_torch.core.graph import Graph
    g = Graph(csr.num_vertices, csr.indptr, csr.indices, csr.degrees)
    g.validate()
    assert csr.indptr.dtype == np.int64 and csr.indices.dtype == np.int32
    deg = csr.degrees
    edges = set()
    for v in range(csr.num_vertices):
        row = csr.indices[csr.indptr[v]:csr.indptr[v + 1]]
        assert v not in row, "self-loop"
        assert len(set(row.tolist())) == len(row), "duplicate edge"
        key = np.stack([-deg[row].astype(np.int64), row], axis=1)
        assert [tuple(k) for k in key] == sorted(tuple(k) for k in key), \
            "row not in descending neighbour degree (ties by id)"
        edges.update((v, int(u)) for u in row)
    assert all((u, v) in edges for v, u in edges), "not symmetric"
    assert csr.num_directed_edges > 8 * csr.num_vertices


def test_degree_skew_is_graph500_like(csr):
    # A/B/C 0.57/0.19/0.19: a few hubs, many isolated vertices.
    deg = csr.degrees
    assert deg.max() > 5 * deg[deg > 0].mean()
    assert (deg == 0).sum() > 0.05 * csr.num_vertices


def test_search_keys(csr):
    keys = graph500.sample_roots(csr.degrees, 64, [7, 1])
    assert len(set(keys.tolist())) == 64
    assert (csr.degrees[keys] > 0).all()
    np.testing.assert_array_equal(
        keys, graph500.sample_roots(csr.degrees, 64, [7, 1]))


def _components(csr):
    label = np.full(csr.num_vertices, -1)
    for s in range(csr.num_vertices):
        if label[s] >= 0:
            continue
        label[s] = s
        q = deque([s])
        while q:
            v = q.popleft()
            for u in csr.indices[csr.indptr[v]:csr.indptr[v + 1]]:
                if label[u] < 0:
                    label[u] = s
                    q.append(int(u))
    return label


def test_component_edges_match_a_plain_search(csr):
    label, edges = graph500.component_edges(csr, "cpu")
    want = _components(csr)
    np.testing.assert_array_equal(label.numpy(), want)
    for lab in np.unique(want):
        members = want == lab
        assert int(edges[lab]) == csr.degrees[members].sum() // 2
    assert int(edges.sum()) == csr.num_directed_edges // 2


def test_component_edges_hand_made():
    # 0-1-2 path, 3-4 edge, 5 isolated
    indptr = np.array([0, 1, 3, 4, 5, 6, 6], np.int64)
    indices = np.array([1, 0, 2, 1, 4, 3], np.int32)
    deg = np.diff(indptr).astype(np.int32)
    label, edges = graph500.component_edges(
        graph500.Csr(6, indptr, indices, deg), "cpu")
    assert label.tolist() == [0, 0, 0, 3, 3, 5]
    assert [int(edges[x]) for x in label] == [2, 2, 2, 1, 1, 0]


def test_generator_bit_probabilities():
    gen = torch.Generator().manual_seed(5)
    src, dst = graph500.kronecker_edges(1, 4096, 0.57, 0.19, 0.19, gen,
                                        "cpu")
    pairs = torch.stack([src, dst], 1)
    share = torch.unique(pairs, dim=0, return_counts=True)[1].double()
    share = sorted((share / share.sum()).tolist())
    # the quadrants' shares are {0.57, 0.19, 0.19, 0.05} up to the labels'
    # permutation, which may swap 0 and 1 on both ends alike
    assert share == pytest.approx([0.05, 0.19, 0.19, 0.57], abs=0.02)

"""The port's ELL tiles and frontier helpers against the JAX package's.

Tiles must equal `repro.core.ell.build_ell`'s array for array (bucket
ladder, descending-degree order, CSR slot order, degree-0 rows dropped);
the frontier helpers must give the same integers and bit patterns.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ell as JELL
from repro.core import frontier as JF
from repro.core import graph as JG
from repro_torch.core import ell as TELL
from repro_torch.core import frontier as TF
from repro_torch.core import graph as TG

CPU = torch.device("cpu")


def _cases(G):
    star = G.from_edges(np.zeros(12, np.int64), np.arange(1, 13), 13)
    path = G.from_edges(np.arange(29), np.arange(1, 30), 30)
    edgeless = G.from_edges(np.array([], np.int64), np.array([], np.int64), 9)
    return [("rmat", G.rmat(8, seed=5)), ("star", star), ("path", path),
            ("edgeless", edgeless), ("rmat_wide", G.rmat(10, seed=1))]


PAIRS = list(zip(_cases(TG), _cases(JG)))


@pytest.mark.parametrize("pair", PAIRS, ids=[p[0][0] for p in PAIRS])
def test_build_ell_matches_reference(pair):
    (_, g), (_, jg) = pair
    mine = TELL.build_graph_ell(g, device=CPU)
    ref = JELL.build_graph_ell(jg)
    assert len(mine) == len(ref)
    for t, r in zip(mine, ref):
        for field in ("rows", "deg", "nbrs"):
            x, y = getattr(t, field), np.asarray(getattr(r, field))
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), y, err_msg=field)


@pytest.mark.parametrize("base,growth", [(32, 2), (8, 3)])
def test_build_ell_ladder_and_row_ids(base, growth):
    g, jg = TG.rmat(9, seed=4), JG.rmat(9, seed=4)
    ids = np.arange(g.num_vertices, dtype=np.int32)[::-1].copy()
    mine = TELL.build_ell(g.indptr, g.indices, g.degrees, ids, device=CPU,
                          base=base, growth=growth)
    ref = JELL.build_ell(jg.indptr, jg.indices, jg.degrees, ids, base=base,
                         growth=growth)
    assert TELL.bucket_widths(g.max_degree, base, growth) == \
        JELL.bucket_widths(jg.max_degree, base, growth)
    assert [t.nbrs.shape[1] for t in mine] == [r.nbrs.shape[1] for r in ref]
    for t, r in zip(mine, ref):
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(r.rows))


@pytest.mark.parametrize("hub_deg", [1, 32, 33, 100, 256, 1000])
def test_hub_helpers_match_reference(hub_deg):
    assert TELL.hub_width(hub_deg) == JELL.hub_width(hub_deg)
    assert TELL.hub_degree_floor(hub_deg) == JELL.hub_degree_floor(hub_deg)
    g, jg = TG.rmat(10, seed=1), JG.rmat(10, seed=1)
    tail, hub = TELL.split_tiles(TELL.build_graph_ell(g, device=CPU), hub_deg)
    jtail, jhub = JELL.split_tiles(JELL.build_graph_ell(jg), hub_deg)
    for mine, ref in ((tail, jtail), (hub, jhub)):
        assert [t.nbrs.shape for t in mine] == \
            [tuple(r.nbrs.shape) for r in ref]
        for t, r in zip(mine, ref):
            np.testing.assert_array_equal(t.rows.numpy(), np.asarray(r.rows))


@pytest.mark.parametrize("v", [1, 31, 32, 33, 100, 257])
def test_frontier_helpers_match_reference(v):
    rng = np.random.default_rng(v)
    flags = (rng.random(v) < 0.4).astype(np.uint8)
    deg = rng.integers(0, 1000, v).astype(np.int32)
    tf, jf = torch.from_numpy(flags), jnp.asarray(flags)
    packed = TF.pack(tf)
    assert packed.dtype == torch.uint32
    assert TF.num_words(v) == JF.num_words(v) == packed.shape[0]
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JF.pack(jf)))
    np.testing.assert_array_equal(TF.unpack(packed, v).numpy(),
                                  np.asarray(JF.unpack(JF.pack(jf), v)))
    assert int(TF.popcount(packed)) == int(JF.popcount(JF.pack(jf)))
    assert TF.count(tf).dtype == torch.int32
    assert int(TF.count(tf)) == int(JF.count(jf))
    assert int(TF.edge_count(tf, torch.from_numpy(deg))) == \
        int(JF.edge_count(jf, jnp.asarray(deg)))
    queue, n = TF.compact(tf)
    jqueue, jn = JF.compact(jf)
    assert queue.dtype == torch.int32 and int(n) == int(jn)
    np.testing.assert_array_equal(queue.numpy(), np.asarray(jqueue))


def test_pack_all_ones_sets_the_sign_bit():
    """Bit 31 of a word is flag 32w+31: the int64 build stores 2^32 - 1."""
    packed = TF.pack(torch.ones(64, dtype=torch.uint8))
    assert packed.view(torch.int32).tolist() == [-1, -1]
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(JF.pack(jnp.ones(64, jnp.uint8))))

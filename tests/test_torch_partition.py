"""The port's partitioning and hybrid ELL tiles against the JAX package's.

`make_plan`, `apply_plan` (vectorized in the port), `unpermute`,
`unpermute_ids`, `hub_tail_masses` and the stacked hybrid tiles
(`hybrid_ell_numpy`, every rank's `build_hybrid_ell`) must equal the JAX
functions field by field, dtype included: the three strategies, P in
{1, 2, 3, 4, 8}, RMAT 9 and 10, star, path and edgeless graphs. Both sides
are numpy, so everything runs in this process.
"""
import numpy as np
import pytest
import torch

from repro.core import ell as JELL
from repro.core import graph as JG
from repro.core import partition as JPT
from repro_torch.core import ell as TELL
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT

CPU = torch.device("cpu")
PARTS = (1, 2, 3, 4, 8)
PG_FIELDS = ("local_indptr", "local_indices", "local_row_gid", "deg_ext")


def _cases(G):
    star = G.from_edges(np.zeros(40, np.int64), np.arange(1, 41), 41)
    path = G.from_edges(np.arange(59), np.arange(1, 60), 60)
    edgeless = G.from_edges(np.array([], np.int64), np.array([], np.int64),
                            20)
    return [("rmat9", G.rmat(9, seed=7)), ("rmat10", G.rmat(10, seed=3)),
            ("star", star), ("path", path), ("edgeless", edgeless)]


PAIRS = list(zip(_cases(TG), _cases(JG)))
IDS = [p[0][0] for p in PAIRS]


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def _plans(pair, strategy, p):
    (_, g), (_, jg) = pair
    return TPT.make_plan(g, p, strategy), JPT.make_plan(jg, p, strategy)


@pytest.mark.parametrize("strategy", TPT.STRATEGIES)
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_plan_and_blocks_match_reference(pair, strategy):
    (_, g), (_, jg) = pair
    for p in PARTS:
        mine, ref = _plans(pair, strategy, p)
        for f in ("strategy", "n_parts", "v_orig", "v_pad", "hub_count",
                  "leaves_per_part"):
            assert getattr(mine, f) == getattr(ref, f), (p, f)
        _same(mine.perm_new_to_old, ref.perm_new_to_old, f"P={p} perm")
        pg, jpg = TPT.apply_plan(g, mine), JPT.apply_plan(jg, ref)
        assert pg.num_local_rows == jpg.num_local_rows
        assert pg.total_directed_edges == jpg.total_directed_edges
        assert pg.n_parts == jpg.n_parts == p
        for f in PG_FIELDS:
            _same(getattr(pg, f), getattr(jpg, f), f"P={p} {f}")


@pytest.mark.parametrize("strategy", TPT.STRATEGIES)
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_hybrid_ell_matches_reference(pair, strategy):
    (_, g), (_, jg) = pair
    for p in PARTS:
        mine, ref = _plans(pair, strategy, p)
        pg, jpg = TPT.apply_plan(g, mine), JPT.apply_plan(jg, ref)
        stacked = TELL.hybrid_ell_numpy(pg)
        want = JELL.build_hybrid_ell(jpg)
        assert len(stacked) == len(want), f"P={p}: bucket count"
        for b, (got, w) in enumerate(zip(stacked, want)):
            for name, x, y in zip(("rows", "deg", "nbrs"), got, w):
                _same(x, y, f"P={p} bucket {b} {name}")
        for rank in range(p):
            tiles = TELL.build_hybrid_ell(pg, rank, device=CPU)
            assert len(tiles) == len(stacked)
            for t, s in zip(tiles, stacked):
                for x, y in zip(t, s):
                    _same(x.numpy(), y[rank], f"P={p} rank {rank}")


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_unpermute_matches_reference(pair):
    rng = np.random.default_rng(0)
    for strategy in TPT.STRATEGIES:
        mine, ref = _plans(pair, strategy, 4)
        vals = rng.integers(-1, mine.v_pad + 2, mine.v_pad).astype(np.int32)
        _same(TPT.unpermute(mine, vals), JPT.unpermute(ref, vals), strategy)
        _same(TPT.unpermute(mine, vals, fill=7),
              JPT.unpermute(ref, vals, fill=7), strategy)
        _same(TPT.unpermute_ids(mine, vals), JPT.unpermute_ids(ref, vals),
              strategy)


@pytest.mark.parametrize("hub_deg", [1, 32, 33, 256, 4096])
def test_hub_tail_masses_match_reference(hub_deg):
    for (_, g), (_, jg) in PAIRS:
        assert TPT.hub_tail_masses(g.degrees, hub_deg) == \
            JPT.hub_tail_masses(jg.degrees, hub_deg)


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown strategy"):
        TPT.make_plan(PAIRS[0][0][1], 2, "striped")

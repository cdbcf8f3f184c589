"""The hub/tail split (`BFSConfig(hub_split=True)`) against the JAX package.

`repro_torch.engine.Engine(..., device="cpu")` and `repro.engine.Engine`
run the same split searches on the skewed RMAT graph of
`tests/test_hetero_split.py` with `hub_deg` 32 (every row is hub) and 256,
every heuristic, batched and in Graph500 mode: parents, levels and every
row key, the hub ones included, must be equal bit for bit
(`tests/test_torch_hub_split_graphs.py` does the same on its star, path
and edgeless graphs). Under beamer the two sides of one lane take
different directions on some levels; that case is checked on its own. The
per-step test carries a mid-search JAX `BatchState` across with `interop`
and compares one split step of every variant, all 20 fields. The hub
kernel's plain versions are held against the JAX wrappers in interpret
mode.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bfs as JB
from repro.core import ell as JELL
from repro.core import graph as JG
from repro.engine import Engine as JaxEngine
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import CohortBatchBackend, Engine
from repro_torch.kernels import hub as thub
from repro_torch.kernels import ops

CPU = torch.device("cpu")
HEURISTICS = ["paper", "beamer", "topdown", "bottomup"]
ROW_KEYS = ("level", "direction", "td_lanes", "bu_lanes", "frontier_size",
            "frontier_edges", "active_lanes", "batch", "lane_frontier",
            "lane_edges", "lane_direction", "lane_active",
            "lane_hub_direction", "lane_hub_frontier", "hub_td_lanes",
            "hub_bu_lanes", "frontier_hub", "frontier_tail")


def _graphs(G):
    return {"rmat": G.rmat(9, seed=3), "beamer": G.rmat(10, seed=1)}


T_GRAPHS, J_GRAPHS = _graphs(TG), _graphs(JG)
ROOTS = {"rmat": [int(np.argmax(T_GRAPHS["rmat"].degrees)), 0, 7, 123],
         "beamer": [int(np.argmax(T_GRAPHS["beamer"].degrees)), 0, 3, 17]}


def _rows(res):
    return [{k: r[k] for k in ROW_KEYS} for r in res.batch_level_stats]


def _run_both(gname, cfg_kw, batched):
    mine = Engine(T_GRAPHS[gname], device="cpu").bfs(
        ROOTS[gname], TB.BFSConfig(hub_split=True, **cfg_kw),
        batched=batched, validate=True)
    ref = JaxEngine(J_GRAPHS[gname]).bfs(
        ROOTS[gname], JB.BFSConfig(hub_split=True, **cfg_kw), batched=batched)
    np.testing.assert_array_equal(mine.parent, ref.parent, err_msg=cfg_kw)
    np.testing.assert_array_equal(mine.level, ref.level, err_msg=cfg_kw)
    np.testing.assert_array_equal(mine.num_levels, ref.num_levels)
    np.testing.assert_array_equal(mine.edges_traversed, ref.edges_traversed)
    if batched:
        assert _rows(mine) == _rows(ref), cfg_kw
    return mine


@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_split_engine_matches_reference(heuristic):
    """RMAT, batched and in Graph500 mode, hub_deg 32 and 256.
    (`tests/test_torch_hub_split_graphs.py` runs the star, path and
    edgeless graphs.)"""
    for hub_deg in (32, 256):
        kw = dict(heuristic=heuristic, hub_deg=hub_deg)
        res = _run_both("rmat", kw, True)
        if hub_deg == 256:
            assert any(r["frontier_hub"] for r in res.batch_level_stats)
            assert any(r["frontier_tail"] for r in res.batch_level_stats)
        _run_both("rmat", kw, False)


def test_beamer_sides_disagree_match_reference():
    """Beamer's side-local `mu` flips the hub side bottom-up on levels where
    the tail still pushes: the port takes the same per-side decisions and
    finds the same parents, batched and in Graph500 mode."""
    kw = dict(heuristic="beamer", hub_deg=64)
    res = _run_both("beamer", kw, True)
    disagree = [
        row["level"] for row in res.batch_level_stats
        if any(a and hd != td for a, hd, td in zip(row["lane_active"],
                                                   row["lane_hub_direction"],
                                                   row["lane_direction"]))]
    assert disagree, "expected levels where hub and tail choose differently"
    assert any(r["direction"] == "mixed" for r in res.batch_level_stats)
    _run_both("beamer", kw, False)


# ---------------------------------------------------------------- one step --

def _state_arrays(st, fields=TB.BATCH_STATE_FIELDS):
    if isinstance(st, TB.BatchState):
        return {f: getattr(st, f).numpy() for f in fields}
    leaves, _ = st.tree_flatten()
    return {f: np.asarray(x) for f, x in zip(fields, leaves)}


def test_one_split_step_per_variant_matches_reference():
    """A JAX split state after k levels, carried across with interop: one
    port step of each variant equals the JAX step, all 20 fields."""
    jg = J_GRAPHS["beamer"]
    kw = dict(heuristic="beamer", hub_split=True, hub_deg=64)
    jcfg = JB.BFSConfig(backend_kernels=False, **kw)
    tcfg = TB.BFSConfig(**kw)
    jdg = JB.DeviceGraph.from_graph(jg)
    g = interop.graph_from_arrays(jg.num_vertices, jg.indptr, jg.indices,
                                  jg.degrees)
    tdg = TB.DeviceGraph.from_graph(g, CPU)
    ell = interop.ell_from_arrays(
        [tuple(np.asarray(a) for a in t) for t in JELL.build_graph_ell(jg)],
        CPU)
    roots = np.full(8, ROOTS["beamer"][0], np.int32)
    roots[:4] = ROOTS["beamer"]
    active = np.arange(8) < 4
    jst = JB.init_batch(jdg, jcfg, jnp.asarray(roots), jnp.asarray(active))
    tst0 = TB.init_batch(tdg, tcfg, torch.from_numpy(roots),
                         torch.from_numpy(active))
    for f, want in _state_arrays(jst).items():
        np.testing.assert_array_equal(_state_arrays(tst0)[f], want,
                                      err_msg=f"init {f}")
    jsteps = {v: jax.jit(JB.make_batch_step(jdg, jcfg, v))
              for v in JB.BATCH_VARIANTS}
    tsteps = {v: TB.make_batch_step(tdg, tcfg, v, ell)
              for v in TB.BATCH_VARIANTS}
    seen = set()
    for k in range(6):
        tst = interop.batch_state_from_arrays(_state_arrays(jst), CPU)
        for variant in TB.BATCH_VARIANTS:
            want = _state_arrays(jsteps[variant](jst))
            got = _state_arrays(tsteps[variant](tst))
            for f in TB.BATCH_STATE_FIELDS:
                assert got[f].dtype == want[f].dtype, (k, variant, f)
                np.testing.assert_array_equal(got[f], want[f],
                                              err_msg=f"{k} {variant} {f}")
        sync = jax.device_get(JB.batch_scalars(jst))
        variant = CohortBatchBackend.variant_for(int(sync["td_next"]),
                                                 int(sync["bu_next"]))
        seen.add(variant)
        jst = jsteps[variant](jst)
    assert "mixed" in seen, seen


# -------------------------------------------------------------- hub kernel --

def _hub_inputs(seed, b, r, w, v, masked, density):
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, w + 1, (b, r)).astype(np.int32)
    deg[rng.random((b, r)) < 0.25] = 0              # degree-0 rows
    if masked:
        deg[b - masked:] = 0                        # lanes out of the cohort
    nbrs = rng.integers(-2, v + 2, (r, w)).astype(np.int32)   # clipped ids
    frontier = (rng.random((b, v)) < density).astype(np.uint8)
    return deg, nbrs, frontier


def _eq(mine, ref):
    mine = mine.numpy()
    ref = np.asarray(ref)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)


# (B, R, W, V, masked lanes, frontier density): ragged R, W not a multiple
# of 128, masked lanes, sparse frontiers so some rows find nothing.
HUB_SHAPES = [(1, 5, 300, 37, 0, 0.05), (8, 13, 256, 1000, 3, 0.004),
              (3, 9, 1000, 4099, 1, 0.0005), (2, 3, 32, 50, 0, 0.1)]


@pytest.mark.parametrize("b,r,w,v,masked,density", HUB_SHAPES)
def test_hub_plain_matches_pallas(b, r, w, v, masked, density):
    deg, nbrs, fr = _hub_inputs(r * 13 + w, b, r, w, v, masked, density)
    f1, p1 = ops.hub_bottomup_batch(torch.from_numpy(deg),
                                    torch.from_numpy(nbrs),
                                    torch.from_numpy(fr))
    f2, p2 = jops.hub_bottomup_batch(jnp.asarray(deg), jnp.asarray(nbrs),
                                     jnp.asarray(fr), interpret=True)
    _eq(f1, f2)
    _eq(p1, p2)
    f1, p1 = ops.hub_bottomup(torch.from_numpy(deg[0]),
                              torch.from_numpy(nbrs), torch.from_numpy(fr[0]))
    f2, p2 = jops.hub_bottomup(jnp.asarray(deg[0]), jnp.asarray(nbrs),
                               jnp.asarray(fr[0]), interpret=True)
    _eq(f1, f2)
    _eq(p1, p2)


def test_hub_plain_chunks_rows(monkeypatch):
    """The plain version expands at most about PLAIN_CHUNK_SLOTS slots at
    once; chunked over rows it gives the same result."""
    deg, nbrs, fr = _hub_inputs(5, 4, 37, 300, 900, 1, 0.003)
    args = [torch.from_numpy(x) for x in (deg, nbrs, fr)]
    whole = thub.hub_bottomup_batch_plain(*args)
    monkeypatch.setattr(thub, "PLAIN_CHUNK_SLOTS", 4 * 300 * 5)
    chunked = thub.hub_bottomup_batch_plain(*args)
    assert all(torch.equal(a, c) for a, c in zip(whole, chunked))
    assert int(whole[0].sum()) > 0 and int((whole[0] == 0).sum()) > 0


def test_hub_empty_tiles():
    z = torch.zeros
    for b, r in ((0, 5), (3, 0)):
        found, parent = ops.hub_bottomup_batch(z((b, r), dtype=torch.int32),
                                               z((r, 256), dtype=torch.int32),
                                               z((b, 50), dtype=torch.uint8))
        assert found.shape == parent.shape == (b, 0)
        assert (found.dtype, parent.dtype) == (torch.uint8, torch.int32)
    found, parent = ops.hub_bottomup(z(0, dtype=torch.int32),
                                     z((0, 256), dtype=torch.int32),
                                     z(50, dtype=torch.uint8))
    assert found.shape == parent.shape == (0,)

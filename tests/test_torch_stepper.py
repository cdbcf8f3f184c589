"""The single-root path: `repro_torch.core.bfs` and `backend="stepper"`
against the JAX package.

`bfs()`, `bfs_instrumented` and `Engine.bfs(backend="stepper")` search the
same graphs from the same roots in both packages; parents, levels and the
rows' level, direction and frontier fields must be equal bit for bit. The
per-step test carries a mid-search JAX `BFSState` across with `interop`
and compares one port step, all 10 fields. The single-lane kernels' plain
versions are held against the JAX wrappers in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bfs as JB
from repro.core import ell as JELL
from repro.core import graph as JG
from repro.engine import Engine as JaxEngine
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import Engine, QueryCancelled, QueryControl
from repro_torch.engine.level_loop import host_sync
from repro_torch.kernels import ops

CPU = torch.device("cpu")
HEURISTICS = ["paper", "beamer", "topdown", "bottomup"]
ROW_KEYS = ("level", "direction", "frontier_size", "frontier_edges")


def _graphs(G):
    path = G.from_edges(np.arange(39, dtype=np.int64),
                        np.arange(1, 40, dtype=np.int64), 40)
    return {"rmat": G.rmat(9, seed=3), "path": path}


T_GRAPHS, J_GRAPHS = _graphs(TG), _graphs(JG)
ROOTS = {"rmat": [int(np.argmax(T_GRAPHS["rmat"].degrees)), 0, 123],
         "path": [0, 20]}


def _rows(stats):
    return [{k: r[k] for k in ROW_KEYS} for r in stats]


@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("gname", list(T_GRAPHS))
def test_bfs_matches_reference(gname, heuristic):
    tg, jg = T_GRAPHS[gname], J_GRAPHS[gname]
    dg = TB.DeviceGraph.from_graph(tg, CPU)
    for root in ROOTS[gname]:
        mine = TB.bfs(dg, root, TB.BFSConfig(heuristic=heuristic))
        ref = JB.bfs(jg, root, JB.BFSConfig(heuristic=heuristic))
        np.testing.assert_array_equal(mine[0], ref[0])
        np.testing.assert_array_equal(mine[1], ref[1])
    # a Graph on the CPU by request, and max_levels cutting the search
    cut = TB.BFSConfig(heuristic=heuristic, max_levels=2)
    mine = TB.bfs(tg, ROOTS[gname][0], cut, device="cpu")
    ref = JB.bfs(jg, ROOTS[gname][0], JB.BFSConfig(heuristic=heuristic,
                                                   max_levels=2))
    np.testing.assert_array_equal(mine[1], ref[1])


@pytest.mark.parametrize("heuristic", ["paper", "beamer"])
def test_bfs_instrumented_matches_reference(heuristic):
    tg, jg = T_GRAPHS["rmat"], J_GRAPHS["rmat"]
    root = ROOTS["rmat"][0]
    p1, l1, s1 = TB.bfs_instrumented(tg, root,
                                     TB.BFSConfig(heuristic=heuristic),
                                     device="cpu")
    p2, l2, s2 = JB.bfs_instrumented(jg, root,
                                     JB.BFSConfig(heuristic=heuristic))
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(l1, l2)
    assert _rows(s1) == _rows(s2)
    assert {r["direction"] for r in s1} == {"td", "bu"}
    assert all(r["exchange_s"] == 0.0 and r["compute_s"] == r["seconds"]
               for r in s1)
    assert set(s1[0]) == set(s2[0])


@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_engine_stepper_matches_reference(heuristic):
    tg, jg = T_GRAPHS["rmat"], J_GRAPHS["rmat"]
    roots = ROOTS["rmat"]
    mine = Engine(tg, device="cpu").bfs(
        roots, TB.BFSConfig(heuristic=heuristic), backend="stepper",
        validate=True)
    ref = JaxEngine(jg).bfs(roots, JB.BFSConfig(heuristic=heuristic),
                            backend="stepper", n_parts=1)
    assert mine.backend == "stepper" and mine.n_parts == 1
    np.testing.assert_array_equal(mine.parent, ref.parent)
    np.testing.assert_array_equal(mine.level, ref.level)
    np.testing.assert_array_equal(mine.num_levels, ref.num_levels)
    np.testing.assert_array_equal(mine.edges_traversed, ref.edges_traversed)
    assert [_rows(s) for s in mine.per_level_stats] == \
        [_rows(s) for s in ref.per_level_stats]
    assert [set(t) for t in mine.timings] == [set(t) for t in ref.timings]
    assert len(mine.per_root_seconds) == len(roots)


def test_stepper_streaming_and_cancellation():
    g = T_GRAPHS["rmat"]
    eng = Engine(g, device="cpu")
    roots = ROOTS["rmat"]
    seen = []
    res = eng.bfs(roots, backend="stepper",
                  on_level=lambda i, row: seen.append((i, row)))
    assert [row for _, row in seen] == \
        [row for stats in res.per_level_stats for row in stats]
    assert [i for i, _ in seen] == [i for i, s in
                                    enumerate(res.per_level_stats) for _ in s]
    ctl = QueryControl()

    def cancel_second_root(i, row):
        if i == 1 and row["level"] == 2:
            ctl.cancel()

    with pytest.raises(QueryCancelled) as info:
        eng.bfs(roots, backend="stepper", on_level=cancel_second_root,
                control=ctl)
    done, partial = info.value.per_level_stats
    assert len(done) == len(res.per_level_stats[0]) and len(partial) == 2
    # the warm-up of a plan not warmed yet honours the control too, and an
    # aborted warm-up is not recorded
    ctl = _CancelAfter(2)          # the entry check, then warm-up level 1
    cfg = TB.BFSConfig(heuristic="beamer")
    with pytest.raises(QueryCancelled) as info:
        eng.bfs(roots, cfg, backend="stepper", control=ctl)
    assert [len(s) for s in info.value.per_level_stats] == [1]
    assert ("stepper_warm", cfg, True) not in eng.session._warmed


class _CancelAfter(QueryControl):
    """Passes `n` checks, then cancels."""

    def __init__(self, n):
        super().__init__()
        self.n = n

    def check(self):
        self.n -= 1
        if self.n < 0:
            raise QueryCancelled()


# ---------------------------------------------------------------- one step --

def test_one_step_matches_reference():
    """A JAX state after k levels, carried across with interop: one port
    step equals the JAX step, all 10 fields, in both directions."""
    jg = J_GRAPHS["rmat"]
    jcfg = JB.BFSConfig(heuristic="paper", backend_kernels=False)
    tcfg = TB.BFSConfig(heuristic="paper")
    jdg = JB.DeviceGraph.from_graph(jg)
    g = interop.graph_from_arrays(jg.num_vertices, jg.indptr, jg.indices,
                                  jg.degrees)
    tdg = TB.DeviceGraph.from_graph(g, CPU)
    ell = interop.ell_from_arrays(
        [tuple(np.asarray(a) for a in t) for t in JELL.build_graph_ell(jg)],
        CPU)
    jstep = JB.make_level_step(jdg, jcfg)
    tstep = TB.make_level_step(tdg, tcfg, ell)
    jst = JB.init_state(jdg, jnp.int32(ROOTS["rmat"][0]))
    directions = set()
    while int(jst.nf) > 0:
        leaves, _ = jst.tree_flatten()
        arrays = {f: np.asarray(x) for f, x in zip(TB.BFS_STATE_FIELDS,
                                                   leaves)}
        tst = interop.bfs_state_from_arrays(arrays, CPU)
        bu = host_sync(TB.state_scalars(tdg, tcfg, tst))["bu_next"]
        directions.add(bu)
        jst = jstep(jst)
        got = tstep(tst, bu)
        for f, want in zip(TB.BFS_STATE_FIELDS, jst.tree_flatten()[0]):
            got_f = getattr(got, f).numpy()
            want = np.asarray(want)
            assert got_f.dtype == want.dtype and got_f.shape == want.shape, f
            np.testing.assert_array_equal(got_f, want, err_msg=f)
    assert directions == {False, True}
    with pytest.raises(KeyError, match="fields missing"):
        interop.bfs_state_from_arrays({"visited": arrays["visited"]}, CPU)


# ------------------------------------------------------ single-lane kernels --

def _lane(seed, r, w, v, density=0.1):
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, w + 1, r).astype(np.int32)
    deg[rng.random(r) < 0.25] = 0                      # degree-0 rows
    nbrs = rng.integers(-2, v + 2, (r, w)).astype(np.int32)   # clipped ids
    table = (rng.random(v) < density).astype(np.uint8)
    return deg, nbrs, table


def _eq(mine, ref):
    mine = mine.numpy()
    ref = np.asarray(ref)
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)


# (R, W, V, slab): ragged R and V, W not a multiple of the slab.
LANE_SHAPES = [(5, 32, 37, 32), (130, 40, 257, 32), (64, 33, 1000, 8)]


@pytest.mark.parametrize("r,w,v,slab", LANE_SHAPES)
def test_single_lane_kernels_match_pallas(r, w, v, slab):
    deg, nbrs, fr = _lane(r * 7 + w, r, w, v)
    f1, p1 = ops.bottomup(torch.from_numpy(deg), torch.from_numpy(nbrs),
                          torch.from_numpy(fr), slab=slab)
    f2, p2 = jops.bottomup(jnp.asarray(deg), jnp.asarray(nbrs),
                           jnp.asarray(fr), slab=slab, interpret=True)
    _eq(f1, f2)
    _eq(p1, p2)
    assert int(f1.sum()) > 0
    vis = (np.random.default_rng(v).random(v) < 0.5).astype(np.uint8)
    fresh1, dst1 = ops.topdown(torch.from_numpy(deg), torch.from_numpy(nbrs),
                               torch.from_numpy(vis))
    fresh2, dst2 = jops.topdown(jnp.asarray(deg), jnp.asarray(nbrs),
                                jnp.asarray(vis), interpret=True)
    _eq(fresh1, fresh2)
    _eq(dst1, dst2)
    vdeg = np.random.default_rng(w).integers(0, 5000, v).astype(np.int32)
    got = ops.frontier_fused(torch.from_numpy(fr), torch.from_numpy(vdeg))
    want = jops.frontier_fused(jnp.asarray(fr), jnp.asarray(vdeg),
                               interpret=True)
    for a, b in zip(got, want):
        _eq(a, b)
    assert got[1].dim() == got[2].dim() == 0


def test_single_lane_empty_inputs():
    z = torch.zeros
    found, parent = ops.bottomup(z(0, dtype=torch.int32),
                                 z((0, 32), dtype=torch.int32),
                                 z(50, dtype=torch.uint8))
    assert found.shape == parent.shape == (0,)
    assert (found.dtype, parent.dtype) == (torch.uint8, torch.int32)
    fresh, dst = ops.topdown(z(0, dtype=torch.int32),
                             z((0, 32), dtype=torch.int32),
                             z(50, dtype=torch.uint8))
    assert fresh.shape == dst.shape == (0, 32)
    assert (fresh.dtype, dst.dtype) == (torch.uint8, torch.int32)
    packed, nf, mf = ops.frontier_fused(z(0, dtype=torch.uint8),
                                        z(0, dtype=torch.int32))
    jp, jn, jm = jops.frontier_fused(jnp.zeros(0, jnp.uint8),
                                     jnp.zeros(0, jnp.int32), interpret=True)
    assert packed.shape == tuple(jp.shape) and packed.dtype == torch.uint32
    assert nf.dim() == mf.dim() == 0 and int(nf) == int(jn) == int(mf) == 0
    assert int(jm) == 0

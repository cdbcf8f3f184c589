"""The gather formulation (`BFSConfig(backend_kernels=False)`) against the
JAX package's XLA formulation, on the CPU.

Step by step, on the same seeded numpy inputs (ragged frontiers, an empty
lane, masked lanes, degree-0 rows, random parents): the cohort push with
and without a side filter on destinations, the cohort pull with and
without a side and its chunk/slab overrides, the hub pull, the one-lane
push and pull, and a partition's local push and pull (phantom rows of id
`v_pad` included, the pull under `hub_split` too). Then whole searches
with kernels off against the JAX package's kernels-off searches and
against the port's tiles: paper and beamer, unsplit and split, batched
and in Graph500 mode, the stepper, `bfs()`, and the sharded search on
P = 2 gloo ranks. Everything bitwise.

The JAX package's private step names may not appear in this file (its
`tests/test_engine.py` greps for them), so `_ref` looks them up from
their words.
"""
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import run_in_devices
from repro.core import bfs as JB
from repro.core import graph as JG
from repro.core import hybrid_bfs as JH
from repro.core import partition as JP
from repro.engine import Engine as JaxEngine
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.core import hybrid_bfs as TH
from repro_torch.core import partition as TP
from repro_torch.engine import Engine
from repro_torch.kernels import ops
from repro_torch.parallel import ranks
from repro_torch.runtime import reset_process_caches

CPU = torch.device("cpu")
INT_MAX = TB.INT_MAX
SCALE, SEED = 9, 3
B = 6
DENSITY = (0.0, 0.004, 0.03, 0.2, 0.6, 0.95)   # per lane: ragged frontiers
MASK = np.array([True, True, False, True, True, True])
ROOTS = [0, 7, 123, 300]


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    """Plans are shared across sessions by graph content, and this file's
    tests reuse graphs: reset the port's registry (and its fingerprint and
    cache memos) around each test, so build counts do not depend on which
    tests ran before."""
    reset_process_caches()
    yield
    reset_process_caches()


def _ref(mod, words: str):
    """The JAX package's private function named by `words`: an underscore
    before them and between them."""
    return getattr(mod, "_" + words.replace(" ", "_"))


T_GRAPH = TG.rmat(SCALE, seed=SEED)
J_GRAPH = JG.rmat(SCALE, seed=SEED)
TDG = TB.DeviceGraph.from_graph(T_GRAPH, CPU)
JDG = JB.DeviceGraph.from_graph(J_GRAPH)
V = T_GRAPH.num_vertices


def _inputs(seed=0, b=B, v=V):
    """(frontier uint8[b, v], visited uint8[b, v], parent int32[b, v])."""
    rng = np.random.default_rng(seed)
    frontier = np.stack([rng.random(v) < d for d in DENSITY[:b]]
                        ).astype(np.uint8)
    visited = (frontier | (rng.random((b, v)) < 0.3)).astype(np.uint8)
    parent = np.where(visited != 0, rng.integers(0, v, (b, v)),
                      INT_MAX).astype(np.int32)
    return frontier, visited, parent


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


WRAPPERS = ("bottomup_batch", "hub_bottomup_batch", "topdown_batch",
            "topdown_push_batch", "frontier_fused_batch", "bottomup",
            "hub_bottomup", "topdown", "topdown_push", "frontier_fused")


@contextlib.contextmanager
def _no_wrappers():
    """Every kernel wrapper of `kernels.ops` raises while the block runs:
    the gather formulation calls none (on the CPU a wrapper would run its
    plain version and count no launch, so a launch count shows nothing)."""
    def forbid(name):
        def call(*a, **k):
            raise AssertionError(f"ops.{name} called on the gather path")
        return call
    with mock.patch.multiple(ops, **{n: forbid(n) for n in WRAPPERS}):
        yield


def test_inputs_cover_the_edge_cases():
    assert (T_GRAPH.degrees == 0).any(), "want degree-0 rows"
    f, _, _ = _inputs()
    assert f[0].sum() == 0 and f[-1].sum() > V // 2
    assert not MASK.all()


# ------------------------------------------------------------- cohort steps


def _sides():
    hub = T_GRAPH.degrees > 32
    return {"none": None, "hub": hub, "tail": ~hub & (T_GRAPH.degrees > 0)}


@pytest.mark.parametrize("side", ["none", "hub", "tail"])
def test_cohort_push_matches_reference(side):
    """`_topdown_step_batch` with and without `dst_mask`."""
    dst = _sides()[side]
    f, vis, par = _inputs(1)
    cfg = JB.BFSConfig(backend_kernels=False, td_chunk=64)
    want = _ref(JB, "top down step batch")(
        JDG, cfg, *_j(f, vis, par, MASK),
        None if dst is None else jnp.asarray(dst))
    with _no_wrappers():
        got = TB._topdown_step_batch(
            TDG, TB.BFSConfig(backend_kernels=False), *_t(f, vis, par, MASK),
            None if dst is None else torch.from_numpy(dst))
    for g, w, name in zip(got, want, ("flags", "parent")):
        _same(g, w, f"{side} {name}")
    assert np.asarray(want[0]).any()


@pytest.mark.parametrize("side,chunk,slab", [
    ("none", None, None), ("none", 7, 3), ("tail", 2048, 32),
    ("hub", 128, 256)])
def test_cohort_pull_matches_reference(side, chunk, slab):
    """`_bottomup_step_batch` with and without `side`/`chunk`/`slab`."""
    s = _sides()[side]
    f, vis, par = _inputs(2)
    want = _ref(JB, "bottom up step batch")(
        JDG, JB.BFSConfig(backend_kernels=False), *_j(f, vis, par, MASK),
        side=None if s is None else jnp.asarray(s), chunk=chunk, slab=slab)
    got = TB._bottomup_step_batch(
        TDG, TB.BFSConfig(backend_kernels=False), *_t(f, vis, par, MASK),
        side=None if s is None else torch.from_numpy(s), chunk=chunk,
        slab=slab)
    for g, w, name in zip(got, want, ("flags", "parent")):
        _same(g, w, f"{side} {name}")
    assert np.asarray(want[0]).any()


@pytest.mark.parametrize("floor", [8, 32, 1 << 20])
def test_hub_pull_matches_reference(floor):
    """`_hub_pull_batch` over the static hub rows (none at the top floor),
    hub_slab narrower than the widest row."""
    hub_rows = np.flatnonzero(T_GRAPH.degrees > floor).astype(np.int32)
    f, vis, par = _inputs(3)
    cfg = dict(backend_kernels=False, hub_slab=16)
    if hub_rows.size:
        want = _ref(JB, "hub pull batch")(
            JDG, JB.BFSConfig(**cfg), jnp.asarray(hub_rows),
            *_j(f, vis, par, MASK))
    else:     # the reference's caller skips an empty hub side
        want = (np.zeros_like(f), par)
    got = TB._hub_pull_batch(TDG, TB.BFSConfig(**cfg),
                             torch.from_numpy(hub_rows.astype(np.int64)),
                             *_t(f, vis, par, MASK))
    for g, w, name in zip(got, want, ("flags", "parent")):
        _same(g, w, f"floor {floor} {name}")


@pytest.mark.parametrize("lane", [1, 3, 5])
def test_one_lane_steps_match_reference(lane):
    """The one-search push and pull, the pull with a vector and a scalar
    `row_mask`."""
    f, vis, par = (a[lane] for a in _inputs(4))
    jcfg = JB.BFSConfig(backend_kernels=False, td_chunk=100, bu_chunk=33)
    tcfg = TB.BFSConfig(backend_kernels=False)
    want = _ref(JB, "top down step")(JDG, jcfg, *_j(f, vis, par))
    got = TB._topdown_step(TDG, tcfg, *_t(f, vis, par))
    for g, w in zip(got, want):
        _same(g, w, "push")
    rmask = T_GRAPH.degrees % 3 != 0
    for row_mask in (None, rmask, np.bool_(True), np.bool_(False)):
        want = _ref(JB, "bottom up step")(
            JDG, jcfg, *_j(f, vis, par),
            row_mask=None if row_mask is None else jnp.asarray(row_mask))
        got = TB._bottomup_step(
            TDG, tcfg, *_t(f, vis, par),
            row_mask=None if row_mask is None else torch.from_numpy(
                np.asarray(row_mask)))
        for g, w in zip(got, want):
            _same(g, w, f"pull row_mask {row_mask}")


# -------------------------------------------------------- partition steps


def _partition(strategy, p):
    jpg = JP.apply_plan(J_GRAPH, JP.make_plan(J_GRAPH, p, strategy))
    tpg = TP.apply_plan(T_GRAPH, TP.make_plan(T_GRAPH, p, strategy))
    return jpg, tpg


@pytest.mark.parametrize("strategy,p", [("random", 2), ("hub0", 4),
                                        ("specialized", 4)])
def test_local_steps_match_reference(strategy, p):
    """`_local_topdown`/`_local_bottomup` on every rank's CSR block, the
    pull also under `hub_split` (the reference splits its row queue; the
    first hits do not change). hub0 has phantom rows of id v_pad."""
    jpg, tpg = _partition(strategy, p)
    v_pad = jpg.plan.v_pad
    shapes = (v_pad, jpg.num_local_rows, jpg.local_indices.shape[1])
    if strategy == "hub0":
        assert (tpg.local_row_gid == v_pad).any()
    f, vis, _ = _inputs(5, b=6, v=v_pad)
    for rank in range(p):
        csr = (tpg.local_indptr[rank], tpg.local_indices[rank],
               tpg.local_row_gid[rank])
        for lane in (1, 3, 5):
            for words, mine, kw in (
                    ("local top down", TH._local_topdown, {}),
                    ("local bottom up", TH._local_bottomup, {}),
                    ("local bottom up", TH._local_bottomup,
                     dict(hub_split=True, hub_deg=32))):
                cfg = JB.BFSConfig(backend_kernels=False, **kw)
                want = _ref(JH, words)(shapes, cfg, *_j(*csr),
                                       *_j(vis[lane], f[lane]))
                got = mine(v_pad, *_t(*csr), *_t(vis[lane], f[lane]))
                for g, w, name in zip(got, want, ("flags", "pcand")):
                    _same(g, w, f"{strategy} rank {rank} {words} {kw} "
                                f"{name}")


# ---------------------------------------------------------- whole searches


SEARCHES = [dict(heuristic=h, hub_split=s, hub_deg=32)
            for h in ("paper", "beamer") for s in (False, True)]
ROW_KEYS = ("level", "direction", "td_lanes", "bu_lanes", "frontier_size",
            "frontier_edges", "lane_frontier", "lane_edges",
            "lane_direction", "lane_hub_direction", "lane_hub_frontier")


def _rows(rows):
    return [{k: r[k] for k in ROW_KEYS if k in r} for r in rows]


@pytest.mark.parametrize("kw", SEARCHES, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_gather_searches_match_reference_and_tiles(kw):
    """Batched and Graph500 mode: the port's gather search equals the JAX
    package's kernels-off search and the port's tiles, rows included;
    no port kernel runs."""
    gather = Engine(T_GRAPH, device="cpu")
    ref = JaxEngine(J_GRAPH)
    tiles = Engine(T_GRAPH, device="cpu")
    for batched in (True, False):
        with _no_wrappers():
            mine = gather.bfs(ROOTS, TB.BFSConfig(backend_kernels=False,
                                                  **kw),
                              batched=batched, validate=True)
        want = ref.bfs(ROOTS, JB.BFSConfig(backend_kernels=False, **kw),
                       batched=batched)
        other = tiles.bfs(ROOTS, TB.BFSConfig(backend_kernels=True, **kw),
                          batched=batched)
        for res in (want, other):
            _same(mine.parent, res.parent, f"{kw} parent")
            _same(mine.level, res.level, f"{kw} level")
            if batched:
                assert _rows(mine.batch_level_stats) == \
                    _rows(res.batch_level_stats), kw
    assert "ell" not in gather.session.runtime_stats()["builds"]


@pytest.mark.parametrize("heuristic", ["paper", "beamer"])
def test_gather_stepper_and_bfs_match_reference_and_tiles(heuristic):
    cfg = dict(heuristic=heuristic)
    with _no_wrappers():
        mine = Engine(T_GRAPH, device="cpu").bfs(
            ROOTS[:2], TB.BFSConfig(backend_kernels=False, **cfg),
            backend="stepper")
    want = JaxEngine(J_GRAPH).bfs(
        ROOTS[:2], JB.BFSConfig(backend_kernels=False, **cfg),
        backend="stepper")
    tiles = Engine(T_GRAPH, device="cpu").bfs(
        ROOTS[:2], TB.BFSConfig(**cfg), backend="stepper")
    for res in (want, tiles):
        _same(mine.parent, res.parent, "stepper parent")
        _same(mine.level, res.level, "stepper level")
        for a, b in zip(mine.per_level_stats, res.per_level_stats):
            assert _rows(a) == _rows(b)
    p, l = TB.bfs(T_GRAPH, ROOTS[1], TB.BFSConfig(backend_kernels=False,
                                                  **cfg), device="cpu")
    jp, jl = JB.bfs(J_GRAPH, ROOTS[1], JB.BFSConfig(backend_kernels=False,
                                                    **cfg))
    _same(p, jp, "bfs parent")
    _same(l, jl, "bfs level")


def test_runtime_switch_picks_gather(monkeypatch):
    """`backend_kernels=None` follows REPRO_KERNELS: off -> gather (no
    tiles built), auto -> tiles; an explicit config wins."""
    from repro_torch.runtime.config import runtime_scope
    cfg = TB.BFSConfig()
    with runtime_scope(kernel_backend="off"):
        assert not TB.kernels_enabled(cfg)
        assert TB.kernels_enabled(TB.BFSConfig(backend_kernels=True))
        eng = Engine(T_GRAPH, device="cpu")
        eng.bfs(ROOTS, validate=True)
        assert "ell" not in eng.session.runtime_stats()["builds"]
    with runtime_scope(kernel_backend="auto"):
        assert TB.kernels_enabled(cfg)
        assert not TB.kernels_enabled(TB.BFSConfig(backend_kernels=False))
    monkeypatch.setenv("REPRO_KERNELS", "off")
    with runtime_scope():
        assert not TB.kernels_enabled(cfg)


# ------------------------------------------------- sharded, P = 2 on gloo


SHARDED_REF = """
import numpy as np, jax.numpy as jnp, jax
from repro.core import graph as G
from repro.core.bfs import BFSConfig
from repro.core.hybrid_bfs import HybridConfig, make_hybrid_search, finalize_hybrid
from repro.core.partition import apply_plan, make_plan
g = G.rmat({scale}, seed={seed})
pg = apply_plan(g, make_plan(g, 2, "specialized"))
fn, rm = make_hybrid_search(pg, HybridConfig(bfs=BFSConfig(backend_kernels=False)))
run = jax.jit(fn)
out = {{}}
for i, r in enumerate({roots}):
    pn, ln, _ = run(jnp.int32(rm(r)))
    out[f"parent{{i}}"], out[f"level{{i}}"] = finalize_hybrid(pg.plan, pn, ln)
np.savez({path!r}, **out)
print("REF_OK")
"""


def sharded_gather_rank(rank, group, device):
    """This rank's P = 2 searches, gather and tiles, sharded and stepper,
    psum and bitmap."""
    eng = Engine(T_GRAPH, device=device)
    out = {}
    for exchange in ("psum", "bitmap"):
        for backend in ("sharded", "stepper"):
            for kernels in (False, True):
                hcfg = TH.HybridConfig(bfs=TB.BFSConfig(
                    backend_kernels=kernels), exchange=exchange)
                with (contextlib.nullcontext() if kernels
                      else _no_wrappers()):
                    res = eng.bfs(ROOTS, hcfg, backend=backend, n_parts=2,
                                  strategy="specialized")
                key = f"{exchange}/{backend}/{kernels}"
                out[key] = (res.parent, res.level,
                            [_rows(s) for s in res.per_level_stats or []])
    return out


def test_sharded_gather_matches_reference_and_tiles(tmp_path):
    path = str(tmp_path / "ref.npz")
    assert "REF_OK" in run_in_devices(SHARDED_REF.format(
        scale=SCALE, seed=SEED, roots=ROOTS, path=path), 2, timeout=400)
    with np.load(path) as z:
        want = {k: z[k] for k in z.files}
    (tmp_path / "rdv").mkdir()
    outs = ranks.run_ranks(sharded_gather_rank, 2, str(tmp_path / "rdv"),
                           device="cpu", timeout=400)
    for out in outs:
        for exchange in ("psum", "bitmap"):
            for backend in ("sharded", "stepper"):
                g_par, g_lev, g_rows = out[f"{exchange}/{backend}/False"]
                t_par, t_lev, t_rows = out[f"{exchange}/{backend}/True"]
                _same(g_par, t_par, f"{exchange} {backend} vs tiles")
                _same(g_lev, t_lev, f"{exchange} {backend} vs tiles")
                assert g_rows == t_rows
                for i in range(len(ROOTS)):
                    _same(g_par[i], want[f"parent{i}"], "vs reference")
                    _same(g_lev[i], want[f"level{i}"], "vs reference")

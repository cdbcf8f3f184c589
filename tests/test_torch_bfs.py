"""The whole slice: `repro_torch.engine.Engine` against `repro.engine.Engine`.

Both packages search the same graph from the same roots; parents, levels
and the per-level rows' direction and lane fields must be equal bit for
bit. The JAX side runs its default CPU formulation (XLA), which
`tests/test_kernel_bfs.py` holds bitwise equal to its kernel path. The
per-step test feeds one mid-search JAX `BatchState` (and the JAX package's
own ELL tiles) through `repro_torch.interop` and compares one step of every
variant, all 20 fields.
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
from repro_torch import interop
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import (CohortBatchBackend, Engine, QueryCancelled,
                                QueryControl)
from repro_torch.runtime import reset_process_caches

CPU = torch.device("cpu")
ROW_KEYS = ("level", "direction", "td_lanes", "bu_lanes", "frontier_size",
            "frontier_edges", "active_lanes", "batch", "lane_frontier",
            "lane_edges", "lane_direction", "lane_active",
            "lane_hub_direction", "hub_td_lanes", "hub_bu_lanes")


def _undirected(g):
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int64), g.degrees)
    dst = g.indices.astype(np.int64)
    keep = src < dst
    return src[keep], dst[keep]


def _composite(G):
    """A star, a long path, an RMAT blob and an isolated vertex as
    components of one graph: lanes rooted in each disagree on direction."""
    star_n, path_n = 40, 60
    blob = G.rmat(7, seed=3)
    rs, rd = _undirected(blob)
    src = np.concatenate([np.zeros(star_n - 1, np.int64),
                          star_n + np.arange(path_n - 1),
                          star_n + path_n + rs])
    dst = np.concatenate([np.arange(1, star_n),
                          star_n + np.arange(1, path_n),
                          star_n + path_n + rd])
    n = star_n + path_n + blob.num_vertices + 1
    roots = [0, star_n, star_n + path_n + int(np.argmax(blob.degrees)), n - 1]
    return G.from_edges(src, dst, n), roots


GRAPHS = {
    "rmat": (TG.rmat(8, seed=5), JG.rmat(8, seed=5)),
    "composite": (_composite(TG)[0], _composite(JG)[0]),
}
MIXED_BATCH = _composite(TG)[1]
HEURISTICS = ["paper", "beamer", "topdown", "bottomup"]


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    """Plans are shared across sessions by graph content, and this file's
    tests reuse graphs (one patches the step the plans close over): reset
    the port's registry (and its fingerprint and cache memos) around each
    test, so no test runs a plan an earlier one built."""
    reset_process_caches()
    yield
    reset_process_caches()


def _rows(res):
    return [{k: r[k] for k in ROW_KEYS} for r in res.batch_level_stats]


def _run_both(name, roots, heuristic, batched):
    tg, jg = GRAPHS[name]
    mine = Engine(tg, device="cpu").bfs(
        roots, TB.BFSConfig(heuristic=heuristic), batched=batched)
    ref = JaxEngine(jg).bfs(roots, JB.BFSConfig(heuristic=heuristic),
                            batched=batched)
    np.testing.assert_array_equal(mine.parent, ref.parent)
    np.testing.assert_array_equal(mine.level, ref.level)
    np.testing.assert_array_equal(mine.num_levels, ref.num_levels)
    np.testing.assert_array_equal(mine.edges_traversed, ref.edges_traversed)
    return mine, ref


@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "graph500"])
def test_engine_matches_reference(heuristic, batched):
    g = GRAPHS["rmat"][0]
    roots = [0, 11, int(np.argmax(g.degrees)), g.num_vertices - 1]
    mine, ref = _run_both("rmat", roots, heuristic, batched)
    if batched:
        assert _rows(mine) == _rows(ref)


@pytest.mark.parametrize("heuristic", ["paper", "beamer"])
def test_direction_mixed_batch_matches_reference(heuristic):
    mine, ref = _run_both("composite", MIXED_BATCH, heuristic, True)
    assert _rows(mine) == _rows(ref)
    assert any(r["direction"] == "mixed" for r in mine.batch_level_stats)
    mine.validate(GRAPHS["composite"][0])


@pytest.mark.parametrize("size", [3, 5, 7])
def test_ragged_batches_share_bucket_8(size):
    g = GRAPHS["composite"][0]
    rng = np.random.default_rng(size)
    roots = rng.choice(g.num_vertices, size, replace=False)
    mine, ref = _run_both("composite", roots, "beamer", True)
    assert _rows(mine) == _rows(ref)
    assert all(r["batch"] == 8 for r in mine.batch_level_stats)
    assert all(r["lane_active"][size:] == [False] * (8 - size)
               for r in mine.batch_level_stats)


# ---------------------------------------------------------------- one step --

def _jax_state_arrays(st):
    leaves, _ = st.tree_flatten()
    return {f: np.asarray(x) for f, x in zip(TB.BATCH_STATE_FIELDS, leaves)}


def _torch_state_arrays(st):
    return {f: getattr(st, f).numpy() for f in TB.BATCH_STATE_FIELDS}


@pytest.mark.parametrize("heuristic", ["paper", "beamer"])
def test_one_step_per_variant_matches_reference(heuristic):
    """A JAX state after k levels, carried across with interop: one port
    step of each variant equals the JAX step, field for field."""
    tg, jg = GRAPHS["composite"]
    jcfg = JB.BFSConfig(heuristic=heuristic, backend_kernels=False)
    tcfg = TB.BFSConfig(heuristic=heuristic)
    jdg = JB.DeviceGraph.from_graph(jg)
    g = interop.graph_from_arrays(jg.num_vertices, jg.indptr, jg.indices,
                                  jg.degrees)
    tdg = TB.DeviceGraph.from_graph(g, CPU)
    ell = interop.ell_from_arrays(
        [tuple(np.asarray(a) for a in t) for t in JELL.build_graph_ell(jg)],
        CPU)
    roots = np.full(8, MIXED_BATCH[0], np.int32)
    roots[:4] = MIXED_BATCH
    jst = JB.init_batch(jdg, jcfg, jnp.asarray(roots),
                        jnp.asarray(np.arange(8) < 4))
    jsteps = {v: jax.jit(JB.make_batch_step(jdg, jcfg, v))
              for v in JB.BATCH_VARIANTS}
    tsteps = {v: TB.make_batch_step(tdg, tcfg, v, ell)
              for v in TB.BATCH_VARIANTS}
    seen = set()
    for k in range(6):
        arrays = _jax_state_arrays(jst)
        tst = interop.batch_state_from_arrays(arrays, CPU)
        assert _torch_state_arrays(tst).keys() == arrays.keys()
        for variant in TB.BATCH_VARIANTS:
            want = _jax_state_arrays(jsteps[variant](jst))
            got = _torch_state_arrays(tsteps[variant](tst))
            for f in TB.BATCH_STATE_FIELDS:
                assert got[f].dtype == want[f].dtype, (k, variant, f)
                np.testing.assert_array_equal(got[f], want[f],
                                              err_msg=f"{k} {variant} {f}")
        sync = jax.device_get(JB.batch_scalars(jst))
        variant = CohortBatchBackend.variant_for(int(sync["td_next"]),
                                                 int(sync["bu_next"]))
        seen.add(variant)
        jst = jsteps[variant](jst)
    assert "mixed" in seen, seen            # the batch did mix directions


def test_batch_scalars_match_reference():
    tg, jg = GRAPHS["rmat"]
    jcfg = JB.BFSConfig(heuristic="beamer", backend_kernels=False)
    jdg = JB.DeviceGraph.from_graph(jg)
    roots = jnp.asarray([0, 3, 9, 20, 0, 0, 0, 0], jnp.int32)
    jst = JB.init_batch(jdg, jcfg, roots, jnp.asarray(np.arange(8) < 4))
    jst = jax.jit(JB.make_batch_step(jdg, jcfg, "mixed"))(jst)
    tst = interop.batch_state_from_arrays(_jax_state_arrays(jst), CPU)
    want = jax.device_get(JB.batch_scalars(jst))
    got = TB.batch_scalars(tst)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ------------------------------------------------ float32 direction tests --

def _fake_graphs(v, e):
    jdg = JB.DeviceGraph(jnp.zeros(2, jnp.int32), jnp.zeros(1, jnp.int32),
                         jnp.zeros(2, jnp.int32), v, e)
    tdg = TB.DeviceGraph(torch.zeros(2, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32), v, e)
    return jdg, tdg


def _around(x, spread=40):
    """int32 values around x, where float32 spacing is 2..128."""
    return np.clip(np.arange(int(x) - spread, int(x) + spread),
                   0, 2**31 - 1).astype(np.int32)


@pytest.mark.parametrize("heuristic", ["paper", "beamer"])
@pytest.mark.parametrize("magnitude", [2**24 + 3, 2**26 + 1, 2**30 - 7])
def test_decide_direction_float32_thresholds(heuristic, magnitude):
    """Counters above 2^24 round in float32; the port must round as the
    reference does, in the jitted step and eagerly."""
    v, e = 2**31 - 1, 2**31 - 1
    jdg, tdg = _fake_graphs(v, e)
    if heuristic == "paper":
        gamma = magnitude / e
        jcfg = JB.BFSConfig(heuristic="paper", gamma=gamma)
        tcfg = TB.BFSConfig(heuristic="paper", gamma=gamma)
        mf = _around(gamma * e)
        mu = np.full_like(mf, 2**31 - 1)
        nf = np.full_like(mf, 5)
    else:
        jcfg = JB.BFSConfig(heuristic="beamer", alpha=14.0, beta=24.0)
        tcfg = TB.BFSConfig(heuristic="beamer", alpha=14.0, beta=24.0)
        mu = _around(magnitude * 14)
        mf = _around(magnitude)[:len(mu)]
        nf = _around(v / 24.0)[:len(mu)]
    n = len(mf)
    for bu_mode in (np.zeros(n, bool), np.ones(n, bool)):
        steps = np.arange(n, dtype=np.int32) % 5
        args = [bu_mode, steps, mu, nf, mf]
        jit = jax.jit(lambda *a: JB._decide_direction_batch(jdg, jcfg, *a))
        want_jit = jit(*[jnp.asarray(a) for a in args])
        want = JB._decide_direction_batch(jdg, jcfg,
                                          *[jnp.asarray(a) for a in args])
        got = TB._decide_direction_batch(tdg, tcfg,
                                         *[torch.from_numpy(a) for a in args])
        for g_, w_, wj in zip(got, want, want_jit):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
            np.testing.assert_array_equal(g_.numpy(), np.asarray(wj))


# ---------------------------------------------------------- engine surface --

def test_unported_paths_raise_and_name_the_roadmap():
    g = GRAPHS["rmat"][0]
    eng = Engine(g, device="cpu")
    # The partitioned paths are ported: with no process group they name
    # the way to start one rank per partition instead of running.
    for kw in (dict(backend="sharded", n_parts=2),
               dict(backend="stepper", n_parts=2), dict(n_parts=2)):
        with pytest.raises(ValueError, match="torchrun"):
            eng.bfs(0, **kw)
    with pytest.raises(ValueError, match="n_parts >= 2"):
        eng.bfs(0, backend="sharded")
    with pytest.raises(ValueError):
        eng.bfs(0, n_parts=2, backend="fused")
    plan = eng.plan(TB.BFSConfig(heuristic="beamer"))
    assert plan == eng.plan(TB.BFSConfig(heuristic="beamer"), backend="fused")
    res = eng.bfs_plan([1, 2], plan)
    assert res.backend == "fused" and res.parent.shape == (2, g.num_vertices)
    empty = eng.bfs([])
    assert empty.parent.shape == (0, g.num_vertices)


def test_streaming_and_cancellation():
    g = GRAPHS["composite"][0]
    eng = Engine(g, device="cpu")
    seen = []
    res = eng.bfs(MIXED_BATCH, on_level=lambda i, row: seen.append((i, row)))
    assert [row for _, row in seen] == res.batch_level_stats
    assert all(i == -1 for i, _ in seen)
    with pytest.raises(ValueError):
        eng.bfs(MIXED_BATCH, batched=False, on_level=lambda i, r: None)
    ctl = QueryControl()

    def cancel_after_two(i, row):
        if row["level"] == 2:
            ctl.cancel()

    with pytest.raises(QueryCancelled) as info:
        eng.bfs(MIXED_BATCH, on_level=cancel_after_two, control=ctl)
    assert len(info.value.per_level_stats[0]) == 2


def test_fused_path_warms_each_bucket_before_timing(monkeypatch):
    """The first query at a batch bucket runs init and every reachable step
    variant once before the driver starts its clock, batched and in
    Graph500 mode (the reference's `CohortBatchBackend.warm`); a second
    query at the same bucket does not warm again."""
    calls = []
    real = TB._advance_batch

    def step(*args):
        calls.append(args[4])                 # the variant
        return real(*args)
    monkeypatch.setattr(TB, "_advance_batch", step)
    g = GRAPHS["rmat"][0]
    eng = Engine(g, device="cpu")
    cfg = TB.BFSConfig()
    res = eng.bfs([0, 11])
    assert calls[:3] == list(TB.reachable_variants(cfg))
    assert len(calls) == 3 + len(res.batch_level_stats)
    assert ("cohort_warm", cfg, True, 8) in eng.session._warmed
    calls.clear()
    res = eng.bfs([0, 11, 5])                 # bucket 8 again
    assert len(calls) == len(res.batch_level_stats)
    calls.clear()
    res = eng.bfs([0, 11], batched=False)     # bucket 1
    assert ("cohort_warm", cfg, True, 1) in eng.session._warmed
    assert calls[:3] == list(TB.reachable_variants(cfg))
    assert len(calls) == 3 + sum(int(n) + 1 for n in res.num_levels)
    one = TB.BFSConfig(heuristic="topdown")   # one reachable variant
    calls.clear()
    res = eng.bfs([0, 11], one)
    assert calls[:1] == ["td"] and len(calls) == 1 + len(
        res.batch_level_stats)


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
def test_rows_have_the_reference_keys(split):
    """Every row of both packages has the same keys, compute_s and
    exchange_s included, as API.md promises on every backend: the cohort
    rows (batched) and the stepper's."""
    tg, jg = GRAPHS["rmat"]
    roots = [0, 11, int(np.argmax(tg.degrees))]
    kw = dict(hub_split=split, hub_deg=32)
    mine = Engine(tg, device="cpu").bfs(roots, TB.BFSConfig(**kw))
    ref = JaxEngine(jg).bfs(roots, JB.BFSConfig(**kw))
    assert [set(r) for r in mine.batch_level_stats] == \
        [set(r) for r in ref.batch_level_stats]
    assert all(r["compute_s"] == r["seconds"] and r["exchange_s"] == 0.0
               for r in mine.batch_level_stats)
    mine = Engine(tg, device="cpu").bfs(roots[:2], backend="stepper")
    ref = JaxEngine(jg).bfs(roots[:2], backend="stepper", n_parts=1)
    assert [[set(r) for r in s] for s in mine.per_level_stats] == \
        [[set(r) for r in s] for s in ref.per_level_stats]

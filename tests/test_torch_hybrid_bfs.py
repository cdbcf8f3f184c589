"""The partitioned BSP search: the port's gloo ranks against the JAX package.

The JAX reference runs once, in two subprocesses with 4 fake host devices
(`conftest.run_in_devices`), into `.npz` files: `make_hybrid_search` with
the Pallas kernels in interpret mode (`backend_kernels=True`) for every
case and both roots, the XLA formulation for one case (the reference's
own claim: both are bitwise equal), the BSP stepper's rows of root 0, a
whole search's rounds (state, compute output, next state) and compute
outputs on forced top-down and bottom-up levels.

The port runs the same cases on gloo ranks on the CPU (`parallel.ranks`):
`hybrid_bfs`, `hybrid_bfs_instrumented` and `Engine.bfs` as `sharded` and
as `stepper`. Parents, levels, round counts and the rows' level,
direction, frontier_size and frontier_edges must be equal bit for bit, on
every rank. The round replay carries the JAX stepper's state into one
rank at a time (`interop.hybrid_state_from_arrays`) with no spawn: each
rank's compute against the reference's row of the stacked compute output,
and the exchange, over a one-rank group fed the OR of every rank's flags,
against the reference's next state.
"""
import concurrent.futures

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_in_devices
from repro_torch import interop
from repro_torch.core import ell as TELL
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bfs import INT_MAX, BFSConfig
from repro_torch.core.hybrid_bfs import (HybridConfig, hybrid_bfs,
                                         hybrid_bfs_instrumented,
                                         make_hybrid_stepper)
from repro_torch.engine import Engine
from repro_torch.engine.engine import AUTO_SHARD_MIN_EDGES
from repro_torch.engine.level_loop import host_sync
from repro_torch.parallel import ranks

CPU = torch.device("cpu")
SCALE, SEED = 10, 3
GRAPH = TG.rmat(SCALE, seed=SEED)
ROOTS = [int(np.argmax(GRAPH.degrees)), 7]
# name: (strategy, P, HybridConfig knobs): the JAX tests' cases.
CASES = {f"{s}-{p}": (s, p, {}) for s in TPT.STRATEGIES for p in (2, 4)}
CASES.update({
    "bitmap": ("specialized", 4, dict(exchange="bitmap")),
    "global": ("specialized", 4, dict(coordinator="global")),
    "beamer": ("specialized", 4, dict(heuristic="beamer")),
    "topdown": ("specialized", 4, dict(heuristic="topdown")),
})
# The round replay's search, and the partitions of the padding test: one
# whose last vertex v_pad - 1 is a phantom, one where it is a real vertex.
TRACE = ("specialized", 4)
DROP = [("specialized", 4), ("random", 2)]
RANK_TIMEOUT = 240
REF_PARTS = 5

REF_CODE = r"""
import numpy as np
import jax.numpy as jnp
import jax
from repro.core import graph as G, partition as pt
from repro.core.bfs import BFSConfig
from repro.core.hybrid_bfs import (HybridConfig, make_hybrid_search,
                                   make_hybrid_stepper, finalize_hybrid)
from repro.engine.level_loop import BSPStepBackend, LevelDriver

CASES, ROOTS, TRACE, DROP, OUT, PART = {cases!r}, {roots!r}, {trace!r}, \
    {drop!r}, {out!r}, {part!r}
g = G.rmat({scale}, seed={seed})
out = {{}}

def hcfg_of(kw, kernels=True):
    return HybridConfig(
        bfs=BFSConfig(backend_kernels=kernels,
                      heuristic=kw.get("heuristic", "paper")),
        coordinator=kw.get("coordinator", "hub"),
        exchange=kw.get("exchange", "psum"))

def pg_of(strat, p):
    return pt.apply_plan(g, pt.make_plan(g, p, strat))

def host(state):
    return {{k: np.asarray(v) for k, v in state.items()}}

def save_state(prefix, state):
    for k, v in host(state).items():
        out[f"{{prefix}}/{{k}}"] = v

def save_work(prefix, work):
    nxt, pc, bu, steps = work
    out[prefix + "/nxt"] = np.asarray(nxt)
    out[prefix + "/pc"] = np.asarray(pc)
    out[prefix + "/bu"] = np.asarray(bu)
    out[prefix + "/bu_steps"] = np.asarray(steps)

if PART in (0, 1):      # searches, P = 4 then P = 2
    for name, (strat, p, kw) in CASES.items():
        if p != (4 if PART == 0 else 2):
            continue
        pg = pg_of(strat, p)
        hcfg = hcfg_of(kw)
        fn, rm = make_hybrid_search(pg, hcfg)
        run = jax.jit(fn)
        for i, r in enumerate(ROOTS):
            pn, ln, lv = run(jnp.int32(rm(r)))
            par, lev = finalize_hybrid(pg.plan, pn, ln)
            out[f"{{name}}/parent{{i}}"] = par
            out[f"{{name}}/level{{i}}"] = lev
            out[f"{{name}}/levels{{i}}"] = np.int64(lv)
        if name == "specialized-4":     # the XLA formulation, one case
            fn, rm = make_hybrid_search(pg, hcfg_of(kw, kernels=False))
            pn, ln, lv = jax.jit(fn)(jnp.int32(rm(ROOTS[0])))
            par, lev = finalize_hybrid(pg.plan, pn, ln)
            out["xla/parent0"], out["xla/level0"] = par, lev
            out["xla/levels0"] = np.int64(lv)
elif PART in (2, 3):    # the BSP stepper's rows of root 0, half each
    for j, (name, (strat, p, kw)) in enumerate(CASES.items()):
        if j % 2 != PART - 2:
            continue
        pg = pg_of(strat, p)
        backend = BSPStepBackend(make_hybrid_stepper(pg, hcfg_of(kw)),
                                 pg.plan)
        _, _, stats, _ = LevelDriver(backend).run(ROOTS[0])
        out[f"{{name}}/rows"] = np.array(
            [[r["level"], r["direction"] == "bu", r["frontier_size"],
              r["frontier_edges"]] for r in stats], dtype=np.int64)
        out["row_keys"] = np.array(sorted(stats[0]))
else:
    # a whole search's rounds
    pg = pg_of(*TRACE)
    init, compute, exchange, _fin, rm = make_hybrid_stepper(pg, hcfg_of({{}}))
    state = init(jnp.int32(rm(ROOTS[0])))
    k = 0
    while int(state["nf"]) > 0:
        save_state(f"trace{{k}}/state", state)
        work = compute(state)
        save_work(f"trace{{k}}", work)
        state = exchange(state, *work)
        save_state(f"trace{{k}}/next", state)
        k += 1
    out["trace_rounds"] = np.int64(k)
    # forced top-down and bottom-up levels, padding rows present: from the
    # state after round 1, and from "everything visited but v_pad - 1"
    for strat, p in DROP:
        pg = pg_of(strat, p)
        v_pad = pg.plan.v_pad
        init, compute, exchange, _fin, rm = make_hybrid_stepper(
            pg, hcfg_of({{}}))
        s0 = init(jnp.int32(rm(ROOTS[0])))
        s1 = exchange(s0, *compute(s0))
        last = jnp.ones(v_pad, jnp.uint8).at[v_pad - 1].set(0)
        for sname, st in (("round1", s1),
                          ("last", dict(s1, visited=last, frontier=last))):
            for d, forced in (("td", dict(bu=jnp.bool_(False),
                                          mf_dec=jnp.int32(0))),
                              ("bu", dict(bu=jnp.bool_(True),
                                          bu_steps=jnp.int32(0)))):
                st2 = dict(st, **forced)
                pre = f"drop/{{strat}}-{{p}}/{{sname}}/{{d}}"
                save_state(pre + "/state", st2)
                save_work(pre, compute(st2))
np.savez(OUT, **out)
print("REF_OK")
"""


def _hcfg(kw) -> HybridConfig:
    return HybridConfig(bfs=BFSConfig(heuristic=kw.get("heuristic",
                                                       "paper")),
                        coordinator=kw.get("coordinator", "hub"),
                        exchange=kw.get("exchange", "psum"))


def _rows(stats) -> np.ndarray:
    return np.array([[r["level"], r["direction"] == "bu", r["frontier_size"],
                      r["frontier_edges"]] for r in stats], dtype=np.int64)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's results, computed once (in four parts at once)."""
    d = tmp_path_factory.mktemp("hybrid_ref")
    paths = [str(d / f"ref{i}.npz") for i in range(REF_PARTS)]
    codes = [REF_CODE.format(cases=CASES, roots=ROOTS, trace=TRACE,
                             drop=DROP, out=paths[i], part=i, scale=SCALE,
                             seed=SEED) for i in range(REF_PARTS)]
    with concurrent.futures.ThreadPoolExecutor(REF_PARTS) as ex:
        outs = list(ex.map(lambda c: run_in_devices(c, 4, timeout=400),
                           codes))
    assert all("REF_OK" in o for o in outs)
    ref = {}
    for p in paths:
        with np.load(p) as z:
            ref.update({k: z[k] for k in z.files})
    return ref


def port_cases(rank, group, device, n_parts):
    """One rank's results of every case with `n_parts` partitions."""
    eng = Engine(GRAPH, device=device)
    out = {}
    for name, (strat, p, kw) in CASES.items():
        if p != n_parts:
            continue
        hcfg = _hcfg(kw)
        _, pg = eng.session.partitioned(p, strat)
        for i, r in enumerate(ROOTS):
            parent, level, levels = hybrid_bfs(pg, r, hcfg, group, device)
            out[f"{name}/parent{i}"] = parent
            out[f"{name}/level{i}"] = level
            out[f"{name}/levels{i}"] = levels
        res = eng.bfs(ROOTS, hcfg, backend="sharded", n_parts=p,
                      strategy=strat)
        assert (res.backend, res.n_parts) == ("sharded", p)
        out[f"{name}/engine_parent"] = res.parent
        out[f"{name}/engine_level"] = res.level
        _, _, stats = hybrid_bfs_instrumented(pg, ROOTS[0], hcfg, group,
                                              device)
        out[f"{name}/rows"] = _rows(stats)
        out["row_keys"] = sorted(stats[0])
        res = eng.bfs(ROOTS, hcfg, backend="stepper", n_parts=p,
                      strategy=strat)
        assert (res.backend, res.n_parts) == ("stepper", p)
        out[f"{name}/stepper_parent"] = res.parent
        out[f"{name}/stepper_level"] = res.level
        out[f"{name}/stepper_rows"] = _rows(res.per_level_stats[0])
        out[f"{name}/exchange_s"] = [r["exchange_s"]
                                     for r in res.per_level_stats[0]]
    if n_parts == 4:
        # 1 against 4 partitions: under the global coordinator both decide
        # on the full frontier edge mass, so rows coincide too.
        hg = HybridConfig(coordinator="global")
        for n in (1, 4):
            res = eng.bfs(ROOTS[0], hg, backend="stepper", n_parts=n)
            out[f"cross{n}/rows"] = _rows(res.per_level_stats[0])
            out[f"cross{n}/parent"] = res.parent
            out[f"cross{n}/level"] = res.level
        try:
            eng.bfs(ROOTS[0], n_parts=2)
        except ValueError as e:
            out["mismatch"] = str(e)
        # auto: one partition below AUTO_SHARD_MIN_EDGES, the group's size
        # above it
        big = TG.rmat(15, seed=SEED)
        assert big.num_directed_edges >= AUTO_SHARD_MIN_EDGES
        out["auto"] = [(qp.backend, qp.n_parts) for qp in (
            eng.plan(), Engine(big, device=device).plan(),
            Engine(big, device=device).plan(backend="stepper"))]
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results, P = 2 and P = 4 gloo ranks on the CPU."""
    d = str(tmp_path_factory.mktemp("rendezvous"))
    return {p: ranks.run_ranks(port_cases, p, d, args=(p,), device="cpu",
                               timeout=RANK_TIMEOUT)
            for p in (2, 4)}


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_bfs_matches_reference(reference, port, name):
    p = CASES[name][1]
    for rank, out in enumerate(port[p]):
        for i in range(len(ROOTS)):
            for f in ("parent", "level", "levels"):
                _same(out[f"{name}/{f}{i}"], reference[f"{name}/{f}{i}"],
                      f"{name} rank {rank} root {i}: {f}")
            ref_parent = reference[f"{name}/parent{i}"]
            ref_level = reference[f"{name}/level{i}"]
            _same(out[f"{name}/engine_parent"][i], ref_parent, "engine")
            _same(out[f"{name}/engine_level"][i], ref_level, "engine")
            _same(out[f"{name}/stepper_parent"][i], ref_parent, "stepper")
            _same(out[f"{name}/stepper_level"][i], ref_level, "stepper")


@pytest.mark.parametrize("name", list(CASES))
def test_bsp_rows_match_reference(reference, port, name):
    p = CASES[name][1]
    for rank, out in enumerate(port[p]):
        _same(out[f"{name}/rows"], reference[f"{name}/rows"],
              f"{name} rank {rank}: instrumented rows")
        _same(out[f"{name}/stepper_rows"], reference[f"{name}/rows"],
              f"{name} rank {rank}: engine stepper rows")
        assert all(s >= 0.0 for s in out[f"{name}/exchange_s"])
        assert out["row_keys"] == list(reference["row_keys"])


def test_reference_xla_and_kernel_paths_agree(reference):
    for f in ("parent", "level", "levels"):
        _same(reference[f"xla/{f}0"], reference[f"specialized-4/{f}0"], f)


def test_one_and_four_partitions_agree_under_global_coordinator(port):
    for out in port[4]:
        for f in ("rows", "parent", "level"):
            _same(out[f"cross1/{f}"], out[f"cross4/{f}"], f)
        assert {d for d in out["cross4/rows"][:, 1]} == {0, 1}


def test_group_must_match_partition_count(port):
    for out in port[4]:
        assert "4 ranks but the query wants 2 partitions" in out["mismatch"]
        assert "torchrun" in out["mismatch"]


def test_auto_partition_count_follows_group_and_graph_size(port):
    for out in port[4]:
        assert out["auto"] == [("fused", 1), ("sharded", 4), ("stepper", 4)]


def test_partitioned_query_without_group_raises():
    eng = Engine(GRAPH, device="cpu")
    assert not dist.is_initialized()
    for kw in (dict(n_parts=4), dict(backend="stepper", n_parts=4),
               dict(backend="sharded", n_parts=2)):
        with pytest.raises(ValueError, match="torchrun"):
            eng.bfs(ROOTS[0], **kw)
    # auto with no group: one partition, the fused path
    assert eng.plan().n_parts == 1 and eng.plan().backend == "fused"


# ----------------------------------------------------- in-process replay --

@pytest.fixture
def solo_group(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _state(reference, prefix, rank):
    arrays = {k.rsplit("/", 1)[1]: v for k, v in reference.items()
              if k.startswith(prefix + "/") and k.count("/") ==
              prefix.count("/") + 1}
    return interop.hybrid_state_from_arrays(arrays, rank, CPU)


def _stepper(strat, p, group, rank, exchange="psum"):
    pg = TPT.apply_plan(GRAPH, TPT.make_plan(GRAPH, p, strat))
    ell = TELL.build_hybrid_ell(pg, rank, device=CPU)
    return pg, ell, make_hybrid_stepper(pg, HybridConfig(exchange=exchange),
                                        group, CPU, ell)


@pytest.mark.parametrize("exchange", ["psum", "bitmap"])
def test_round_replay_matches_reference(reference, solo_group, exchange):
    """Every round of a P = 4 specialized search, one rank at a time: the
    port's compute equals the reference's row of the rank, and its exchange
    (the OR over a one-rank group is the identity, so it is fed the OR of
    every rank's flags) gives the reference's next state, pcand row
    `rank`."""
    rounds = int(reference["trace_rounds"])
    assert rounds > 3
    directions = set()
    for rank in range(TRACE[1]):
        _, _, st = _stepper(*TRACE, solo_group, rank, exchange)
        for k in range(rounds):
            state = _state(reference, f"trace{k}/state", rank)
            bu = host_sync(st.scalars(state))["bu_next"]
            _same(bu, reference[f"trace{k}/bu"], f"round {k}: direction")
            directions.add(bu)
            nxt, pc, bu_t, steps = st.compute(state, bu)
            _same(nxt, reference[f"trace{k}/nxt"][rank], f"round {k}: nxt")
            _same(pc, reference[f"trace{k}/pc"][rank], f"round {k}: pc")
            _same(bu_t, reference[f"trace{k}/bu"], f"round {k}: bu")
            _same(steps, reference[f"trace{k}/bu_steps"], f"round {k}")
            merged = torch.from_numpy(
                (reference[f"trace{k}/nxt"].max(axis=0)).astype(np.uint8))
            nxt_state = st.exchange(state, merged, pc, bu_t, steps)
            want = _state(reference, f"trace{k}/next", rank)
            for f, v in want.items():
                _same(nxt_state[f], v, f"round {k}: next {f}")
    assert directions == {True, False}


@pytest.mark.parametrize("case", [f"{s}-{p}" for s, p in DROP])
def test_padding_rows_write_no_vertex(reference, solo_group, case):
    """`mode="drop"`: padding rows (id `v_pad`) exist in the tiles, and a
    forced top-down and a forced bottom-up level through the port's local
    steps equal the reference's, rank by rank, at every vertex; from
    "everything visited but v_pad - 1" the last vertex is discovered
    exactly when it has neighbours (a clamp of the padding id would write
    into it)."""
    strat, p = case.rsplit("-", 1)
    p = int(p)
    for rank in range(p):
        pg, ell, st = _stepper(strat, p, solo_group, rank)
        v_pad = pg.plan.v_pad
        assert any(bool((b.rows == v_pad).any()) for b in ell)
        assert all(bool((b.deg[b.rows == v_pad] == 0).all()) for b in ell)
        for sname in ("round1", "last"):
            for d in ("td", "bu"):
                pre = f"drop/{case}/{sname}/{d}"
                state = _state(reference, pre + "/state", rank)
                bu = host_sync(st.scalars(state))["bu_next"]
                assert bu == (d == "bu")
                nxt, pc, _, _ = st.compute(state, bu)
                _same(nxt, reference[pre + "/nxt"][rank], pre + " nxt")
                _same(pc, reference[pre + "/pc"][rank], pre + " pc")
                if sname == "last":
                    # top-down: a row of this rank has it as a neighbour;
                    # bottom-up: this rank owns its row, which has edges
                    local = pg.local_indices[rank][
                        :pg.local_indptr[rank][-1]]
                    found = (v_pad - 1 in local if d == "td" else
                             v_pad - 1 in pg.local_row_gid[rank]
                             and bool(pg.deg_ext[v_pad - 1]))
                    assert int(nxt[v_pad - 1]) == int(found), pre
                    assert (int(pc[v_pad - 1]) != INT_MAX) == found, pre

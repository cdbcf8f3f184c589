"""The port's span recorder (`repro_torch.runtime.trace`) on the CPU: the
span tree of a query, the driver's timings read from the spans' own clock
reads, the ring's bound, the switch, the profiler's ranges, and the
server's queue wait and dispatch."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import graph as G
from repro_torch.engine import BFSServer, Engine
from repro_torch.runtime import reset_process_caches, trace

SEARCH = {"driver.init", "level.sync", "level.issue", "level.wait",
          "finalize"}


@pytest.fixture(scope="module")
def graph():
    return G.rmat(9, seed=3)


@pytest.fixture(scope="module")
def roots(graph):
    return np.flatnonzero(graph.degrees > 0)[:5]


@pytest.fixture
def engine(graph):
    reset_process_caches()
    eng = Engine(graph, device="cpu")
    yield eng
    eng.session.close()
    reset_process_caches()


def _query(engine, *args, **kw):
    """`engine.bfs(*args, **kw)` and the spans it finished."""
    t0 = time.perf_counter()
    res = engine.bfs(*args, **kw)
    return res, trace.spans(t0)


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def _one(spans, name):
    got = [s for s in spans if s.name == name]
    assert len(got) == 1, [s.name for s in spans]
    return got[0]


@pytest.mark.parametrize("batched", [True, False])
def test_span_tree_of_a_query(engine, roots, batched):
    engine.bfs(roots, batched=batched)           # warm-up and builds
    res, spans = _query(engine, roots, batched=batched)
    q = _one(spans, "engine.query")
    assert q.parent is None and q.query == q.id
    assert q.attrs == dict(backend="fused", roots=len(roots),
                           bucket=8 if batched else 1)
    assert {s.query for s in spans} == {q.id}    # one query id a query
    assert {s.thread for s in spans} == {threading.get_ident()}
    runs = [s for s in _children(spans, q) if s.name == "driver.run"]
    assert len(runs) == (1 if batched else len(roots))
    assert {s.name for s in _children(spans, q)} == {"driver.run",
                                                     "engine.assemble"}
    for run in runs:
        kids = _children(spans, run)
        assert {s.name for s in kids} == SEARCH
        assert all(q.start <= run.start <= s.start <= s.end <= run.end
                   <= q.end for s in kids)
        fin = _one(kids, "finalize")
        done = _one(_children(spans, fin), "finalize.map")
        assert fin.start <= done.start <= done.end <= fin.end == run.end
    # a search's seconds are its driver.run's
    assert [r.end - r.start for r in runs] == (
        [res.seconds] if batched else list(res.per_root_seconds))
    assemble = [s for s in spans if s.name == "engine.assemble"]
    assert len(assemble) == 2 and min(s.start for s in assemble) \
        >= max(r.end for r in runs)
    inner = {s.name for a in assemble for s in _children(spans, a)}
    assert inner == {"engine.tree_depth", "engine.edges_traversed"}
    n_levels = res.num_levels.max()
    assert len([s for s in spans if s.name == "level.wait"]) \
        >= n_levels


def test_first_query_warms_and_builds_inside_its_span(engine, roots):
    _res, spans = _query(engine, roots)
    q = _one(spans, "engine.query")
    warm = _one(spans, "engine.warm")
    assert warm.parent == q.id and warm.attrs == dict(kind="cohort_warm")
    builds = [s for s in spans if s.name == "session.build"]
    assert builds and all(s.query == q.id for s in builds)
    assert "cohort" in {s.attrs["kind"] for s in builds}


def test_driver_timings_are_the_spans_clock_reads(engine, roots):
    engine.bfs(roots, backend="stepper")
    res, spans = _query(engine, roots, backend="stepper")
    q = _one(spans, "engine.query")
    runs = [s for s in _children(spans, q) if s.name == "driver.run"]
    assert len(runs) == len(roots)
    assert [r.end - r.start for r in runs] == list(res.per_root_seconds)
    for run, timing, rows in zip(runs, res.timings, res.per_level_stats):
        kids = _children(spans, run)
        init = _one(kids, "driver.init")
        assert init.start == run.start
        assert init.end - init.start == timing["init_s"]
        fin = _one(kids, "finalize")
        assert fin.end == run.end
        assert fin.end - fin.start == timing["agg_s"]
        done = _one(_children(spans, fin), "finalize.map")
        assert fin.start <= done.start <= done.end <= fin.end
        issue = [s for s in kids if s.name == "level.issue"]
        wait = [s for s in kids if s.name == "level.wait"]
        assert len(issue) == len(wait) == len(rows) > 0
        for i, w, row in zip(issue, wait, rows):
            assert i.end == w.start
            assert w.end - i.start == row["seconds"]
            assert i.attrs["level"] == w.attrs["level"] == row["level"] - 1


def test_batch_rows_are_the_level_spans(engine, roots):
    engine.bfs(roots)
    res, spans = _query(engine, roots)
    issue = [s for s in spans if s.name == "level.issue"]
    wait = [s for s in spans if s.name == "level.wait"]
    rows = res.batch_level_stats
    assert len(issue) == len(wait) == len(rows)
    for i, w, row in zip(issue, wait, rows):
        assert i.end == w.start and w.end - i.start == row["seconds"]


def test_ring_keeps_the_newest_and_counts_the_dropped():
    rec = trace.Recorder(capacity=4)
    ends = []
    for k in range(10):
        with rec.span(f"s{k}") as sp:
            pass
        ends.append(sp.end)
    assert [s.name for s in rec.spans()] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6
    assert rec.lost(ends[5]) and not rec.lost(ends[5] + 1e-9)


def test_split_spans_meet_and_an_exception_ends_the_open_ones():
    rec = trace.Recorder()
    with pytest.raises(RuntimeError):
        with rec.span("outer", roots=2) as outer:
            inner = rec.span("a", level=1)
            t = inner.split("b", extra=True)
            rec.span("left-open")
            raise RuntimeError
    assert rec.current() is None
    got = {s.name: s for s in rec.spans()}
    assert set(got) == {"a", "outer"}       # "b", "left-open" never closed
    assert got["a"].end == t and got["a"].parent == outer.id
    assert got["a"].attrs == dict(level=1)
    assert inner.attrs == dict(level=1, extra=True)
    rec.record("later", 1.0, 2.0, qid=7)
    later = rec.spans()[-1]
    assert (later.parent, later.query, later.attrs) == (None, later.id,
                                                        dict(qid=7))


def test_switched_off_records_nothing_and_still_times(engine, roots):
    engine.bfs(roots, backend="stepper")
    trace.set_enabled(False)
    try:
        assert not trace.RECORDER.enabled
        res, spans = _query(engine, roots, backend="stepper")
    finally:
        trace.set_enabled(True)
    assert spans == []
    assert all(t["agg_s"] > 0 and t["init_s"] > 0 for t in res.timings)
    assert all(r["seconds"] > 0 for rows in res.per_level_stats
               for r in rows)


def test_spans_are_ranges_of_the_profiler(engine, roots):
    from torch.profiler import ProfilerActivity, profile
    engine.bfs(roots)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.bfs(roots)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"engine.query", "driver.run", "driver.init", "level.issue",
            "level.wait", "level.sync", "finalize", "finalize.map",
            "engine.assemble", "engine.tree_depth",
            "engine.edges_traversed"} <= names
    assert not torch.autograd._profiler_enabled()


def test_server_queue_wait_and_dispatch(graph, roots):
    server = BFSServer({"g": graph}, device="cpu", autostart=False)
    try:
        t0 = time.perf_counter()
        handles = [server.submit("g", roots[i:i + 2], client=c)
                   for c in ("alice", "bob") for i in (0, 2)]
        server.start()
        for h in handles:
            h.result(timeout=300)
    finally:
        server.close()
    spans = trace.spans(t0)
    waits = [s for s in spans if s.name == "server.queue_wait"]
    assert sorted(s.attrs["qid"] for s in waits) == sorted(
        h.qid for h in handles)
    for s, h in zip(sorted(waits, key=lambda s: s.attrs["qid"]),
                    sorted(handles, key=lambda h: h.qid)):
        assert s.start == h.submitted_at and s.end >= s.start
    dispatch = {s.id: s for s in spans if s.name == "server.dispatch"}
    assert sum(s.attrs["queries"] for s in dispatch.values()) == 4
    assert sum(s.attrs["roots"] for s in dispatch.values()) == 8
    queries = [s for s in spans if s.name == "engine.query"]
    assert queries and all(q.parent in dispatch for q in queries)
    assert all(dispatch[q.parent].attrs["bucket"] == q.attrs["bucket"]
               for q in queries)
    totals = server.stats()["totals"]
    assert totals["queue_wait_s"] == pytest.approx(
        sum(s.end - s.start for s in waits), rel=1e-12)
    assert totals["busy_s"] == pytest.approx(
        sum(s.end - s.start for s in dispatch.values()), rel=1e-12)

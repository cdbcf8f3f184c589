"""Serving partitioned plans: the port's front and followers on gloo ranks
against the JAX package's `BFSServer` on a 4-device mesh.

The reference runs once (`conftest.run_in_devices`, 4 host devices, the
XLA formulation `backend_kernels=False`, which its own tests hold bitwise
equal to interpret mode), one subprocess a partition count. The port runs
`BFSServer(front=PartitionFront(group))` on rank 0 of P gloo ranks on the
CPU and `partition_front.follow` on the others (`parallel.ranks`), one
spawn a P, in threads beside the reference. For P = 2 and 4 and every
strategy, one server a strategy serves a coalesced pair (queued before
the worker starts), a sharded batch and a streamed partitioned stepper
query: parents, levels, `num_levels` and the stream rows' level,
direction, frontier_size and frontier_edges must be equal, exactly (all
integers), and both servers must count the same batches.

The P = 2 spawn then serves the agreement cases, one server each: a
transient `dispatch[mode=sharded]` fault (retried, then served); a
`dispatch[mode=stepper,level=2]` fault with no retries (the CPU chain's
`degraded_backend` serves it; the card's chain, which has no gather stage,
fails it with `FaultInjected`); a cancel and an expired deadline on a
streamed partitioned query; `device@*`. After each, the next query on the
same group is served, and the followers' counts of agreed aborts equal the
front's. It also counts the control checks of a batched sharded
`Engine.bfs_plan` against the reference's.

A third spawn holds an idle follower past its channel's collective
timeout (heartbeats keep it), then a follower that raises mid-query
outside a check point: the front fails the query and the queued one with
`SessionUnavailable`, and `close()` returns within a bound. A session's
background pre-warm, which may run while its group serves, issues no
collective.
"""
import concurrent.futures
import datetime
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_in_devices
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.engine import (BFSServer, Engine, GraphSession,
                                PartitionFront, QueryCancelled,
                                QueryControl, QueryDeadlineExceeded,
                                RetryPolicy, SessionUnavailable, follow)
from repro_torch.engine import level_loop as TL
from repro_torch.engine import server as TS
from repro_torch.parallel import ranks
from repro_torch.runtime import faults as TF
from repro_torch.runtime import reset_process_caches, runtime_scope

SCALE, SEED = 10, 3
GRAPH = TG.rmat(SCALE, seed=SEED)
_LIVE = np.flatnonzero(GRAPH.degrees > 0)
ROOTS = [int(np.argmax(GRAPH.degrees))] + [int(r) for r in _LIVE[:7]]
PAIR = (ROOTS[0:2], ROOTS[2:3])      # coalesced: equal plans
BATCH = ROOTS[3:6]
STREAM = ROOTS[6:8]
STRATEGIES = TPT.STRATEGIES
PARTS = (2, 4)
RANK_TIMEOUT = 240           # bounds each spawn: no test can hang the suite
CHANNEL_TIMEOUT = 120.0
IDLE_TIMEOUT = 3.0           # the idle test's channel timeout
DATA_TIMEOUT = 20.0          # the dying-rank test's data group timeout
RESULT_TIMEOUT = 120
DELAY = "straggler@*:delay=100ms"    # slows each level at the front

REF_CODE = r"""
import numpy as np
from repro.core import graph as G
from repro.core.bfs import BFSConfig
from repro.engine import Engine, QueryControl
from repro.engine.server import BFSServer

P, STRATEGIES, PAIR, BATCH, STREAM, OUT = {p!r}, {strategies!r}, \
    {pair!r}, {batch!r}, {stream!r}, {out!r}
g = G.rmat({scale}, seed={seed})
cfg = BFSConfig(backend_kernels=False)
out = {{}}
for s in STRATEGIES:
    kw = dict(backend="sharded", n_parts=P, strategy=s)
    srv = BFSServer({{"g": g}}, autostart=False)
    hs = [srv.submit("g", r, cfg, **kw) for r in PAIR]
    srv.start()
    for h in hs:
        h.result(300)
    hs.append(srv.submit("g", BATCH, cfg, **kw))
    st = srv.submit("g", STREAM, cfg, backend="stepper", n_parts=P,
                    strategy=s, stream=True)
    rows = [[r["root"], r["level"], r["direction"] == "bu",
             r["frontier_size"], r["frontier_edges"]]
            for r in st.stream(timeout=300)]
    for name, h in zip(("pair0", "pair1", "batch", "stream"), hs + [st]):
        res = h.result(300)
        for f in ("parent", "level", "num_levels"):
            out[f"{{s}}/{{name}}/{{f}}"] = getattr(res, f)
    out[f"{{s}}/rows"] = np.array(rows, dtype=np.int64)
    srv.close()
    c = srv.stats()["sessions"]["g"]
    out[f"{{s}}/counts"] = np.array([c["served"], c["batches"]])

class Counting(QueryControl):
    checks = 0
    def check(self):
        Counting.checks += 1
        super().check()

if P == 2:
    eng = Engine(g)
    ctl = Counting()
    eng.bfs_plan(BATCH, eng.plan(cfg, backend="sharded", n_parts=2),
                 control=ctl)
    out["checks"] = np.int64(Counting.checks)
np.savez(OUT, **out)
print("REF_OK")
"""


class Counting(QueryControl):
    """A control that counts its checks."""

    def __init__(self):
        super().__init__()
        self.checks = 0

    def check(self) -> None:
        self.checks += 1
        super().check()


def _tree(res) -> dict:
    return dict(parent=res.parent, level=res.level,
                num_levels=res.num_levels)


def _rows(rows) -> np.ndarray:
    return np.array([[r["root"], r["level"], r["direction"] == "bu",
                      r["frontier_size"], r["frontier_edges"]]
                     for r in rows], dtype=np.int64)


def _sessions(device, group=None):
    return {"g": GraphSession(GRAPH, device, group=group)}


def _parity_server(sessions, group, n_parts, strategy) -> dict:
    """Rank 0: the reference's queries on one server over `strategy`."""
    kw = dict(backend="sharded", n_parts=n_parts, strategy=strategy)
    out = {}
    srv = BFSServer(sessions, autostart=False,
                    front=PartitionFront(group, timeout=CHANNEL_TIMEOUT))
    try:
        hs = [srv.submit("g", r, **kw) for r in PAIR]
        srv.start()
        for h in hs:                # the batch must not join the pair
            h.result(RESULT_TIMEOUT)
        hs.append(srv.submit("g", BATCH, **kw))
        st = srv.submit("g", STREAM, backend="stepper", n_parts=n_parts,
                        strategy=strategy, stream=True)
        out["rows"] = _rows(st.stream(timeout=RESULT_TIMEOUT))
        for name, h in zip(("pair0", "pair1", "batch", "stream"), hs + [st]):
            res = h.result(RESULT_TIMEOUT)
            assert (res.backend, res.n_parts) == (
                "stepper" if name == "stream" else "sharded", n_parts)
            out[name] = _tree(res)
    finally:
        srv.close()
    c = srv.stats()["sessions"]["g"]
    out["counts"] = [c["served"], c["batches"]]
    out["front"] = srv.stats()["front"]
    return out


def _served(srv, roots=BATCH, **kw):
    """Submit one sharded query and return its validated result."""
    res = srv.submit("g", roots, backend="sharded", n_parts=2,
                     **kw).result(RESULT_TIMEOUT)
    return res.validate(GRAPH)


def _stream_then_cancel(srv):
    """A streamed partitioned query cancelled after its first row."""
    h = srv.submit("g", STREAM, backend="stepper", n_parts=2, stream=True)
    rows = []
    with pytest.raises(QueryCancelled):
        for row in h.stream(timeout=RESULT_TIMEOUT):
            rows.append(row)
            h.cancel()
    return dict(rows=len(rows), partial=len(h.partial_stats or []))


def _stream_past_deadline(srv):
    """A streamed partitioned query whose deadline passes mid-search."""
    h = srv.submit("g", STREAM, backend="stepper", n_parts=2, stream=True,
                   deadline=0.25)
    with pytest.raises(QueryDeadlineExceeded):
        h.result(RESULT_TIMEOUT)
    return dict(partial=len(h.partial_stats or []))


def _stepper_fault(srv):
    """A streamed stepper query that hits a dispatch fault at level 2."""
    h = srv.submit("g", STREAM, backend="stepper", n_parts=2, stream=True)
    rows = list(h.stream(timeout=RESULT_TIMEOUT))
    return dict(rows=len(rows), tree=_tree(h.result(RESULT_TIMEOUT)))


def _card_chain(srv):
    """The same fault under the card's degradation chain (no gather
    stage): the client gets the fault."""
    orig = TS._degrade_stages
    TS._degrade_stages = lambda plan, stream, device: orig(
        plan, stream, torch.device("cuda"))
    try:
        h = srv.submit("g", STREAM, backend="stepper", n_parts=2,
                       stream=True)
        with pytest.raises(TF.FaultInjected):
            h.result(RESULT_TIMEOUT)
    finally:
        TS._degrade_stages = orig
    return {}


def _device_pressure(srv):
    with pytest.raises(TF.DevicePressure):
        srv.submit("g", BATCH, backend="sharded",
                   n_parts=2).result(RESULT_TIMEOUT)
    return {}


def _retried(srv):
    return dict(tree=_tree(_served(srv)))


# name: (fault schedule, retry policy, the case on rank 0)
AGREEMENT_CASES = {
    "retried": ("dispatch[mode=sharded]@0", None, _retried),
    "stepper_fault": ("dispatch[mode=stepper,level=2]",
                      RetryPolicy(max_retries=0), _stepper_fault),
    "card_chain": ("dispatch[mode=stepper,level=2]",
                   RetryPolicy(max_retries=0), _card_chain),
    "cancel": (DELAY, None, _stream_then_cancel),
    "deadline": (DELAY, None, _stream_past_deadline),
    "device": ("device@*", None, _device_pressure),
}


def _agreement_server(sessions, group, name) -> dict:
    """Rank 0: one agreement case, then the next query on the group."""
    schedule, retry, case = AGREEMENT_CASES[name]
    srv = BFSServer(sessions, retry=retry,
                    front=PartitionFront(group, timeout=CHANNEL_TIMEOUT))
    try:
        with TF.fault_scope(schedule):
            out = case(srv)
        out["next"] = _tree(_served(srv))
    finally:
        srv.close()
    c = dict(srv.stats()["sessions"]["g"])
    out["counters"] = {k: c[k] for k in (
        "served", "failed", "retries", "cancelled", "expired",
        "degraded_backend", "dispatch_failures")}
    out["front"] = srv.stats()["front"]
    return out


def serve_rank(rank, group, device, n_parts):
    """One rank of the parity spawn (and, at P = 2, the agreement cases
    and the counted checks): rank 0 serves, the others follow."""
    sessions = _sessions(device)
    out = {}
    if n_parts == 2:
        eng = Engine(sessions["g"])
        ctl = Counting()
        eng.bfs_plan(BATCH, eng.plan(backend="sharded", n_parts=2),
                     control=ctl)
        out["checks"] = ctl.checks
    servers = len(STRATEGIES) + (len(AGREEMENT_CASES) if n_parts == 2 else 0)
    if rank != 0:
        out["follow"] = [follow(sessions, group, timeout=CHANNEL_TIMEOUT)
                         for _ in range(servers)]
        return out
    for s in STRATEGIES:
        out[s] = _parity_server(sessions, group, n_parts, s)
    if n_parts == 2:
        for name in AGREEMENT_CASES:
            out[name] = _agreement_server(sessions, group, name)
    return out


def _raise_at_level_2(orig):
    def compute(self, state, sync):
        if sync["cur"] == 2:
            raise RuntimeError("rank died at level 2")
        return orig(self, state, sync)
    return compute


def lifetime_rank(rank, group, device):
    """The idle follower, then the follower that dies mid-query."""
    sessions = _sessions(device)
    data = dist.new_group([0, 1], backend="gloo",
                          timeout=datetime.timedelta(seconds=DATA_TIMEOUT))
    lost = _sessions(device, group=data)
    if rank != 0:
        out = dict(idle=follow(sessions, group, timeout=IDLE_TIMEOUT))
        TL.BSPStepBackend.compute = _raise_at_level_2(
            TL.BSPStepBackend.compute)
        try:
            follow(lost, data, timeout=CHANNEL_TIMEOUT)
        except RuntimeError as e:
            out["died"] = str(e)
        return out
    out = {}
    srv = BFSServer(sessions, front=PartitionFront(group,
                                                   timeout=IDLE_TIMEOUT))
    try:
        out["first"] = _tree(_served(srv))
        time.sleep(3 * IDLE_TIMEOUT)
        out["after_idle"] = _tree(_served(srv))
    finally:
        srv.close()
    out["idle_front"] = srv.stats()["front"]
    srv = BFSServer(lost, front=PartitionFront(data, timeout=CHANNEL_TIMEOUT))
    t0 = time.monotonic()
    try:
        h = srv.submit("g", STREAM, backend="stepper", n_parts=2,
                       stream=True)
        queued = srv.submit("g", BATCH, backend="sharded", n_parts=2)
        fused = srv.submit("g", BATCH, backend="fused")
        for what, handle in (("query", h), ("queued", queued)):
            try:
                handle.result(RESULT_TIMEOUT)
                out[what] = "served"
            except SessionUnavailable as e:
                out[what] = type(e).__name__
        out["fused"] = _tree(fused.result(RESULT_TIMEOUT))
        try:
            srv.submit("g", BATCH, backend="sharded", n_parts=2)
            out["submit"] = "admitted"
        except SessionUnavailable as e:
            out["submit"] = str(e)
    finally:
        t1 = time.monotonic()
        srv.close(timeout=30)
        out["close_s"] = time.monotonic() - t1
    out["lost_s"] = t1 - t0
    out["lost_front"] = srv.stats()["front"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference (one subprocess a P) and the port (one spawn a P, and
    the lifetime spawn), all at once."""
    d = tmp_path_factory.mktemp("sharded_server")
    paths = {p: str(d / f"ref{p}.npz") for p in PARTS}
    codes = [REF_CODE.format(p=p, strategies=STRATEGIES, pair=PAIR,
                             batch=BATCH, stream=STREAM, out=paths[p],
                             scale=SCALE, seed=SEED) for p in PARTS]
    rdv = str(d)
    with concurrent.futures.ThreadPoolExecutor(5) as ex:
        refs = [ex.submit(run_in_devices, c, 4, 400) for c in codes]
        ports = {p: ex.submit(ranks.run_ranks, serve_rank, p, rdv,
                              args=(p,), device="cpu", timeout=RANK_TIMEOUT)
                 for p in PARTS}
        life = ex.submit(ranks.run_ranks, lifetime_rank, 2, rdv,
                         device="cpu", timeout=RANK_TIMEOUT)
        assert all("REF_OK" in f.result() for f in refs)
        out = dict(port={p: f.result() for p, f in ports.items()},
                   life=life.result())
    out["ref"] = {}
    for p in PARTS:
        with np.load(paths[p]) as z:
            out["ref"][p] = {k: z[k] for k in z.files}
    return out


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("p", PARTS)
def test_served_partitioned_plans_match_reference(runs, p, strategy):
    ref, front = runs["ref"][p], runs["port"][p][0][strategy]
    for name in ("pair0", "pair1", "batch", "stream"):
        for f in ("parent", "level", "num_levels"):
            _same(front[name][f], ref[f"{strategy}/{name}/{f}"],
                  f"P={p} {strategy} {name}: {f}")
    _same(front["rows"], ref[f"{strategy}/rows"], f"P={p} {strategy} rows")
    # the pair coalesced into one dispatch, as in the reference
    _same(front["counts"], ref[f"{strategy}/counts"], "served, batches")
    assert front["counts"] == [4, 3]


@pytest.mark.parametrize("p", PARTS)
def test_followers_ran_every_dispatch(runs, p):
    """Each follower ran one dispatch a front dispatch and aborted where
    the front's agreements aborted, then left at close."""
    outs = runs["port"][p]
    names = list(STRATEGIES) + (list(AGREEMENT_CASES) if p == 2 else [])
    for rank in range(1, p):
        follows = outs[rank]["follow"]
        assert len(follows) == len(names)
        for name, got in zip(names, follows):
            front = outs[0][name]["front"]
            assert got["runs"] == front["dispatches"], (rank, name)
            assert got["aborts"] == front["agreed_aborts"], (rank, name)
            assert not front["lost"]
            assert front["agreements"] > front["dispatches"]


def test_batched_sharded_checks_control_as_reference(runs):
    """A batched sharded query checks its control at entry only."""
    want = int(runs["ref"][2]["checks"])
    assert want == 1
    for out in runs["port"][2]:
        assert out["checks"] == want


@pytest.mark.parametrize("name", list(AGREEMENT_CASES))
def test_agreement_case_ends_alike_and_group_serves_on(runs, name):
    out = runs["port"][2][0][name]
    c = out["counters"]
    want = dict(
        retried=dict(served=2, retries=1, failed=0),
        stepper_fault=dict(served=2, degraded_backend=1, failed=0),
        card_chain=dict(served=1, degraded_backend=0, failed=1),
        cancel=dict(served=1, cancelled=1, failed=0),
        deadline=dict(served=1, expired=1, failed=0),
        device=dict(served=1, failed=1, dispatch_failures=2),
    )[name]
    assert {k: c[k] for k in want} == want, c
    assert out["front"]["agreed_aborts"] >= 1
    ref = runs["ref"][2]
    batch = {f: ref[f"specialized/batch/{f}"]
             for f in ("parent", "level", "num_levels")}
    for f in batch:                 # the next query on the group
        _same(out["next"][f], batch[f], f"{name}: next query {f}")
    if name == "retried":
        for f in batch:
            _same(out["tree"][f], batch[f], f)
    if name == "stepper_fault":
        for f in ("parent", "level"):
            _same(out["tree"][f], ref[f"specialized/stream/{f}"], f)
    if name == "cancel":
        assert out["rows"] >= 1 and out["partial"] >= 1


def test_idle_follower_outlives_channel_timeout(runs):
    front, follower = runs["life"]
    assert front["idle_front"]["beats"] >= 2
    assert follower["idle"]["beats"] >= 2
    assert follower["idle"]["runs"] == 2
    for f in ("parent", "level"):
        _same(front["after_idle"][f], front["first"][f], f)


def test_rank_that_dies_loses_the_group(runs):
    front, follower = runs["life"]
    assert "rank died at level 2" in follower["died"]
    assert front["query"] == "PartitionLost"
    assert front["queued"] == "PartitionLost"
    assert "partition group is lost" in front["submit"]
    assert front["lost_front"]["lost"]
    assert front["close_s"] < 5.0
    assert front["lost_s"] < DATA_TIMEOUT + 30
    assert isinstance(front["fused"]["parent"], np.ndarray)


def test_prewarm_issues_no_collective(tmp_path, monkeypatch):
    """The pre-warm thread runs beside the front's dispatches: it must
    issue no collective on the data group or the channel."""
    with runtime_scope(cache_dir=str(tmp_path), prewarm=False):
        s = GraphSession(GRAPH, "cpu")
        Engine(s).bfs(BATCH, backend="fused")
        s.close()
    reset_process_caches()
    calls = []
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "broadcast", "broadcast_object_list", "barrier", "new_group",
                 "reduce", "send", "recv"):
        monkeypatch.setattr(dist, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    with runtime_scope(cache_dir=str(tmp_path)):
        s = GraphSession(GRAPH, "cpu")
        progress = s.prewarm_wait(60)
        assert s.close(10)
    reset_process_caches()
    assert progress["loaded"] == 3 and progress["error"] is None
    assert calls == []

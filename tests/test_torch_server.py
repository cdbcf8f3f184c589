"""The port's `BFSServer` on the CPU against the JAX package's `BFSServer`,
on the two RMAT scale-9 graphs of `tests/test_server.py`.

* the same queries (batched, one root, the stepper) give equal parents and
  levels; streamed rows have equal keys and values, seconds aside;
* coalescing, admission rejections, cancel and deadline give the same
  results and counters;
* under the fault schedules of `tests/test_faults.py` (worker crash,
  transient dispatch fault, the degradation chain, a streamed fused query
  that cannot degrade, the breaker, a build fault, device pressure), with
  `kernels=pallas` written `kernels=tiles` for the port and each query's
  formulation given explicitly, both servers count the same events;
* a partitioned plan on a session with no group of `n_parts` ranks is
  refused at submit.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import bfs as JB
from repro.core import graph as JG
from repro.engine import server as JS
from repro.engine import queueing as JQ
from repro.runtime import faults as JF
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import server as TS
from repro_torch.engine import queueing as TQ
from repro_torch.engine.level_loop import (QueryCancelled as TCancelled,
                                           QueryDeadlineExceeded as TExpired)
from repro.engine.level_loop import (QueryCancelled as JCancelled,
                                     QueryDeadlineExceeded as JExpired)
from repro_torch.runtime import faults as TF
from repro_torch.runtime import reset_process_caches

PORT = SimpleNamespace(
    name="port", G=TG, Config=TB.BFSConfig, Q=TQ, F=TF,
    Server=lambda graphs, **kw: TS.BFSServer(graphs, device="cpu", **kw),
    Cancelled=TCancelled, Expired=TExpired, tiles="tiles")
REF = SimpleNamespace(
    name="jax", G=JG, Config=JB.BFSConfig, Q=JQ, F=JF, Server=JS.BFSServer,
    Cancelled=JCancelled, Expired=JExpired, tiles="pallas")
TIMEOUT = 300
VOLATILE = ("seconds", "compute_s", "exchange_s")


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    """Plans are shared across sessions by graph content, and this file's
    tests reuse graphs: reset the port's registry (and its fingerprint and
    cache memos) around each test, so build counts do not depend on which
    tests ran before."""
    reset_process_caches()
    yield
    reset_process_caches()


def _graphs(pkg):
    return {"g0": pkg.G.rmat(9, seed=7), "g1": pkg.G.rmat(9, seed=1)}


def _roots(pkg, n=4, name="g0"):
    return np.flatnonzero(_graphs(pkg)[name].degrees > 0)[:n]


def _counters(server, name):
    """A session's counters without the timings. Read them after `close()`
    (which joins the workers) for final values: a worker counts a served
    query just after it wakes the client."""
    c = dict(server.stats()["sessions"][name])
    for k in ("busy_s", "queue_wait_s", "runtime", "queue_depth"):
        c.pop(k, None)
    return c


def _both(fn):
    """fn(pkg) for the port and the reference."""
    return fn(PORT), fn(REF)


# -------------------------------------------------------------- results


def _queries(pkg):
    graphs = _graphs(pkg)
    server = pkg.Server(graphs)
    try:
        handles = []
        for name in graphs:
            roots = _roots(pkg, 6, name)
            handles += [
                server.submit(name, roots[:4], client="a"),
                server.submit(name, int(roots[4]), client="b"),
                server.submit(name, roots[:2], backend="stepper",
                              client="c"),
                server.submit(name, roots[:3],
                              pkg.Config(heuristic="beamer", hub_split=True,
                                         hub_deg=32), client="d")]
        out = [(h.result(TIMEOUT).parent, h.result(TIMEOUT).level)
               for h in handles]
        server.close()
        return out, {n: _counters(server, n)["served"] for n in graphs}
    finally:
        server.close()


def test_results_match_reference():
    (mine, served), (ref, ref_served) = _both(_queries)
    assert served == ref_served == {"g0": 4, "g1": 4}
    for (p, l), (rp, rl) in zip(mine, ref):
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(l, rl)


def _streams(pkg):
    server = pkg.Server(_graphs(pkg))
    try:
        roots = _roots(pkg, 3)
        h = server.submit("g0", roots[:2], stream=True, client="s")
        stepper = [{k: v for k, v in row.items() if k not in VOLATILE}
                   for row in h.stream(TIMEOUT)]
        res = h.result(TIMEOUT)
        h = server.submit("g0", roots, backend="fused", stream=True,
                          client="s")
        fused = [{k: v for k, v in row.items() if k not in VOLATILE}
                 for row in h.stream(TIMEOUT)]
        return stepper, fused, res.parent, h.result(TIMEOUT).level
    finally:
        server.close()


def _plain(x):
    """Rows with numpy scalars and arrays as plain Python values."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, np.ndarray)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def test_streamed_rows_match_reference():
    mine, ref = _both(_streams)
    assert _plain(mine[0]) == _plain(ref[0])       # stepper, root per row
    assert {r["root"] for r in mine[0]} == {int(r) for r in _roots(PORT, 2)}
    assert _plain(mine[1]) == _plain(ref[1])       # fused, root -1
    assert {r["root"] for r in mine[1]} == {-1}
    np.testing.assert_array_equal(mine[2], ref[2])
    np.testing.assert_array_equal(mine[3], ref[3])


def _coalesce(pkg):
    """Five queued queries of one plan and one of another: the worker fuses
    the compatible run into one dispatch and splits it back."""
    server = pkg.Server(_graphs(pkg), autostart=False, max_batch_roots=9)
    try:
        roots = _roots(pkg, 8)
        hs = [server.submit("g0", roots[i:i + 2], client=f"c{i}")
              for i in range(0, 8, 2)]
        hs.append(server.submit("g0", roots[:1],
                                pkg.Config(heuristic="beamer"), client="x"))
        hs.append(server.submit("g0", roots[2:4], client="y"))
        server.start()
        out = [h.result(TIMEOUT) for h in hs]
        server.close()
        return ([(r.roots.tolist(), r.parent, r.level) for r in out],
                _counters(server, "g0"))
    finally:
        server.close()


def test_coalesced_splits_match_reference():
    (mine, c), (ref, rc) = _both(_coalesce)
    assert c == rc
    assert c["served"] == 6 and c["batches"] < 6
    for (r, p, l), (rr, rp, rl) in zip(mine, ref):
        assert r == rr
        np.testing.assert_array_equal(p, rp)
        np.testing.assert_array_equal(l, rl)


def _admission(pkg):
    server = pkg.Server(_graphs(pkg), autostart=False, max_queue_depth=2,
                        max_inflight_per_client=1)
    errors = []
    try:
        roots = _roots(pkg, 2)
        hs = [server.submit("g0", roots, client="a")]
        for client in ("a", "b", "c"):
            try:
                hs.append(server.submit("g0", roots, client=client))
            except pkg.Q.ServerOverloaded as e:
                errors.append((client, e.reason))
        server.start()
        for h in hs:
            h.result(TIMEOUT)
        server.close()
        return errors, _counters(server, "g0")
    finally:
        server.close()


def test_admission_rejections_match_reference():
    (errs, c), (rerrs, rc) = _both(_admission)
    assert errs == rerrs == [("a", "client_inflight"), ("c", "queue_full")]
    assert c == rc and c["rejected"] == 2


def _cancel_deadline(pkg):
    server = pkg.Server(_graphs(pkg), autostart=False)
    out = []
    try:
        roots = _roots(pkg, 2)
        h1 = server.submit("g0", roots, client="a")
        h2 = server.submit("g0", roots, client="b", deadline=0.0)
        h3 = server.submit("g0", roots, client="c")
        h1.cancel()
        server.start()
        for h in (h1, h2, h3):
            try:
                h.result(TIMEOUT)
                out.append("served")
            except pkg.Cancelled:
                out.append("cancelled")
            except pkg.Expired:
                out.append("expired")
        server.close()
        return out, _counters(server, "g0")
    finally:
        server.close()


def test_cancel_and_deadline_match_reference():
    (out, c), (rout, rc) = _both(_cancel_deadline)
    assert out == rout == ["cancelled", "expired", "served"]
    assert c == rc and (c["cancelled"], c["expired"]) == (1, 1)


def test_cancel_inflight_stream_frees_the_worker():
    """A streamed query on a long path aborts within a level of its
    cancel; the next query is served (the port alone: the timing is its
    own)."""
    n = 512
    g = TG.from_edges(np.arange(n - 1), np.arange(1, n), n)
    server = PORT.Server({"p": g})
    try:
        server.submit("p", 0, stream=True, client="w").result(TIMEOUT)
        h = server.submit("p", 0, stream=True, client="a")
        next(h.stream(TIMEOUT))
        h.cancel()
        with pytest.raises(TCancelled):
            h.result(TIMEOUT)
        assert 1 <= len(h.partial_stats[0]) < n - 1
        server.submit("p", n - 1, client="a").result(TIMEOUT).validate(g)
        assert server._caps.inflight("a") == 0
    finally:
        server.close()


# ------------------------------------------------------- fault schedules


def _warm(server, pkg, cfg, **kw):
    server.submit("g0", _roots(pkg), cfg, client="w", **kw).result(TIMEOUT)


def _schedule_case(case, pkg):
    """One schedule of `tests/test_faults.py` against `pkg`'s server:
    (outcomes, counters, breaker snapshot)."""
    off = pkg.Config(backend_kernels=False)
    kern = pkg.Config(backend_kernels=True)
    Retry = pkg.Q.RetryPolicy
    graphs = {"g0": _graphs(pkg)["g0"]}
    kw = dict(worker=dict(), transient=dict(),
              degrade=dict(retry=Retry(max_retries=0), breaker_threshold=100),
              stream=dict(retry=Retry(max_retries=0), breaker_threshold=100),
              breaker=dict(retry=Retry(max_retries=0), breaker_threshold=2,
                           breaker_reset_s=0.2),
              compile=dict(),
              device_gather=dict(breaker_threshold=100),
              device_tiles=dict(breaker_threshold=100))[case]
    if case == "compile":
        graphs = {"g0": pkg.G.from_edges(np.arange(96), np.arange(1, 97),
                                         97)}
    server = pkg.Server(graphs, **kw)
    out = []

    def run(*a, **k):
        try:
            r = server.submit("g0", *a, **k).result(TIMEOUT)
            r.validate(graphs["g0"])
            out.append(("ok", r.parent, r.level))
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append(("err", type(e).__name__))

    try:
        roots = ([0, 1] if case == "compile"
                 else _roots(pkg, 3 if case == "stream" else 4))
        F = pkg.F
        if case == "worker":
            with F.fault_scope("worker@0", seed=0):
                run(roots, off, client="a")
        elif case == "transient":
            with F.fault_scope("dispatch[mode=batch]@0", seed=0):
                run(roots, off, client="a")
        elif case == "degrade":
            run(roots, kern, client="o")
            run(roots, off, client="o")
            with F.fault_scope(f"dispatch[kernels={pkg.tiles}]@*", seed=0):
                run(roots, kern, client="d")
            with F.fault_scope("dispatch[mode=batch]@*", seed=0):
                run(roots, off, client="d")
        elif case == "stream":
            _warm(server, pkg, off, backend="fused")
            with F.fault_scope("dispatch[mode=batch]@*", seed=0):
                run(roots, off, backend="fused", stream=True, client="a")
        elif case == "breaker":
            _warm(server, pkg, off)
            with F.fault_scope("dispatch@*:limit=2", seed=0):
                run(roots, off, client="a")
                try:
                    server.submit("g0", roots, off, client="a")
                except pkg.Q.SessionUnavailable as e:
                    out.append(("unavailable", e.state))
            out.append(("state", _counters(server, "g0")["breaker"]))
            time.sleep(0.25)
            run(roots, off, client="a")
        elif case == "compile":
            with F.fault_scope("compile@0", seed=0):
                run(roots, client="a")
        else:
            cfg = off if case == "device_gather" else kern
            _warm(server, pkg, cfg)
            with F.fault_scope("device@*", seed=0):
                run(roots, cfg, client="a")
        server.close()
        out.append(("inflight", server._caps.inflight("a")))
        return out, _counters(server, "g0")
    finally:
        server.close()


def _same_outcomes(mine, ref):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if a[0] == "ok":
            assert b[0] == "ok"
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
        else:
            assert a == b


@pytest.mark.parametrize("case", ["worker", "transient", "degrade", "stream",
                                  "breaker", "compile", "device_gather",
                                  "device_tiles"])
def test_fault_schedules_count_alike(case):
    (mine, c), (ref, rc) = _both(lambda pkg: _schedule_case(case, pkg))
    _same_outcomes(mine, ref)
    assert c == rc, case
    expect = dict(
        worker=dict(worker_crashes=1, worker_restarts=1, served=1),
        transient=dict(retries=1, dispatch_failures=1, served=1),
        degrade=dict(degraded_backend=1, degraded_scalar=1, served=4),
        stream=dict(degraded_scalar=0, failed=1),
        breaker=dict(breaker_rejected=1, failed=1),
        compile=dict(retries=1, served=1, failed=0),
        device_gather=dict(retries=0, failed=1),
        device_tiles=dict(retries=0, failed=1))[case]
    assert {k: c[k] for k in expect} == expect


# ---------------------------------------------------------- port only


def test_cuda_chain_never_runs_gather(monkeypatch):
    """On a CUDA session the chain has no kernels-off stage: a failed tiles
    dispatch goes to the scalar stage (still the kernels) or fails with its
    own error, and the CSR gather steps never run. The CPU keeps the
    reference's two stages. The stage list is device-typed, so the CUDA
    chain's shape is driven here on CPU tensors."""
    import torch
    from repro_torch.engine import Engine
    eng = Engine(_graphs(PORT)["g0"], device="cpu")
    tiles = eng.plan(TB.BFSConfig(backend_kernels=True), backend="fused")
    gather = eng.plan(TB.BFSConfig(backend_kernels=False), backend="fused")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TS._degrade_stages(tiles, False, cuda) == [
        ("degraded_scalar", tiles, False)]
    assert TS._degrade_stages(tiles, True, cuda) == []
    assert TS._degrade_stages(gather, False, cuda) == [
        ("degraded_scalar", gather, False)]
    assert [(c, TB.kernels_enabled(p.hcfg.bfs), b) for c, p, b in
            TS._degrade_stages(tiles, False, cpu)] == [
        ("degraded_backend", False, True), ("degraded_scalar", False, False)]

    stages = TS._degrade_stages
    monkeypatch.setattr(TS, "_degrade_stages",
                        lambda plan, stream, device: stages(plan, stream,
                                                            cuda))
    ran = []
    for fn in ("_gather_push", "_gather_first_hits"):
        monkeypatch.setattr(TB, fn, lambda *a, _f=fn, **k: ran.append(_f))
    server = PORT.Server({"g0": _graphs(PORT)["g0"]},
                         retry=TQ.RetryPolicy(max_retries=0),
                         breaker_threshold=100)
    try:
        roots = _roots(PORT)
        kern = TB.BFSConfig(backend_kernels=True)
        oracle = server.submit("g0", roots, kern, client="o").result(TIMEOUT)
        with TF.fault_scope("dispatch[kernels=tiles]@*", seed=0):
            with pytest.raises(TF.FaultInjected):
                server.submit("g0", roots, kern, client="d").result(TIMEOUT)
        with TF.fault_scope("dispatch[mode=batch]@*", seed=0):
            got = server.submit("g0", roots, kern, client="d").result(TIMEOUT)
        np.testing.assert_array_equal(got.parent, oracle.parent)
        np.testing.assert_array_equal(got.level, oracle.level)
        server.close()
        c = _counters(server, "g0")
        assert (c["degraded_backend"], c["degraded_scalar"], c["failed"],
                c["dispatch_failures"], c["served"]) == (0, 1, 1, 3, 2), c
        assert ran == []
    finally:
        server.close()


def test_partitioned_plans_are_refused():
    """With no group of `n_parts` ranks a partitioned plan is refused at
    submit (`GraphSession.group_for`); it is served through a front on a
    group (tests/test_torch_sharded_server.py)."""
    server = PORT.Server(_graphs(PORT))
    try:
        with pytest.raises(ValueError, match="2 partitions need a torch"):
            server.submit("g0", [0, 1], backend="sharded", n_parts=2)
        with pytest.raises(ValueError, match="4 partitions need a torch"):
            server.submit("g0", [0], backend="stepper", n_parts=4)
        assert _counters(server, "g0")["served"] == 0
    finally:
        server.close()


def test_concurrent_workers_count_every_launch(monkeypatch):
    """Two sessions' workers call the wrappers at once: `ops.LAUNCHES`
    loses no count (each CPU call counted through the same `_count` a
    launch uses)."""
    from repro_torch.kernels import ops
    real = ops.bottomup_batch

    def counted(*a, **k):
        ops._count("bottomup_batch")
        return real(*a, **k)
    monkeypatch.setattr(ops, "bottomup_batch", counted)
    ops.reset_launches()
    graphs = {"a": TG.rmat(9, seed=7), "b": TG.rmat(9, seed=7)}
    server = PORT.Server(graphs)
    calls = []
    real_step = TB._bottomup_step_kernels_batch

    def step(*a, **k):
        calls.append(len(a[2]))              # buckets of this pull
        return real_step(*a, **k)
    monkeypatch.setattr(TB, "_bottomup_step_kernels_batch", step)
    try:
        roots = _roots(PORT, 4)
        hs = [server.submit(n, roots, client=f"{n}{i}")
              for i in range(6) for n in graphs]
        for h in hs:
            h.result(TIMEOUT)
    finally:
        server.close()
    assert ops.LAUNCHES["bottomup_batch"] == sum(calls) > 0


def test_two_sessions_build_the_kernels_once(monkeypatch):
    """Two sessions that start at once both ask for the kernel build: the
    build's lock lets one build run at a time, and the second finds the
    libraries built (the build itself runs only where nvcc is; here a
    stand-in records how many builds overlap)."""
    import torch
    from repro_torch.engine.session import GraphSession
    from repro_torch.kernels import _build
    built, inside, peak = [], [0], [0]

    def build_missing(names):
        inside[0] += 1
        peak[0] = max(peak[0], inside[0])
        time.sleep(0.05)
        todo = [] if built else list(names)
        built.extend(todo)
        inside[0] -= 1
        return 0.05 if todo else 0.0
    monkeypatch.setattr(_build, "_build_missing", build_missing)
    g = TG.rmat(6, seed=0)
    sessions = [GraphSession(g, device="cpu") for _ in range(2)]
    for s in sessions:
        s.device = torch.device("cuda", 0)   # ensure_kernels' only input
    go = threading.Barrier(2)

    def start(s):
        go.wait()
        s.ensure_kernels()
    threads = [threading.Thread(target=start, args=(s,)) for s in sessions]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] == 1 and built == list(_build.SOURCES)
    assert all(s._kernels_built for s in sessions)
    # the second waited out the first's build inside its own
    assert all(s.runtime_stats()["kernel_build_s"] >= 0.04
               for s in sessions)


def test_bfs_serve_driver_and_chaos_probe_on_the_cpu():
    """`launch.bfs_serve`: the load driver's CLI with streamed queries, and
    the chaos probe (a worker crash, stragglers, dispatch and build faults
    under load, the chain, the breaker) self-heals."""
    from repro_torch.launch import bfs_serve
    m, stats = bfs_serve.main(["--graphs", "2", "--scale", "8",
                               "--clients", "3", "--queries", "2",
                               "--stream-every", "2", "--device", "cpu"])
    assert m["queries"] == 6 and m["levels_streamed"] > 0
    assert stats["totals"]["served"] == 6 + 4       # with 4 warm-ups
    assert stats["totals"]["failed"] == 0
    out = bfs_serve.run_chaos_probe(scale=8, clients=4,
                                    queries_per_client=3, device="cpu")
    assert out["ok"], out
    assert out["load"]["lost"] == 0
    # the cache phase: a failed record load is evicted, built again, equal
    assert out["cache"]["corrupt_evictions"] >= 1
    assert out["cache"]["rebuilds"] >= 1 and out["cache"]["bitwise"]

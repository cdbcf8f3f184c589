"""BFS query-server driver: N synthetic clients against a `BFSServer`.

The port of the JAX package's `launch/bfs_serve.py`. Stands up a server
over one or more RMAT graph sessions and drives it with concurrent client
threads (Graph500-style random non-isolated roots), reporting sustained
QPS / aggregate component-TEPS, query latency percentiles, and
admission-control counters. `run_load` is the reusable load generator.

  python -m repro_torch.launch.bfs_serve --graphs 2 --scale 12 \
      --clients 8 --queries 6 --batch 4                  # on the GPU
  python -m repro_torch.launch.bfs_serve --graphs 1 --scale 10 \
      --clients 4 --queries 3 --stream-every 2 --cancel-probe --device cpu
  python -m repro_torch.launch.bfs_serve --graphs 1 --scale 9 \
      --clients 2 --queries 2 --cache-dir /tmp/c --restart-probe --device cpu

`--cache-dir DIR` (or REPRO_CACHE_DIR) enables the persistent artifact
cache (kernel libraries and plan records); `--restart-probe` then measures
a cold and a warm restart in two child processes over it
(`run_restart_probe`), and the chaos probe's fourth phase corrupts a plan
record (`run_cache_chaos`).
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.engine import (BFSServer, QueryCancelled, RetryPolicy,
                          ServerOverloaded, SessionUnavailable)


def _root_candidates(g) -> np.ndarray:
    """Graph500 root pool: non-isolated vertices (all, if none have edges)."""
    cand = np.flatnonzero(g.degrees > 0)
    return cand if cand.size else np.arange(g.num_vertices)


def _client_loop(server, names, candidates, *, client_id: str, queries: int,
                 batch: int, seed: int, stream_every: int, out: dict):
    """One synthetic client: submit `queries`, retry on overload, wait all.

    Any failure is recorded in `out[client_id]["error"]` (not swallowed by
    the thread's default excepthook) so `run_load` can fail loudly instead
    of aggregating metrics over the surviving clients only.
    """
    try:
        rng = np.random.default_rng(seed)
        handles, rejected = [], 0
        for i in range(queries):
            name = names[i % len(names)]
            cand = candidates[name]
            roots = rng.choice(cand, size=min(batch, cand.size),
                               replace=False)
            stream = stream_every and (i % stream_every == stream_every - 1)
            while True:
                try:
                    handles.append(server.submit(name, roots,
                                                 client=client_id,
                                                 stream=stream))
                    break
                except ServerOverloaded:
                    # Typed rejection: the client backs off and retries
                    # instead of stalling inside the server.
                    rejected += 1
                    time.sleep(0.002)
        levels_streamed = 0
        for h in handles:
            if h.is_stream:
                levels_streamed += sum(1 for _ in h.stream(timeout=600))
        results = [(h.session, h.result(timeout=600)) for h in handles]
        out[client_id] = dict(
            results=results,
            latencies=[h.latency_s for h in handles],
            rejected=rejected,
            levels_streamed=levels_streamed,
        )
    except Exception as e:  # noqa: BLE001 — reported by run_load
        out[client_id] = dict(error=e)


def run_load(server: BFSServer, graphs: dict, *, clients: int = 8,
             queries_per_client: int = 6, batch: int = 4, seed: int = 0,
             stream_every: int = 0, validate: int = 1,
             keep_results: bool = False,
             before_clients: Optional[Callable[[], None]] = None) -> dict:
    """Drive `server` with concurrent clients; returns sustained metrics.

    `graphs` maps registered session names to their `Graph`s (for root
    sampling and optional oracle validation of `validate` results per
    client). `stream_every=k` makes every k-th query a streamed stepper
    query. Aggregate TEPS uses component-corrected traversed edges.
    `keep_results` adds `results`, every measured query's (session name,
    `TraversalResult`), for the caller's own checks. `before_clients` is
    called after the warm-up queries and just before the clients start
    (e.g. to zero counters that should cover the measured window only).
    """
    names = sorted(graphs)
    candidates = {n: _root_candidates(graphs[n]) for n in names}
    # Warm every session outside the measured window: the first query per
    # (plan, bucket) pays the tile build, the kernel build and the warm-up
    # search; steady-state QPS/latency should measure serving.
    warm = [server.submit(n, candidates[n][:batch], client="warmup")
            for n in names]
    if stream_every:
        warm += [server.submit(n, candidates[n][:1], client="warmup",
                               stream=True) for n in names]
    for h in warm:
        h.result(timeout=600)
    if before_clients is not None:
        before_clients()
    out: dict = {}
    threads = [
        threading.Thread(
            target=_client_loop, args=(server, names, candidates),
            kwargs=dict(client_id=f"client-{c}", queries=queries_per_client,
                        batch=batch, seed=seed * 1000 + c,
                        stream_every=stream_every, out=out),
            name=f"bfs-client-{c}")
        for c in range(clients)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    failures = {cid: c["error"] for cid, c in out.items() if "error" in c}
    if failures:
        raise RuntimeError(f"client failures under load: {failures}")
    if len(out) != clients:
        raise RuntimeError(
            f"only {len(out)}/{clients} clients reported results")
    all_results = [r for c in out.values() for _, r in c["results"]]
    latencies = np.asarray([l for c in out.values() for l in c["latencies"]])
    edges = sum(int(r.edges_traversed.sum()) for r in all_results)
    if validate:
        for c in out.values():
            for name, r in c["results"][:validate]:
                r.validate(graphs[name])
    return dict(
        clients=clients,
        queries=len(all_results),
        roots=int(sum(r.batch_size for r in all_results)),
        wall_s=wall,
        qps=len(all_results) / wall,
        teps_sustained=edges / wall,
        edges_traversed=edges,
        latency_p50_ms=float(np.percentile(latencies, 50) * 1e3),
        latency_p95_ms=float(np.percentile(latencies, 95) * 1e3),
        latency_p99_ms=float(np.percentile(latencies, 99) * 1e3),
        client_rejected=int(sum(c["rejected"] for c in out.values())),
        levels_streamed=int(sum(c["levels_streamed"] for c in out.values())),
        **(dict(results=[nr for c in out.values() for nr in c["results"]])
           if keep_results else {}),
    )


def run_cancel_probe(server: BFSServer, *, levels: int = 2048,
                     queries: int = 6, client: str = "cancel-probe",
                     timeout: float = 600) -> dict:
    """Prove cancellation frees capacity: cancelled queries must cost ~zero.

    Registers a dedicated long-path session (every traversal is
    `levels` level-synchronous rounds, so an uncancelled query is
    expensive), measures a no-cancellation baseline of `queries // 2` full
    traversals, then submits `queries` and cancels every other one right
    after its first streamed level. The survivors' wall time should match
    the baseline (`wall_ratio` ~ 1: cancelled queries release the worker
    within one level instead of serving ~`levels` more), every admission
    slot must free, and a follow-up query must still be served (no worker
    leak).
    """
    from repro_torch.core import graph as G
    name = "__cancel_probe__"
    path = G.from_edges(np.arange(levels), np.arange(1, levels + 1),
                        levels + 1)
    server.register(name, path)
    # Warm-up pays the stepper's warm-up outside both measured windows.
    server.submit(name, 0, stream=True, client=client).result(timeout=timeout)

    n_base = max(queries // 2, 1)
    t0 = time.perf_counter()
    base = [server.submit(name, 0, stream=True, client=client)
            for _ in range(n_base)]
    for h in base:
        h.result(timeout=timeout)
    baseline_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    handles = [server.submit(name, 0, stream=True, client=client)
               for _ in range(queries)]
    for i, h in enumerate(handles):
        if i % 2:
            # Wait for the query's first level (it is provably in flight,
            # not still queued), then cancel: it must abort within a level.
            next(h.stream(timeout=timeout))
            h.cancel()
    served = cancelled = 0
    partial_levels = []
    for h in handles:
        try:
            h.result(timeout=timeout)
            served += 1
        except QueryCancelled:
            cancelled += 1
            partial_levels.append(
                len(h.partial_stats[0]) if h.partial_stats else 0)
    probe_wall = time.perf_counter() - t0

    follow_up = server.submit(name, levels, client=client)
    follow_up_ok = follow_up.result(timeout=timeout) is not None
    return dict(
        levels=levels, queries=queries, served=served, cancelled=cancelled,
        cancelled_partial_levels=partial_levels,
        baseline_wall_s=baseline_wall, probe_wall_s=probe_wall,
        # survivors == baseline count, so ~1.0 when cancellation is free
        wall_ratio=probe_wall / max(baseline_wall, 1e-9),
        qps_survivors=served / max(probe_wall, 1e-9),
        qps_baseline=n_base / max(baseline_wall, 1e-9),
        inflight_after=server._caps.inflight(client),
        worker_alive=follow_up_ok,
    )


def run_fused_cancel_probe(server: BFSServer, *, levels: int = 2048,
                           client: str = "fused-cancel",
                           timeout: float = 600) -> dict:
    """Prove an in-flight FUSED batch aborts at level granularity.

    The cohort fused path runs on the level driver, so a batched dispatch —
    not just a streamed stepper query — honours cancellation between
    levels. Registers a long-path session, measures one full fused batch as
    the baseline, then cancels a second one right after its first streamed
    level: it must abort within a level (partial batch rows on the handle)
    and cost a small fraction of the full traversal.
    """
    from repro_torch.core import graph as G
    name = "__fused_cancel_probe__"
    path = G.from_edges(np.arange(levels), np.arange(1, levels + 1),
                        levels + 1)
    server.register(name, path)
    roots = [0, 1]
    # Warm-up pays the cohort warm-up outside both measured windows.
    server.submit(name, roots, client=client).result(timeout=timeout)
    t0 = time.perf_counter()
    server.submit(name, roots, client=client).result(timeout=timeout)
    full_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    h = server.submit(name, roots, backend="fused", stream=True,
                      client=client)
    next(h.stream(timeout=timeout))       # provably in flight, not queued
    h.cancel()
    try:
        h.result(timeout=timeout)
        cancelled = False
    except QueryCancelled:
        cancelled = True
    cancel_wall = time.perf_counter() - t0
    levels_done = (len(h.partial_stats[0])
                   if h.partial_stats and h.partial_stats[0] else 0)
    return dict(
        levels=levels, batch=len(roots), cancelled=cancelled,
        levels_before_abort=levels_done,
        abort_level_fraction=levels_done / levels,
        full_wall_s=full_wall, cancel_wall_s=cancel_wall,
        wall_fraction=cancel_wall / max(full_wall, 1e-9),
        inflight_after=server._caps.inflight(client),
    )


def _chaos_client_loop(server, names, candidates, *, client_id: str,
                       queries: int, batch: int, seed: int, timeout: float,
                       out: dict):
    """Chaos client: every query must RESOLVE — a result or a typed error.

    Unlike `_client_loop`, typed failures are recorded rather than raised:
    the chaos gate is accounting, `submitted == ok + failed + rejected`
    with zero timeouts. A timeout is the one unacceptable outcome — it
    means a crashed worker silently dropped a query instead of the
    supervisor recovering or failing it."""
    rng = np.random.default_rng(seed)
    ok = failed = rejected = lost = 0
    errors: list = []
    for i in range(queries):
        name = names[i % len(names)]
        cand = candidates[name]
        roots = rng.choice(cand, size=min(batch, cand.size), replace=False)
        try:
            h = server.submit(name, roots, client=client_id)
        except (ServerOverloaded, SessionUnavailable) as e:
            rejected += 1
            errors.append(type(e).__name__)
            time.sleep(0.005)
            continue
        try:
            h.result(timeout=timeout)
            ok += 1
        except TimeoutError:
            lost += 1
            errors.append("TimeoutError")
        except Exception as e:  # noqa: BLE001 — typed failure, accounted
            failed += 1
            errors.append(type(e).__name__)
    out[client_id] = dict(ok=ok, failed=failed, rejected=rejected,
                          lost=lost, errors=errors)


# Phase-A schedule: one worker crash, periodic 2 ms stragglers, two
# transient mid-traversal dispatch faults, one build failure. Everything
# is recoverable (supervision + retry), so the deterministic expectation
# is availability 1.0 with zero lost queries.
CHAOS_LOAD_SCHEDULE = ("worker@1;straggler@every=5:delay=2ms;"
                      "dispatch[mode=batch]@1,4;compile@2")


def run_chaos_probe(*, scale: int = 9, edgefactor: int = 8,
                    clients: int = 8, queries_per_client: int = 4,
                    batch: int = 4, seed: int = 0,
                    schedule: str = CHAOS_LOAD_SCHEDULE,
                    timeout: float = 300.0, device=None) -> dict:
    """Fault-injection probe: serving must self-heal under a seeded schedule.

    Three phases, each under its own `fault_scope` (process-global
    injector, restored on exit), on `device` (None: the GPU):

    1. load — `clients` concurrent clients against two sessions while the
       schedule injects a worker crash, stragglers, transient dispatch
       faults, and a build failure. Gate: zero lost queries (every handle
       resolves), availability >= 0.9, and the crash/restart/retry
       counters prove the faults actually fired and were recovered.
    2. degrade — unrecoverable dispatch faults (`@*`, retries disabled)
       force the degradation chain: tiles -> gather when only the kernel
       path faults (CPU sessions; on the GPU the chain has no gather
       stage, so the query must fail with `FaultInjected` and
       `degraded_backend` stay 0), fused batch -> per-root scalar when the
       whole batched path faults. Gate: degraded results bitwise-equal to
       the fault-free oracle computed before fault installation, parents
       valid.
    3. breaker — a `:limit=`-budgeted always-fault schedule trips the
       per-session circuit breaker (threshold 2) on gather queries (one
       failed query = its batched dispatch + the scalar stage); the next
       submit must be rejected with `SessionUnavailable`; after the reset
       window the half-open probe query must succeed and re-close the
       breaker.

    4. cache — `run_cache_chaos`: a plan record whose load fails (an
       injected `cache_load` fault) is evicted and counted, its plan is
       built again on the query path, and the levels stay bitwise equal.
    """
    from repro_torch.core import graph as G
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.runtime.faults import FaultInjected, fault_scope

    out: dict = {}

    # ------------------------------------------------------------- 1. load
    # Small coalescing caps force many dispatches so the schedule's
    # occurrence indices (worker@1, dispatch@1,4) are guaranteed to exist.
    server, graphs = build_server(2, scale, edgefactor=edgefactor,
                                  seed=seed, max_batch_queries=4,
                                  max_batch_roots=4 * batch, device=device)
    try:
        names = sorted(graphs)
        candidates = {n: _root_candidates(graphs[n]) for n in names}
        with fault_scope(schedule, seed=seed) as inj:
            results: dict = {}
            threads = [
                threading.Thread(
                    target=_chaos_client_loop,
                    args=(server, names, candidates),
                    kwargs=dict(client_id=f"chaos-{c}",
                                queries=queries_per_client, batch=batch,
                                seed=seed * 1000 + c, timeout=timeout,
                                out=results),
                    name=f"chaos-client-{c}")
                for c in range(clients)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            injected = inj.stats()
        if len(results) != clients:
            raise RuntimeError(
                f"only {len(results)}/{clients} chaos clients reported")
        ok = sum(c["ok"] for c in results.values())
        failed = sum(c["failed"] for c in results.values())
        rejected = sum(c["rejected"] for c in results.values())
        lost = sum(c["lost"] for c in results.values())
        resolved = ok + failed + rejected
        stats = server.stats()
        tot = {k: sum(s.get(k, 0) for s in stats["sessions"].values())
               for k in ("worker_crashes", "worker_restarts", "retries",
                         "dispatch_failures")}
        out["load"] = dict(
            clients=clients, submitted=clients * queries_per_client,
            ok=ok, failed=failed, rejected=rejected, lost=lost,
            availability=ok / max(resolved + lost, 1),
            zero_lost=(lost == 0
                       and resolved == clients * queries_per_client),
            injected=injected, **tot)
    finally:
        server.close()

    # ---------------------------------------------------------- 2. degrade
    g = G.rmat(scale, edgefactor=edgefactor, seed=seed)
    roots = _root_candidates(g)[:batch]
    srv = BFSServer({"chaos": g}, retry=RetryPolicy(max_retries=0),
                    breaker_threshold=100, device=device)
    try:
        kcfg = BFSConfig(backend_kernels=True)
        # Fault-free oracles FIRST — the degraded runs must match these.
        oracle_k = srv.submit("chaos", roots, kcfg,
                              client="oracle").result(timeout=timeout)
        oracle_p = srv.submit("chaos", roots,
                              client="oracle").result(timeout=timeout)
        gather_stage = srv.engine("chaos").session.device.type != "cuda"
        tiles_error = None
        with fault_scope("dispatch[kernels=tiles]@*", seed=seed):
            try:
                r_gather = srv.submit("chaos", roots, kcfg, client="degrade"
                                      ).result(timeout=timeout)
            except FaultInjected as e:
                r_gather, tiles_error = None, type(e).__name__
        with fault_scope("dispatch[mode=batch]@*", seed=seed):
            r_scalar = srv.submit("chaos", roots,
                                  client="degrade").result(timeout=timeout)
        if r_gather is not None:
            r_gather.validate(g)
        r_scalar.validate(g)
        c = srv.stats()["sessions"]["chaos"]
        out["degrade"] = dict(
            gather_stage=gather_stage, tiles_error=tiles_error,
            degraded_backend=c["degraded_backend"],
            degraded_scalar=c["degraded_scalar"],
            backend_bitwise=(r_gather is not None and bool(
                (r_gather.level == oracle_k.level).all()
                and (r_gather.parent == oracle_k.parent).all())),
            scalar_bitwise=bool(
                (r_scalar.level == oracle_p.level).all()
                and (r_scalar.parent == oracle_p.parent).all()),
            parents_valid=True)  # validate() above raises otherwise
    finally:
        srv.close()

    # ---------------------------------------------------------- 3. breaker
    srv = BFSServer({"chaos": g}, retry=RetryPolicy(max_retries=0),
                    breaker_threshold=2, breaker_reset_s=0.25,
                    device=device)
    try:
        gcfg = BFSConfig(backend_kernels=False)
        srv.submit("chaos", roots, gcfg,
                   client="warm").result(timeout=timeout)
        with fault_scope("dispatch@*:limit=2", seed=seed):
            tripping_error = None
            try:
                srv.submit("chaos", roots, gcfg,
                           client="victim").result(timeout=timeout)
            except Exception as e:  # noqa: BLE001 — expected FaultInjected
                tripping_error = type(e).__name__
            rejected_while_open = 0
            try:
                srv.submit("chaos", roots, gcfg, client="victim")
            except SessionUnavailable:
                rejected_while_open = 1
        state_open = srv.stats()["sessions"]["chaos"]["breaker"]["state"]
        time.sleep(0.3)                      # past the reset window
        srv.submit("chaos", roots, gcfg,
                   client="probe").result(timeout=timeout)  # half-open probe
        snap = srv.stats()["sessions"]["chaos"]["breaker"]
        out["breaker"] = dict(
            tripping_error=tripping_error,
            rejected_while_open=rejected_while_open,
            state_while_open=state_open, trips=snap["trips"],
            state_after_recovery=snap["state"],
            recovered=(tripping_error == "FaultInjected"
                       and rejected_while_open == 1
                       and state_open == "open"
                       and snap["state"] == "closed"))
    finally:
        srv.close()

    # ------------------------------------------------------------ 4. cache
    out["cache"] = run_cache_chaos(g, roots, seed=seed, device=device)

    out["ok"] = bool(
        out["load"]["zero_lost"]
        and out["load"]["availability"] >= 0.9
        and out["load"]["worker_crashes"] >= 1
        and out["load"]["worker_restarts"] >= 1
        and (out["degrade"]["degraded_backend"] >= 1
             and out["degrade"]["backend_bitwise"]
             if gather_stage else
             out["degrade"]["degraded_backend"] == 0
             and out["degrade"]["tiles_error"] == "FaultInjected")
        and out["degrade"]["degraded_scalar"] >= 1
        and out["degrade"]["scalar_bitwise"]
        and out["breaker"]["recovered"]
        and out["cache"]["ok"])
    return out


def run_cache_chaos(g, roots, *, seed: int = 0, device=None) -> dict:
    """The chaos probe's cache phase: persistence never breaks a query.

    In a fresh cache dir (plan sharing off, so the second session cannot
    take the first's plans), one session runs the fused query and records
    its plans; a second session's pre-warm then loads the records under
    `cache_load@0`: the first load fails, the record is evicted and
    counted (`corrupt_evictions`), the others pre-warm, and the query
    builds that plan again on its own path. Gate: an eviction, a rebuild,
    levels and parents bitwise equal to the first session's.
    """
    import tempfile
    from repro_torch.engine import Engine, GraphSession
    from repro_torch.runtime import RuntimeConfig, artifact_cache_for
    from repro_torch.runtime.faults import fault_scope
    with tempfile.TemporaryDirectory(prefix="repro-chaos-") as tmp:
        rt = RuntimeConfig(cache_dir=tmp, share_plans=False)
        s1 = GraphSession(g, device, runtime=rt, prewarm=False)
        base = Engine(s1).bfs(roots, backend="fused")
        s1.close()
        cache = artifact_cache_for(rt)
        before = cache.stats()["corrupt_evictions"]
        with fault_scope("cache_load@0", seed=seed):
            s2 = GraphSession(g, device, runtime=rt, prewarm=True)
            s2.prewarm_wait()
            again = Engine(s2).bfs(roots, backend="fused")
            rt_stats = s2.runtime_stats()
            s2.close()
        corrupt = cache.stats()["corrupt_evictions"] - before
    out = dict(
        corrupt_evictions=corrupt,
        rebuilds=rt_stats["builds"].get("cohort", 0),
        prewarm=rt_stats["prewarm"],
        bitwise=bool((again.level == base.level).all()
                     and (again.parent == base.parent).all()
                     and (again.num_levels == base.num_levels).all()))
    out["ok"] = bool(out["corrupt_evictions"] >= 1 and out["rebuilds"] >= 1
                     and out["bitwise"])
    return out


def build_server(n_graphs: int, scale: int, *, edgefactor: int = 16,
                 seed: int = 0, **server_kw):
    """(server, {name: graph}) over `n_graphs` RMAT sessions; `server_kw`
    go to `BFSServer` (`device=None`: the GPU)."""
    from repro_torch.core import graph as G
    graphs = {f"rmat{scale}-{i}": G.rmat(scale, edgefactor=edgefactor,
                                         seed=seed + i)
              for i in range(n_graphs)}
    return BFSServer(graphs, **server_kw), graphs


# The session's seconds a restart child reports (`runtime_stats()`): the
# kernel libraries made ready, the graph hashed, the CSR uploaded, the
# tiles built; on a warm start the pre-warm thread spends them.
RESTART_PARTS = ("kernel_build_s", "fingerprint_s", "csr_s", "tiles_s")

_RESTART_CHILD = """
import hashlib, json, os, sys, time
import numpy as np
spec, cache_dir, device, out_dir, phase, PARTS = json.loads(sys.argv[1])
t0 = time.perf_counter()
from repro_torch.engine import Engine, GraphSession
from repro_torch.kernels import _build, ops
from repro_torch.runtime import configure
if spec.get("path"):
    from repro_torch.interop import graph_from_arrays
    with np.load(spec["path"]) as z:
        g = graph_from_arrays(int(z["v"]), z["indptr"], z["indices"],
                              z["degrees"])
else:
    from repro_torch.core import graph as G
    g = G.rmat(spec["scale"], edgefactor=spec["edgefactor"],
               seed=spec["seed"])
configure(cache_dir=cache_dir)
setup_s = time.perf_counter() - t0
ops.reset_launches()
t0 = time.perf_counter()
s = GraphSession(g, device)
e = Engine(s)
root = int(g.degrees.argmax())
res = e.bfs([root], backend="fused")
first_query_s = time.perf_counter() - t0
launches = {k: v for k, v in ops.LAUNCHES.items() if v}
s.prewarm_wait(600)
rt = s.runtime_stats()
s.close()
np.savez(os.path.join(out_dir, phase + ".npz"), root=root,
         parent=res.parent, level=res.level)
digest = hashlib.sha256(np.ascontiguousarray(res.parent).tobytes()
                        + np.ascontiguousarray(res.level).tobytes())
print(json.dumps(dict(
    setup_s=setup_s, first_query_s=first_query_s, root=root,
    num_vertices=g.num_vertices,
    builds=rt["builds"].get("cohort", 0), loads=rt["loads"],
    parts={k: rt[k] for k in PARTS},
    prewarm=rt["prewarm"], cache=rt.get("artifact_cache"),
    kernels=_build.STATS, launches=launches,
    trees_sha256=digest.hexdigest())))
"""


def run_restart_probe(cache_dir: str, *, scale: int = 10,
                      edgefactor: int = 16, seed: int = 0,
                      graph_path: Optional[str] = None, device=None,
                      corrupt_library: bool = False,
                      timeout: float = 900.0) -> dict:
    """Cold-against-warm restart accounting across real process boundaries.

    Runs child processes in turn, each attaching a session over the same
    graph (`graph_path`, an .npz of its CSR: `v`, `indptr`, `indices`,
    `degrees`; else RMAT `scale`, `edgefactor`, `seed`) on `device`
    (None: the GPU) with the artifact cache at `cache_dir`, and timing
    attach plus its first fused query (one root, the highest-degree
    vertex). The first (cold, on a fresh
    directory) compiles the kernel libraries (on a GPU) and builds and
    records its plans; the second (warm) loads the libraries and
    pre-warms every plan: `warm_compiles == 0` and `warm_builds == 0`
    prove it, with its trees equal to the cold child's. `cold_parts` and
    `warm_parts` split each start's session seconds (`RESTART_PARTS`).
    The record names the graph by `num_vertices` and `scale` (with a
    file: log2 of its vertex count, None when that is not a power of two).

    `corrupt_library` (a GPU) then replaces the bottom-up library's entry
    with garbage and runs a third child (repair): the load fails, the
    entry is evicted and counted, `nvcc` builds that one source again
    (`repair_compiles == 1`), and the trees stay equal. Each child's trees
    are returned under `trees` (phase -> (root, parent, level)).
    """
    import json
    import os
    import subprocess
    import sys
    import tempfile
    src_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["REPRO_CACHE_DIR"] = cache_dir
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    spec = dict(path=graph_path, scale=scale, edgefactor=edgefactor,
                seed=seed)
    dev = None if device is None else str(device)
    phases, trees = {}, {}

    def child(phase, out_dir):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _RESTART_CHILD,
             json.dumps([spec, cache_dir, dev, out_dir, phase,
                         RESTART_PARTS])],
            capture_output=True, text=True, env=env, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"restart probe {phase} child failed "
                f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["process_s"] = time.perf_counter() - t0
        phases[phase] = out
        with np.load(os.path.join(out_dir, phase + ".npz")) as z:
            trees[phase] = (int(z["root"]), z["parent"], z["level"])

    with tempfile.TemporaryDirectory(prefix="repro-restart-") as out_dir:
        child("cold", out_dir)
        child("warm", out_dir)
        kernels_dir = os.path.join(cache_dir, "kernels")
        bottomup = sorted(n for n in os.listdir(kernels_dir)
                          if n.startswith("bottomup-")) \
            if os.path.isdir(kernels_dir) else []
        if corrupt_library:
            if not bottomup:
                raise RuntimeError("corrupt_library: the cold child cached "
                                   "no bottom-up library (a GPU run only)")
            # a new file replaces the entry (a loaded file is never
            # written in place)
            path = os.path.join(kernels_dir, bottomup[0])
            with open(path + ".garbage", "wb") as f:
                f.write(b"\x7fELF not a library")
            os.replace(path + ".garbage", path)
            child("repair", out_dir)
    cold, warm = phases["cold"], phases["warm"]
    cache = warm.get("cache") or {}
    prewarm = warm.get("prewarm") or {}
    v = cold["num_vertices"]
    if graph_path is not None:      # the file's size, not the RMAT knob
        scale = v.bit_length() - 1 if v > 0 and v & (v - 1) == 0 else None
    out = dict(
        scale=scale, num_vertices=v, graph_path=graph_path,
        cache_dir=cache_dir,
        device=dev, root=cold["root"],
        cold_start_s=cold["first_query_s"],
        warm_start_s=warm["first_query_s"],
        speedup=cold["first_query_s"] / max(warm["first_query_s"], 1e-9),
        cold_parts=cold["parts"], warm_parts=warm["parts"],
        cold_builds=cold["builds"], warm_builds=warm["builds"],
        warm_loads=warm["loads"],
        cold_compiles=cold["kernels"]["compiles"],
        cold_compile_s=cold["kernels"]["compile_s"],
        warm_compiles=warm["kernels"]["compiles"],
        warm_library_loads=warm["kernels"]["cache_loads"],
        warm_library_load_s=warm["kernels"]["cache_load_s"],
        hit_rate=cache.get("hit_rate", 0.0),
        prewarm=prewarm, prewarm_loaded=prewarm.get("loaded", 0),
        warm_launches=warm["launches"],
        same_trees=cold["trees_sha256"] == warm["trees_sha256"],
        children=phases, trees=trees)
    if "repair" in phases:
        rep = phases["repair"]
        out.update(
            repair_compiles=rep["kernels"]["compiles"],
            repair_corrupt_evictions=rep["cache"]["corrupt_evictions"],
            repair_same_trees=rep["trees_sha256"] == cold["trees_sha256"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graphs", type=int, default=2)
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--queries", type=int, default=6,
                    help="queries per client")
    ap.add_argument("--batch", type=int, default=4, help="roots per query")
    ap.add_argument("--stream-every", type=int, default=0,
                    help="every k-th query streams per-level stats (0=off)")
    ap.add_argument("--queue-depth", type=int, default=64)
    ap.add_argument("--inflight", type=int, default=16,
                    help="per-client in-flight cap")
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="dynamic batching window: wait up to this long to "
                         "coalesce compatible queries into one dispatch "
                         "(0 = opportunistic queue-drain batching only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--cancel-probe", action="store_true",
                    help="after the load, prove cancelled queries free "
                         "their worker within one level")
    ap.add_argument("--chaos-probe", action="store_true",
                    help="after the load, run the fault-injection probe: "
                         "worker crash, stragglers, dispatch/build "
                         "faults, the degradation chain, breaker "
                         "trip+recovery")
    ap.add_argument("--device", default=None,
                    help="torch device of the sessions (default: the GPU; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent artifact cache directory: kernel "
                         "libraries and plan records (default: "
                         "REPRO_CACHE_DIR if set, else disabled)")
    ap.add_argument("--restart-probe", action="store_true",
                    help="after the load, measure a cold and a warm "
                         "restart in two child processes sharing the cache "
                         "dir (needs --cache-dir or REPRO_CACHE_DIR)")
    args = ap.parse_args(argv)

    from repro_torch.runtime import configure, get_runtime_config
    if args.cache_dir is not None:
        configure(cache_dir=args.cache_dir)
    if args.restart_probe and get_runtime_config().cache_dir is None:
        ap.error("--restart-probe needs --cache-dir (or REPRO_CACHE_DIR)")
    server, graphs = build_server(
        args.graphs, args.scale, edgefactor=args.edgefactor, seed=args.seed,
        max_queue_depth=args.queue_depth,
        max_inflight_per_client=args.inflight,
        batch_window_ms=args.batch_window_ms, device=args.device)
    probe = None
    try:
        m = run_load(server, graphs, clients=args.clients,
                     queries_per_client=args.queries, batch=args.batch,
                     seed=args.seed, stream_every=args.stream_every,
                     validate=0 if args.no_validate else 1)
        if args.cancel_probe:
            probe = run_cancel_probe(server)
    finally:
        server.close()
    stats = server.stats()      # after close: the workers' counts are final
    chaos = None
    if args.chaos_probe:
        chaos = run_chaos_probe(scale=min(args.scale, 10),
                                edgefactor=min(args.edgefactor, 8),
                                seed=args.seed, device=args.device)
        stats["chaos_probe"] = chaos
    restart = None
    if args.restart_probe:
        restart = run_restart_probe(get_runtime_config().cache_dir,
                                    scale=min(args.scale, 10),
                                    edgefactor=args.edgefactor,
                                    seed=args.seed, device=args.device)
        stats["restart_probe"] = restart
    print(f"[serve] {args.graphs} session(s) scale={args.scale} | "
          f"{m['clients']} clients x {args.queries} queries "
          f"(batch {args.batch}): {m['qps']:.1f} QPS, "
          f"{m['teps_sustained'] / 1e6:.2f} MTEPS sustained, "
          f"p50 {m['latency_p50_ms']:.0f} ms / p95 {m['latency_p95_ms']:.0f} ms")
    t = stats["totals"]
    print(f"[serve] coalescing: {t['served']} queries in {t['batches']} "
          f"dispatches; rejected {t['rejected']}; "
          f"streamed levels {m['levels_streamed']}")
    for name, c in sorted(stats["sessions"].items()):
        print(f"[serve]   {name}: served={c['served']} "
              f"high_water={c['queue_high_water']}/{stats['max_queue_depth']}")
    if probe is not None:
        print(f"[serve] cancel probe: {probe['cancelled']} cancelled / "
              f"{probe['served']} served, wall ratio "
              f"{probe['wall_ratio']:.2f} vs baseline, "
              f"inflight_after={probe['inflight_after']}, "
              f"worker_alive={probe['worker_alive']}")
    if chaos is not None:
        ld = chaos["load"]
        print(f"[serve] chaos probe: {'OK' if chaos['ok'] else 'FAILED'} | "
              f"load {ld['ok']}/{ld['submitted']} ok, lost {ld['lost']}, "
              f"availability {ld['availability']:.2f}, "
              f"crashes {ld['worker_crashes']} restarts "
              f"{ld['worker_restarts']} retries {ld['retries']} | "
              f"degrade backend={chaos['degrade']['degraded_backend']} "
              f"scalar={chaos['degrade']['degraded_scalar']} | "
              f"breaker trips={chaos['breaker']['trips']} "
              f"recovered={chaos['breaker']['recovered']} | "
              f"cache corrupt_evictions="
              f"{chaos['cache']['corrupt_evictions']} rebuilds="
              f"{chaos['cache']['rebuilds']}")
    if restart is not None:
        print(f"[serve] restart probe: cold {restart['cold_start_s']:.2f}s "
              f"({restart['cold_builds']} plan builds, "
              f"{restart['cold_compiles']} nvcc) -> warm "
              f"{restart['warm_start_s']:.2f}s ({restart['warm_builds']} "
              f"plan builds, {restart['warm_loads']} pre-warmed, "
              f"{restart['warm_compiles']} nvcc, hit rate "
              f"{restart['hit_rate']:.2f}) = {restart['speedup']:.1f}x, "
              f"same trees {restart['same_trees']}")
    return m, stats


if __name__ == "__main__":
    main()

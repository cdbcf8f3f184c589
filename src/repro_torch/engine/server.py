"""`BFSServer`: concurrent traversal serving over named graph sessions.

The port of the JAX package's `engine/server.py`, with its API, queues,
micro-batching, streaming, cancellation, supervision, retries, circuit
breaker and degradation chain. Sessions run on the GPU unless a `device`
is named; each worker thread binds its session's device before its first
dispatch. Partitioned plans (`n_parts > 1`) are served on rank 0 of the
sessions' group through a `partition_front.PartitionFront` (`front=`),
which hands each dispatch, and every check point's outcome, to the ranks
that run `partition_front.follow`; without one a partitioned plan is
refused at submit. Two sessions on one card share it: a level's seconds
(timed up to a device-wide `torch.cuda.synchronize`) then include the
other session's queued work, so they are not solo numbers.

The paper's premise is that a BFS is a *query* against a preprocessed,
partitioned graph — Totem-style systems amortize partitioning/compilation
across many traversals, and Graph500-style evaluation measures sustained
per-root throughput. This module is that serving layer:

* a registry of named `GraphSession`s (one `Engine` each, caches shared and
  lock-protected), served **concurrently** by one worker thread per session;
* a bounded priority queue per session (`queueing.BoundedPriorityQueue`) —
  depth is a hard cap, so overload *rejects* with a typed
  `ServerOverloaded` instead of stalling submitters;
* **automatic micro-batching**: consecutive queued queries with equal
  `QueryPlan`s are coalesced into one fused cohort dispatch (the engine
  pads the merged batch to its pow2 bucket with inactive lanes, so
  coalesced sizes reuse the same cached step functions —
  `Engine._cohort_backend` via `Engine.bfs_plan` — and each direction
  runs at most once per level, not once per member), then split back per
  client with `TraversalResult.split`; `batch_window_ms` optionally holds
  an idle worker a bounded window to coalesce late-arriving compatible
  queries;
* **result streaming**: `submit(..., stream=True)` runs on the stepper
  backend and pushes each level's frontier stats to the handle the moment
  they land on the host — `handle.stream()` iterates levels while the
  search is still running, `handle.result()` returns the final tree;
* **admission control**: bounded queue depth + per-client in-flight caps
  (`queueing.ClientCaps`), both rejecting with `ServerOverloaded`;
* **self-healing under partial failure** (chaos-tested via
  `repro_torch.runtime.faults`): a crashed session worker is restarted by its
  supervisor with capped exponential backoff and the popped batch is
  recovered (requeued through the retry budget, never stranded); transient
  dispatch failures retry with bounded backoff at their original priority
  through the normal dispatch gate; non-transient failures walk a
  graceful-degradation chain — ELL-tile kernels -> the CSR gather
  formulation (CPU sessions only: on the GPU a failed kernel dispatch is
  never re-run in plain PyTorch), fused cohort batch -> per-query scalar
  searches — before the client ever sees an error; and a per-session circuit breaker trips after N consecutive
  dispatch failures, fast-failing submits with a typed
  `SessionUnavailable` until a half-open probe succeeds. Every event
  (worker_crashes/restarts, retries, degraded_backend/scalar,
  breaker state) is a counter in `stats()`.

Threads, not asyncio: PyTorch releases the GIL inside its ops and device
syncs, per-session workers give cross-graph parallelism, and the session
caches are already thread-safe. The host work of a search (its Python
loop, the result's copy and `np.where` in `finalize`) holds the GIL, so
two workers overlap only where one waits on the device. Synchronous
`submit` returns a `QueryHandle` future.

    server = BFSServer({"web": g1, "road": g2})          # on the GPU
    server = BFSServer({"web": g1}, device="cpu")        # plain versions
    h = server.submit("web", [3, 17, 42], client="alice")
    result = h.result(timeout=60)        # TraversalResult, oracle-validated
    server.close()
"""
from __future__ import annotations

import dataclasses
import queue as _pyqueue
import threading
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.analysis.concurrency import ensure_installed as _ensure_sanitizer
from repro_torch.analysis.concurrency import make_lock, make_timer
from repro_torch.core.bfs import kernels_enabled
from repro_torch.core.graph import Graph
from repro_torch.engine.engine import Engine, QueryPlan
from repro_torch.engine.level_loop import (QueryCancelled, QueryControl,
                                     QueryDeadlineExceeded)
from repro_torch.engine.partition_front import PartitionFront, PartitionLost
from repro_torch.engine.queueing import (BatchPopError, BoundedPriorityQueue,
                                   CircuitBreaker, ClientCaps, QueueClosed,
                                   QueueFull, RetryPolicy, ServerOverloaded,
                                   SessionUnavailable)
from repro_torch.engine.result import TraversalResult
from repro_torch.engine.session import GraphSession
from repro_torch.runtime.faults import fault_point

_STREAM_END = object()


class ServerClosed(RuntimeError):
    """Submit/worker interaction after `BFSServer.close()`."""


class QueryHandle:
    """Future for one submitted query (thread-safe).

    `result(timeout)` blocks for the final `TraversalResult` (re-raising the
    query's failure, `TimeoutError` on expiry). For streamed queries,
    `stream(timeout)` iterates per-level stats rows as the worker produces
    them — each row is the driver's dict (level, direction, frontier_size,
    frontier_edges, seconds, ...) plus the `root` it belongs to (stepper
    backend; one row per root per level) or `root=-1` with per-lane vectors
    (fused cohort backend; one row per level for the whole batch) — and
    ends when the search finishes; `result()` is available afterwards.

    `cancel()` aborts the query: still-queued queries are withdrawn
    immediately (freeing their queue-depth and admission slots); an
    in-flight stepper/streamed query aborts at its next level boundary.
    Either way `result()` raises `QueryCancelled`, and the per-level stats
    completed before the abort remain on `partial_stats` (deadline expiry
    behaves the same with `QueryDeadlineExceeded`). Cancelling a finished
    query is a no-op.
    """

    def __init__(self, qid: int, session: str, roots: np.ndarray,
                 plan: QueryPlan, client: Any, priority: int, stream: bool,
                 control: Optional[QueryControl] = None):
        self.qid = qid
        self.session = session
        self.roots = roots
        self.plan = plan
        self.client = client
        self.priority = priority
        self.is_stream = stream
        self.control = control if control is not None else QueryControl()
        self.submitted_at = time.perf_counter()
        self.latency_s: Optional[float] = None
        self.partial_stats: Optional[list] = None
        self._done = threading.Event()
        self._term_lock = make_lock("handle.term")
        self._result: Optional[TraversalResult] = None
        self._error: Optional[BaseException] = None
        self._cancel_cb: Optional[callable] = None
        self._events: Optional[_pyqueue.Queue] = (
            _pyqueue.Queue() if stream else None)

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> None:
        """Request cancellation (thread-safe, idempotent, best-effort)."""
        self.control.cancel()
        cb = self._cancel_cb
        if cb is not None:
            cb()

    def result(self, timeout: Optional[float] = None) -> TraversalResult:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.qid} on session {self.session!r} not done "
                f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def stream(self, timeout: Optional[float] = None):
        """Yield per-level stats rows until the search completes."""
        if self._events is None:
            raise ValueError("submit with stream=True to iterate levels")
        while True:
            try:
                ev = self._events.get(timeout=timeout)
            except _pyqueue.Empty:
                raise TimeoutError(
                    f"query {self.qid}: no level completed in {timeout}s")
            if ev is _STREAM_END:
                break
            yield ev
        if self._error is not None:
            raise self._error

    # ------------------------------------------------- worker-side plumbing --

    def _push(self, row: dict) -> None:
        if self._events is not None:
            self._events.put(row)

    def _finish(self, res: TraversalResult) -> bool:
        # Terminal-once: with retries, worker restarts, and close() all able
        # to settle a handle, the first terminal event wins and later ones
        # are no-ops (False) — the caller skips its bookkeeping then.
        with self._term_lock:
            if self._done.is_set():
                return False
            self._result = res
            self.latency_s = time.perf_counter() - self.submitted_at
            if self._events is not None:
                self._events.put(_STREAM_END)
            self._done.set()
            return True

    def _fail(self, exc: BaseException) -> bool:
        with self._term_lock:
            if self._done.is_set():
                return False
            self._error = exc
            self.latency_s = time.perf_counter() - self.submitted_at
            if self._events is not None:
                self._events.put(_STREAM_END)
            self._done.set()
            return True


class _QueryItem:
    """Internal queue entry: the handle plus everything the worker needs."""

    __slots__ = ("handle", "roots", "plan", "stream", "client", "batch_key",
                 "control", "attempts")

    def __init__(self, handle: QueryHandle, roots: np.ndarray,
                 plan: QueryPlan, stream: bool, client: Any,
                 control: QueryControl):
        self.handle = handle
        self.roots = roots
        self.plan = plan
        self.stream = stream
        self.client = client
        self.control = control
        self.attempts = 0           # retry dispatches consumed (RetryPolicy)
        # Streamed queries never coalesce (each runs its own stepper loop
        # with its own callback), so their key is unique by identity.
        self.batch_key = ("stream", id(handle)) if stream else ("batch", plan)


class _WorkerCrash(Exception):
    """A session worker died with a popped batch in hand (supervisor-internal).

    Carries the batch so the supervisor can recover it (requeue through the
    retry budget or fail the handles — never strand them) and `served`, the
    number of batches this worker incarnation completed before dying (a
    productive worker resets the restart backoff).
    """

    def __init__(self, batch: list, cause: BaseException, served: int):
        self.batch = batch
        self.cause = cause
        self.served = served
        super().__init__(f"worker crashed after {served} batch(es): {cause!r}")


def _degrade_stages(plan, stream: bool, device: torch.device) -> list:
    """The degradation chain's stages for a failed query, in order, as
    (counter, plan, batched):

    1. kernels off (`degraded_backend`) — the same plan with
       `backend_kernels=False`, so a failing kernel dispatch re-runs on the
       CSR gather steps. CPU sessions only: on a CUDA session the chain
       never swaps a kernel for plain PyTorch on the card, so a failed
       tiles dispatch goes straight to the scalar stage, which still runs
       the kernels, or fails with its own error;
    2. scalar (`degraded_scalar`) — a fused plan re-runs `batched=False`:
       one search per root (the B = 1 cohort), timed alone. Scalar mode
       cannot stream (no per-level host loop), so a streamed query has no
       such stage.
    """
    stages = []
    if kernels_enabled(plan.hcfg.bfs) and device.type != "cuda":
        plan = dataclasses.replace(
            plan, hcfg=dataclasses.replace(
                plan.hcfg, bfs=dataclasses.replace(
                    plan.hcfg.bfs, backend_kernels=False)))
        stages.append(("degraded_backend", plan, True))
    if plan.backend == "fused" and not stream:
        stages.append(("degraded_scalar", plan, False))
    return stages


class BFSServer:
    """Serve BFS queries concurrently over a registry of graph sessions.

    Args:
      graphs: optional name -> `Graph` | `GraphSession` mapping registered
        at construction (more via `register`).
      max_queue_depth: per-session bounded queue depth; submits beyond it
        get `ServerOverloaded(reason="queue_full")`.
      max_inflight_per_client: admission cap counted from submit to
        completion; beyond it `ServerOverloaded(reason="client_inflight")`.
      max_batch_queries / max_batch_roots: micro-batching bounds — at most
        this many compatible queries / total roots fuse into one dispatch.
      batch_window_ms: dynamic batching window — after popping a
        coalescible query from an otherwise-drained queue, the worker waits
        up to this long for more compatible queries to arrive before
        dispatching (0 = the old opportunistic queue-drain-only batching).
        Bounded latency traded for batch occupancy; full batches, streamed
        queries, and incompatible heads never wait.
      retry: `RetryPolicy` for transient dispatch failures (None = the
        default policy: 2 retries, 10 ms exponential backoff). Retried
        queries requeue at their original priority and re-enter through
        the normal dispatch gate (cancel/deadline still honoured).
      breaker_threshold / breaker_reset_s: per-session circuit breaker —
        this many CONSECUTIVE dispatch failures trip it; submits then
        fast-fail with `SessionUnavailable` for `breaker_reset_s` seconds,
        after which one probe query is admitted half-open.
      max_worker_restarts: how many times a session worker may be
        restarted after consecutive unproductive crashes before the
        supervisor gives up and fails that session's queue (a served batch
        resets the count). Restart backoff is exponential from
        `restart_backoff_s`, capped at `restart_backoff_max_s`.
      autostart: spawn worker threads immediately (False lets tests fill
        queues deterministically before serving begins; call `start()`).
      device: where sessions made from a `Graph` live; None is the GPU,
        and raises without one (`repro_torch.device.resolve_device`). A
        `GraphSession` keeps its own device.
      front: the `PartitionFront` of the sessions' process group (made on
        its rank 0 while the other ranks run `partition_front.follow`):
        partitioned plans dispatch through it, one at a time, and
        `close()` closes it. None refuses partitioned plans at submit.
    """

    def __init__(self, graphs: Optional[Dict[str, Union[Graph, GraphSession]]]
                 = None, *, max_queue_depth: int = 64,
                 max_inflight_per_client: int = 16,
                 max_batch_queries: int = 16, max_batch_roots: int = 64,
                 batch_window_ms: float = 0.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker_threshold: int = 5, breaker_reset_s: float = 1.0,
                 max_worker_restarts: int = 5,
                 restart_backoff_s: float = 0.05,
                 restart_backoff_max_s: float = 2.0,
                 autostart: bool = True, device=None,
                 front: Optional[PartitionFront] = None):
        if batch_window_ms < 0:
            raise ValueError(
                f"batch_window_ms must be >= 0, got {batch_window_ms}")
        if max_worker_restarts < 0:
            raise ValueError(
                f"max_worker_restarts must be >= 0, got {max_worker_restarts}")
        self.max_queue_depth = max_queue_depth
        self.max_batch_queries = max_batch_queries
        self.max_batch_roots = max_batch_roots
        self.batch_window_ms = batch_window_ms
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker_threshold = breaker_threshold
        self.breaker_reset_s = breaker_reset_s
        self.max_worker_restarts = max_worker_restarts
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.device = device
        self.front = front
        _ensure_sanitizer()   # REPRO_SANITIZE=1 instruments the locks below
        self._caps = ClientCaps(max_inflight_per_client)
        self._engines: Dict[str, Engine] = {}
        self._queues: Dict[str, BoundedPriorityQueue] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._counters: Dict[str, dict] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._state_lock = make_lock("server.state")
        self._stats_lock = make_lock("server.stats")
        self._timers_lock = make_lock("server.timers")
        self._retry_timers: Dict[threading.Timer, tuple] = {}
        self._closing = threading.Event()
        self._qid = 0
        self._started = False
        self._closed = False
        for name, g in (graphs or {}).items():
            self.register(name, g)
        if autostart:
            self.start()

    # ------------------------------------------------------------ registry --

    def register(self, name: str,
                 graph_or_session: Union[Graph, GraphSession]) -> Engine:
        """Add a named graph session; returns its `Engine` (shared caches).
        A `Graph` gets a new session on the server's `device`."""
        with self._state_lock:
            if self._closed:
                raise ServerClosed("cannot register on a closed server")
            if name in self._engines:
                raise ValueError(f"session {name!r} already registered")
            if isinstance(graph_or_session, GraphSession):
                engine = Engine(graph_or_session)
            else:
                engine = Engine(graph_or_session, device=self.device)
            self._engines[name] = engine
            self._queues[name] = BoundedPriorityQueue(self.max_queue_depth)
            # _counters is read under _stats_lock (stats/_count), so the
            # insert must hold it too — register() is legal on a live server.
            with self._stats_lock:
                self._counters[name] = dict(served=0, rejected=0, batches=0,
                                            roots=0, edges_traversed=0,
                                            cancelled=0, expired=0,
                                            busy_s=0.0,
                                            worker_crashes=0,
                                            worker_restarts=0, retries=0,
                                            dispatch_failures=0,
                                            degraded_backend=0,
                                            degraded_scalar=0, failed=0,
                                            breaker_rejected=0)
            self._breakers[name] = CircuitBreaker(self.breaker_threshold,
                                                  self.breaker_reset_s)
            if self._started:
                self._spawn_worker(name)
            return engine

    @property
    def sessions(self) -> Dict[str, GraphSession]:
        with self._state_lock:
            return {name: eng.session for name, eng in self._engines.items()}

    def engine(self, name: str) -> Engine:
        eng = self._engines.get(name)
        if eng is None:
            raise KeyError(f"unknown graph session {name!r}; registered: "
                           f"{sorted(self._engines)}")
        return eng

    # ----------------------------------------------------------- lifecycle --

    def _spawn_worker(self, name: str) -> None:
        t = threading.Thread(target=self._supervised_worker, args=(name,),
                             name=f"bfs-serve-{name}", daemon=True)
        # repro-ok: LS001 both callers (register, start) hold _state_lock across this call
        self._threads[name] = t
        t.start()

    def start(self) -> "BFSServer":
        """Start one worker thread per registered session (idempotent)."""
        with self._state_lock:
            if self._closed:
                raise ServerClosed("cannot start a closed server")
            self._started = True
            for name in self._engines:
                if name not in self._threads:
                    self._spawn_worker(name)
        return self

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop serving: fail queued-but-unstarted queries, join workers.

        In-flight dispatches finish; undelivered queue entries get their
        handles failed with `ServerClosed`. `timeout` bounds the WHOLE
        shutdown with one shared monotonic deadline — joining each of N
        workers with the full timeout would make worst-case shutdown
        N x timeout (the same stolen-wakeup pattern
        `BoundedPriorityQueue.get_batch` guards against).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            queues = list(self._queues.items())
            threads = list(self._threads.values())
            engines = list(self._engines.values())
        self._closing.set()          # wake supervisors out of restart backoff
        # Cancel pending retry timers and fail their queries: a retry
        # sleeping out its backoff holds no queue slot, so queue.close()
        # below would never find it.
        with self._timers_lock:
            timers = list(self._retry_timers.items())
            self._retry_timers.clear()
        for timer, (tname, it) in timers:
            timer.cancel()
            if it.handle._fail(
                    ServerClosed("server closed during retry backoff")):
                self._caps.release(it.client)
                self._count(tname, failed=1)
        for _name, q in queues:
            for item in q.close():
                if item.handle._fail(
                        ServerClosed("server closed before the query ran")):
                    self._caps.release(item.client)
        # Teardown ordering contract: SIGNAL every waiter before JOINING
        # anything, so no session's background work (its pre-warm thread)
        # eats the shared deadline. Queues were already closed above
        # (their waiters wake immediately).
        for eng in engines:
            eng.session.signal_close()
        for t in threads:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            t.join(remaining)
        # A cancelled Timer whose callback already started still runs to
        # completion; join on the shared deadline so close() does not
        # return while a requeue callback races the closed queues.
        for timer, _meta in timers:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            timer.join(remaining)
        # The followers leave their loop once no dispatch can start.
        if self.front is not None:
            self.front.close(None if deadline is None
                             else max(0.0, deadline - time.monotonic()))
        # Close the sessions on the SAME deadline: each joins its pre-warm
        # thread and drops its device tensors and published plans (the
        # workers that used them are joined).
        for eng in engines:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            eng.session.close(remaining)

    def __enter__(self) -> "BFSServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- submit --

    def submit(self, session: str, roots, cfg=None, *, backend: str = "auto",
               n_parts: Optional[int] = None, strategy: Optional[str] = None,
               hub_edge_fraction: Optional[float] = None,
               client: Any = "anonymous", priority: int = 0,
               stream: bool = False,
               deadline: Optional[float] = None) -> QueryHandle:
        """Enqueue a traversal query; never blocks on load.

        Invalid input (unknown session, bad roots/backend) raises
        synchronously; overload raises `ServerOverloaded` (typed; catch and
        back off). Returns a `QueryHandle` future.

        `priority`: lower runs first; FIFO within a priority class.
        `stream=True` resolves to the stepper backend and makes
        `handle.stream()` yield per-level stats as levels complete.
        `deadline`: seconds from now (converted to one absolute monotonic
        deadline in the query's `QueryControl`). An expired query is
        rejected at dispatch time — without dispatching, so it cannot
        poison the plan cache — and aborted between levels once running on
        the stepper backend; either way `result()` raises
        `QueryDeadlineExceeded`. `handle.cancel()` uses the same path with
        `QueryCancelled`.

        A partitioned plan (`n_parts > 1`) needs a group of `n_parts`
        ranks for the session and the server's `front` over it, else
        `ValueError`; once the group is lost it raises `PartitionLost`.
        """
        if self._closed:
            raise ServerClosed("server is closed")
        eng = self.engine(session)
        breaker = self._breakers[session]
        if not breaker.allow():
            self._count(session, breaker_rejected=1)
            raise SessionUnavailable(
                session, breaker.state,
                f"{breaker.snapshot()['consecutive_failures']} consecutive "
                "dispatch failures; retry after the reset window")
        if stream:
            if backend == "auto":
                backend = "stepper"
            elif backend not in ("stepper", "fused"):
                raise ValueError(
                    "stream=True runs on the stepper backend (per-root rows) "
                    f"or the fused cohort backend (batch rows), got "
                    f"{backend!r}")
        if deadline is not None and deadline < 0:
            raise ValueError(f"deadline must be >= 0 seconds, got {deadline}")
        plan = eng.plan(cfg, backend=backend, n_parts=n_parts,
                        strategy=strategy,
                        hub_edge_fraction=hub_edge_fraction)
        if plan.n_parts > 1:
            self._front_for(eng, plan.n_parts).check()
        roots_arr = eng._normalize_roots(roots)
        if roots_arr.size == 0:
            raise ValueError("cannot submit an empty root batch")
        with self._state_lock:
            self._qid += 1
            qid = self._qid
        control = QueryControl.with_timeout(deadline)
        handle = QueryHandle(qid, session, roots_arr, plan, client, priority,
                             stream, control)
        item = _QueryItem(handle, roots_arr, plan, stream, client, control)
        try:
            self._caps.acquire(client)
        except ServerOverloaded:
            # The admitted query never dispatches: free a claimed half-open
            # probe slot so the breaker's next probe is not starved.
            breaker.record_abort()
            self._count(session, rejected=1)
            raise
        try:
            self._queues[session].put(item, priority)
        except QueueFull as e:
            self._caps.release(client)
            breaker.record_abort()
            self._count(session, rejected=1)
            raise ServerOverloaded("queue_full", str(e)) from None
        except QueueClosed:
            self._caps.release(client)
            breaker.record_abort()
            raise ServerClosed("server is closed") from None
        handle._cancel_cb = lambda: self._withdraw_cancelled(session, item)
        return handle

    def _front_for(self, eng: Engine, n_parts: int) -> PartitionFront:
        """The front that serves `eng`'s `n_parts`-partition plans; raises
        `ValueError` when the session has no group of `n_parts` ranks
        (`GraphSession.group_for`) or the server no front over it."""
        group = eng.session.group_for(n_parts)
        if self.front is None or self.front.group is not group:
            raise ValueError(
                f"a {n_parts}-partition plan is served through a "
                "PartitionFront over the session's group: pass BFSServer("
                "front=PartitionFront(group)) on its rank 0 and run "
                "partition_front.follow(sessions, group) on the others")
        return self.front

    def _withdraw_cancelled(self, session: str, item: _QueryItem) -> None:
        """Pull a cancelled query out of its queue, if it is still there.

        Frees the queue-depth and admission slots immediately instead of
        waiting for a worker to pop the dead item. Losing the race (the
        worker already holds it) is fine: the control's cancel flag aborts
        it pre-dispatch or at the next level boundary, and the worker does
        the releasing — exactly one path ever fails the handle.
        """
        q = self._queues.get(session)
        if q is None:
            return
        for it in q.remove(lambda queued: queued is item):
            if it.handle._fail(QueryCancelled("query cancelled while queued")):
                self._caps.release(it.client)
                self._count(session, cancelled=1)

    # -------------------------------------------------------------- worker --

    def _supervised_worker(self, name: str) -> None:
        """Run `_worker_loop`, restarting it when it crashes (supervision).

        A crash hands back the popped batch (`_WorkerCrash`); those queries
        are recovered — requeued through the retry budget or failed typed —
        before the restart, so queued work survives. Backoff between
        restarts is exponential and capped; a worker that served at least
        one batch resets the unproductive-crash count. After
        `max_worker_restarts` consecutive unproductive crashes the
        supervisor fails the session's remaining queue and exits (the
        circuit breaker has long since tripped for new submits).
        """
        crashes = 0
        while True:
            try:
                self._worker_loop(name)
                return                       # clean exit: queue closed
            except _WorkerCrash as wc:
                self._count(name, worker_crashes=1)
                self._recover_batch(name, wc.batch, wc.cause)
                crashes = 1 if wc.served else crashes + 1
            except Exception:  # noqa: BLE001 — supervisor must survive
                self._count(name, worker_crashes=1)
                crashes += 1
            if crashes > self.max_worker_restarts:
                self._fail_pending(name, RuntimeError(
                    f"session {name!r} worker gave up after "
                    f"{self.max_worker_restarts} restarts"))
                return
            self._count(name, worker_restarts=1)
            delay = min(self.restart_backoff_s * 2 ** (crashes - 1),
                        self.restart_backoff_max_s)
            # close() sets _closing: wake immediately and exit instead of
            # sleeping out the backoff with the server shutting down.
            if self._closing.wait(delay):
                return

    def _worker_loop(self, name: str) -> None:
        q = self._queues[name]
        eng = self._engines[name]
        if eng.device.type == "cuda":
            # The current CUDA device is per thread: bind this worker's.
            torch.cuda.set_device(eng.device)
        served = 0
        while True:
            try:
                # Blocks while idle; close() wakes every waiter into the
                # QueueClosed exit path, so no poll timeout is needed.
                batch = q.get_batch(key=lambda it: it.batch_key,
                                    max_items=self.max_batch_queries,
                                    weight=lambda it: len(it.roots),
                                    max_weight=self.max_batch_roots,
                                    window_s=self.batch_window_ms / 1e3,
                                    extendable=lambda it: not it.stream,
                                    stop_wait=lambda popped: any(
                                        it.control.poll() is not None
                                        for it in popped))
            except QueueClosed:
                return
            except BatchPopError as e:
                # Standalone stranding guard: a failure after items were
                # popped (a broken coalescing callback) used to kill the
                # thread silently WITH queries in hand. Count it, fail the
                # popped items typed, keep serving.
                self._count(name, worker_crashes=1)
                for it in e.items:
                    if it.handle._fail(e):
                        self._caps.release(it.client)
                        self._count(name, failed=1)
                continue
            try:
                # Chaos hook: the worker "crashes" between popping a batch
                # and dispatching it — the worst moment, queries in hand.
                fault_point("worker", session=name)
            except BaseException as e:
                raise _WorkerCrash(batch, e, served) from e
            self._execute(name, eng, batch)
            served += 1

    def _recover_batch(self, name: str, batch: list,
                       cause: BaseException) -> None:
        """Queries a crashed worker held survive the restart.

        Undone items re-enter the queue at their original priority through
        the retry budget (`force=True`: their depth slots were already
        consumed at submit); items out of budget fail typed with the crash
        cause.
        """
        for it in batch:
            if it.handle.done():
                continue
            if it.attempts < self.retry.max_retries:
                it.attempts += 1
                self._count(name, retries=1)
                try:
                    self._queues[name].put(it, it.handle.priority, force=True)
                    continue
                except QueueClosed:
                    pass
            if it.handle._fail(cause):
                self._caps.release(it.client)
                self._count(name, failed=1)

    def _fail_pending(self, name: str, err: BaseException) -> None:
        """Fail everything still queued on a session (supervisor gave up)."""
        q = self._queues.get(name)
        if q is None:
            return
        for it in q.remove(lambda _: True):
            if it.handle._fail(err):
                self._caps.release(it.client)
                self._count(name, failed=1)

    def _abort(self, name: str, item: _QueryItem, err: BaseException) -> None:
        """Fail one query with a typed abort, preserving partial stats."""
        item.handle.partial_stats = getattr(err, "per_level_stats", None)
        if item.handle._fail(err):
            self._caps.release(item.client)
            self._count(name, cancelled=int(isinstance(err, QueryCancelled)),
                        expired=int(isinstance(err, QueryDeadlineExceeded)))

    def _execute(self, name: str, eng: Engine, batch: list) -> None:
        # Dispatch gate: cancelled / deadline-expired queries are failed
        # here, before any device work — an expired query never touches the
        # engine, so it cannot build, warm, or otherwise poison the plan
        # cache. Per-level aborts (below) need the backend's cooperation and
        # exist on the stepper/streamed path.
        live = []
        for it in batch:
            err = it.control.poll()
            if err is not None:
                self._abort(name, it, err)
            else:
                live.append(it)
        if not live:
            return
        batch = live
        t0 = time.perf_counter()
        try:
            results = self._dispatch(name, eng, batch)
        except (QueryCancelled, QueryDeadlineExceeded) as e:
            for it in batch:
                self._abort(name, it, e)
            self._count(name, busy_s=time.perf_counter() - t0)
            return
        except PartitionLost as e:
            self._count(name, busy_s=time.perf_counter() - t0)
            self._partition_lost(name, batch, e)
            return
        except Exception as e:  # noqa: BLE001 — every failure is handled
            self._count(name, dispatch_failures=1,
                        busy_s=time.perf_counter() - t0)
            self._breakers[name].record_failure()
            for it in batch:
                self._handle_failure(name, eng, it, e)
            return
        self._breakers[name].record_success()
        edges = 0
        for it, res in zip(batch, results):
            # Release the admission slot *before* waking the client: a
            # client resubmitting the instant result() returns must not be
            # bounced off its own just-completed query.
            if not it.handle.done():
                self._caps.release(it.client)
                it.handle._finish(res)
                edges += int(res.edges_traversed.sum())
        self._count(name, served=len(batch), batches=1,
                    roots=sum(len(it.roots) for it in batch),
                    edges_traversed=edges,
                    busy_s=time.perf_counter() - t0)

    def _run(self, name: str, eng: Engine, roots, plan: QueryPlan, *,
             batched: bool = True, on_level=None, control=None):
        """`eng.bfs_plan`, on every rank of the group through the front
        for a partitioned plan."""
        if plan.n_parts > 1:
            return self._front_for(eng, plan.n_parts).run(
                eng, name, roots, plan, batched=batched, on_level=on_level,
                control=control)
        return eng.bfs_plan(roots, plan, batched=batched, on_level=on_level,
                            control=control)

    def _partition_lost(self, name: str, batch: list,
                        err: PartitionLost) -> None:
        """The group that runs partitioned plans is lost: fail `batch`
        (popped from `name`) and every queued partitioned query with
        `err`."""
        with self._state_lock:
            queues = list(self._queues.items())
        failed = [(name, it) for it in batch]
        for qname, q in queues:
            failed += [(qname, it) for it in
                       q.remove(lambda queued: queued.plan.n_parts > 1)]
        for qname, it in failed:
            if it.handle._fail(err):
                self._caps.release(it.client)
                self._count(qname, failed=1)

    def _dispatch(self, name: str, eng: Engine, batch: list) -> list:
        """One engine dispatch for a worker batch -> per-item results."""
        first = batch[0]
        if first.stream:
            # Stepper streams per-root rows (b = root index); the fused
            # cohort path streams batch-level rows (b == -1, per-lane
            # vectors inside the row) — `root=-1` marks the latter.
            h = first.handle
            res = self._run(
                name, eng, first.roots, first.plan, control=first.control,
                on_level=lambda b, row, _r=first.roots: h._push(
                    dict(row, root=int(_r[b]) if b >= 0 else -1)))
            return [res]
        # Micro-batch: one fused dispatch for every coalesced query
        # (the engine pads the merged batch to its pow2 bucket, so
        # ragged coalesced sizes share one step set), split back
        # per query by the caller. A solo query keeps its control (per-root
        # and per-level abort points); a coalesced dispatch is one
        # shared search, so its members are only cancellable
        # at the dispatch gate.
        merged = self._run(
            name, eng, np.concatenate([it.roots for it in batch]),
            first.plan,
            control=batch[0].control if len(batch) == 1 else None)
        return merged.split([len(it.roots) for it in batch])

    # ------------------------------------------------ failure policy chain --

    def _handle_failure(self, name: str, eng: Engine, it: _QueryItem,
                        exc: BaseException) -> None:
        """Route one failed query: retry (transient) -> degrade -> fail.

        Transient failures (`exc.transient` truthy — injected faults mark
        themselves; real backends can too) re-enter the queue after the
        policy's backoff, at the original priority, within the retry
        budget. Everything else — and exhausted budgets — walks the
        degradation chain.
        """
        if it.handle.done():
            return
        transient = bool(getattr(exc, "transient", False))
        if transient and it.attempts < self.retry.max_retries:
            it.attempts += 1
            self._count(name, retries=1)
            self._schedule_retry(name, it)
            return
        self._degrade_or_fail(name, eng, it, exc)

    def _schedule_retry(self, name: str, it: _QueryItem) -> None:
        """Requeue `it` after the policy backoff (timer; worker not blocked).

        `force=True`: the query's depth slot was consumed at submit and its
        admission slot is still held — bouncing an ADMITTED query off a
        momentarily full queue would lose it. Cancellation during backoff
        is handled at the dispatch gate when the retry pops.
        """
        delay = self.retry.backoff(it.attempts)
        holder: list = []

        def requeue():
            with self._timers_lock:
                self._retry_timers.pop(holder[0], None)
            if it.handle.done():
                return
            try:
                self._queues[name].put(it, it.handle.priority, force=True)
            except QueueClosed:
                if it.handle._fail(
                        ServerClosed("server closed during retry backoff")):
                    self._caps.release(it.client)
                    self._count(name, failed=1)

        timer = make_timer(delay, requeue, name="server.retry")
        timer.daemon = True
        holder.append(timer)
        with self._timers_lock:
            self._retry_timers[timer] = (name, it)
        timer.start()

    def _degrade_or_fail(self, name: str, eng: Engine, it: _QueryItem,
                         exc: BaseException) -> None:
        """Graceful degradation: tiles -> gather, fused batch -> scalar.

        Runs only after a failed dispatch, and every stage that serves is
        counted (`degraded_backend`, `degraded_scalar`): nothing else in
        the port gives way from a kernel to another route. The stages are
        `_degrade_stages`'s; each re-runs the query on a plainer path
        (results stay bitwise-identical — the degraded paths are the
        bitwise-parity backends the tests already prove equivalent).

        A stage that itself fails counts another `dispatch_failures` and
        falls through; when the chain is exhausted the client gets the
        ORIGINAL error. Success counts `degraded_backend`/`degraded_scalar`
        and closes the breaker's failure streak.
        """
        stages = _degrade_stages(it.plan, it.stream, eng.session.device)
        for counter, p, batched in stages:
            err = it.control.poll()
            if err is not None:
                self._abort(name, it, err)
                return
            h = it.handle
            cb = (lambda b, row, _r=it.roots: h._push(
                dict(row, root=int(_r[b]) if b >= 0 else -1))) \
                if it.stream else None
            t0 = time.perf_counter()
            try:
                res = self._run(name, eng, it.roots, p, batched=batched,
                                control=it.control, on_level=cb)
            except (QueryCancelled, QueryDeadlineExceeded) as e:
                self._abort(name, it, e)
                return
            except PartitionLost as e:
                self._partition_lost(name, [it], e)
                return
            except Exception:  # noqa: BLE001 — fall through the chain
                self._count(name, dispatch_failures=1)
                self._breakers[name].record_failure()
                continue
            self._breakers[name].record_success()
            if it.handle.done():
                return
            self._caps.release(it.client)
            edges = int(res.edges_traversed.sum())
            it.handle._finish(res)
            self._count(name, served=1, batches=1, roots=len(it.roots),
                        edges_traversed=edges,
                        busy_s=time.perf_counter() - t0,
                        **{counter: 1})
            return
        if it.handle._fail(exc):
            self._caps.release(it.client)
            self._count(name, failed=1)

    # --------------------------------------------------------------- stats --

    def _count(self, name: str, **deltas) -> None:
        with self._stats_lock:
            c = self._counters[name]
            for k, v in deltas.items():
                c[k] += v

    def stats(self) -> dict:
        """Live counters per session + totals (served/rejected/batches/...,
        queue depth and high-water mark — the depth-bound proof).

        Each session also reports its `runtime` block,
        `GraphSession.runtime_stats()`: builds by kind, warm-ups run, the
        kernel build's seconds, plan loads and shares, plan sources, the
        pre-warm's progress and, with a cache dir, the artifact cache's
        counters. With a front, `front` holds its counters
        (`PartitionFront.stats`).
        """
        with self._state_lock:
            queues = list(self._queues.items())
            engines = list(self._engines.items())
        with self._stats_lock:
            per = {name: dict(c) for name, c in self._counters.items()}
        for name, q in queues:
            per[name]["queue_depth"] = len(q)
            per[name]["queue_high_water"] = q.high_water
        totals = {}
        for c in per.values():
            for k, v in c.items():
                if k not in ("queue_depth", "queue_high_water"):
                    totals[k] = totals.get(k, 0) + v
        for name, engine in engines:
            if name in per:
                per[name]["runtime"] = engine.session.runtime_stats()
                per[name]["breaker"] = self._breakers[name].snapshot()
        out = dict(sessions=per, totals=totals,
                   max_queue_depth=self.max_queue_depth,
                   clients_capped_at=self._caps.max_inflight)
        if self.front is not None:
            out["front"] = self.front.stats()
        return out

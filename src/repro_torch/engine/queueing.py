"""Serving-side queueing primitives: bounded priority queues and admission
control for `repro_torch.engine.server.BFSServer`.

The port's copy of the JAX package's `engine/queueing.py` (which imports no
JAX); `tests/test_torch_queueing.py` holds the two to the same outputs.

Design constraints (the serving story the ROADMAP targets):

* **Bounded everywhere.** An overloaded server must *reject* — with a typed
  `ServerOverloaded` the client can catch and back off — never stall the
  submitting thread or grow an unbounded backlog. `BoundedPriorityQueue.put`
  therefore never blocks; depth is a hard cap checked under the lock.
* **Priority + FIFO.** Items pop lowest `priority` first and FIFO within a
  priority class (a monotonic sequence number breaks ties), so equal-priority
  clients are served in arrival order.
* **Micro-batch aware.** `get_batch` pops one item (blocking up to a
  timeout), then greedily pops *consecutive compatible* items — same
  coalescing key, within a weight budget — so the server can fuse several
  queued queries into one batched dispatch without ever reordering across
  incompatible work or priorities.

Everything here is plain threading (no asyncio): PyTorch releases the GIL
inside its ops and device syncs, and the engine's caches are already
lock-protected (`GraphSession`), so OS threads are the simplest correct
substrate.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from typing import Any, Callable, Optional

from repro_torch.analysis.concurrency import make_condition, make_lock


class QueueFull(Exception):
    """Bounded queue is at capacity (internal; servers map it to
    `ServerOverloaded`)."""


class QueueClosed(Exception):
    """Queue was closed; no further puts/gets are possible."""


class BatchPopError(Exception):
    """`get_batch` failed *after* popping items off the queue.

    The popped items ride on the exception (`items`, possibly empty) so the
    consumer can recover them — without this, any exception between the
    first pop and the return (a broken `key`/`weight`/`stop_wait` callback,
    most likely) silently strands already-dequeued queries: their depth
    slots are freed but no worker will ever serve them. `cause` is the
    original exception.
    """

    def __init__(self, items: list, cause: BaseException):
        self.items = list(items)
        self.cause = cause
        super().__init__(
            f"get_batch failed with {len(self.items)} item(s) popped: "
            f"{cause!r}")


class ServerOverloaded(RuntimeError):
    """Typed admission-control rejection.

    Raised by `BFSServer.submit` instead of blocking when either bound is
    hit. `reason` is machine-readable: ``"queue_full"`` (per-session queue
    depth) or ``"client_inflight"`` (per-client in-flight cap).
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        self.detail = detail
        super().__init__(f"server overloaded ({reason}): {detail}")


class BoundedPriorityQueue:
    """Thread-safe bounded priority queue with batch (coalescing) pops.

    `put` is non-blocking by contract (raises `QueueFull`); `get`/`get_batch`
    block up to a timeout. `high_water` records the deepest the queue ever
    got — the stress tests use it to prove the depth bound held under load.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._heap: list = []
        self._lock = make_lock("queue")
        self._not_empty = make_condition(self._lock, name="queue.not_empty")
        self._seq = itertools.count()
        self._closed = False
        self.high_water = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def put(self, item: Any, priority: int = 0, *,
            force: bool = False) -> None:
        """Enqueue without blocking; `QueueFull` when at capacity.

        `force=True` bypasses the depth cap (never the closed check): the
        retry path re-enqueues a query that was ALREADY admitted — its
        depth slot was consumed at submit time, so bouncing it off a
        momentarily full queue would turn an admitted query into a lost
        one.
        """
        with self._lock:
            if self._closed:
                raise QueueClosed("queue is closed")
            if not force and len(self._heap) >= self.maxsize:
                raise QueueFull(
                    f"queue depth {len(self._heap)} at maxsize {self.maxsize}")
            heapq.heappush(self._heap, (priority, next(self._seq), item))
            self.high_water = max(self.high_water, len(self._heap))
            self._not_empty.notify()

    def _pop_locked(self) -> Any:
        return heapq.heappop(self._heap)[2]

    def get(self, timeout: Optional[float] = None) -> Any:
        """Pop the highest-priority item; `TimeoutError` when none arrives."""
        batch = self.get_batch(timeout=timeout, max_items=1)
        return batch[0]

    def get_batch(self, timeout: Optional[float] = None, *,
                  key: Optional[Callable[[Any], Any]] = None,
                  max_items: int = 1,
                  weight: Optional[Callable[[Any], int]] = None,
                  max_weight: Optional[int] = None,
                  window_s: float = 0.0,
                  extendable: Optional[Callable[[Any], bool]] = None,
                  stop_wait: Optional[Callable[[list], bool]] = None) -> list:
        """Pop one item (blocking), then greedily coalesce compatible ones.

        After the first (blocking) pop, keeps popping while the queue head
        has the same `key` as the first item, fewer than `max_items` were
        taken, and the summed `weight` stays <= `max_weight`. Only
        *consecutive in priority order* items coalesce — batching never
        reorders work past an incompatible or higher-priority query.

        `window_s > 0` adds a dynamic batching window: when the queue drain
        left the batch below its bounds, the call keeps waiting up to
        `window_s` seconds for more compatible items to ARRIVE and folds
        them in, instead of dispatching the moment the queue runs dry —
        latency traded for batch occupancy. The window never delays a
        batch that is already full, or blocked by an incompatible head,
        or whose first item `extendable` (when given) rejects — e.g. a
        streamed query that can never coalesce should not idle out the
        window. Queue closure cuts the window short (the already-popped
        items are returned and still served), and so does `stop_wait`
        (polled on every wakeup, at most ~50 ms apart): the server passes
        a cancellation/deadline check over the popped batch, so an aborted
        query does not pin its worker for the rest of the window.

        Raises `TimeoutError` if no item arrives in `timeout` seconds and
        `QueueClosed` once the queue is closed *and* drained.
        """
        # Deadline, not per-wakeup timeout: another consumer can win the
        # race for a notified item, and the loser must not restart the full
        # wait (that could block far past `timeout` under a steady trickle
        # of stolen puts).
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._heap:
                if self._closed:
                    raise QueueClosed("queue is closed")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("queue.get timed out")
                self._not_empty.wait(remaining)
            first = self._pop_locked()
            batch = [first]
            if key is None:
                return batch
            # Anything that fails from here on (the key/weight/stop_wait
            # callbacks are caller code) has already dequeued `batch`;
            # re-raise as `BatchPopError` carrying the items so the consumer
            # can fail or requeue them instead of stranding them.
            try:
                kfirst = key(first)
                total_w = [weight(first) if weight else 1]

                def extend() -> bool:
                    """Fold in compatible head items; False once un-extendable."""
                    while self._heap:
                        if len(batch) >= max_items:
                            return False
                        head = self._heap[0][2]
                        if key(head) != kfirst:
                            return False
                        w = weight(head) if weight else 1
                        if max_weight is not None and total_w[0] + w > max_weight:
                            return False
                        batch.append(self._pop_locked())
                        total_w[0] += w
                    # Drained the queue: still extendable only while both the
                    # item and weight budgets have room (weights are >= 1, so a
                    # saturated weight budget can never admit another item —
                    # waiting a window out on it would be pure added latency).
                    return (len(batch) < max_items
                            and (max_weight is None or total_w[0] < max_weight))

                more = extend()
                if (window_s > 0 and more
                        and (extendable is None or extendable(first))):
                    wdeadline = time.monotonic() + window_s
                    while more and not self._closed:
                        remaining = wdeadline - time.monotonic()
                        if remaining <= 0:
                            break
                        if stop_wait is not None and stop_wait(batch):
                            break
                        # Bounded slices so stop_wait (cancel/deadline on the
                        # popped items) is noticed without anyone having to
                        # notify this condition.
                        self._not_empty.wait(min(remaining, 0.05))
                        more = extend()
                return batch
            except BaseException as e:  # noqa: BLE001 — items must not strand
                raise BatchPopError(batch, e) from e

    def remove(self, pred: Callable[[Any], bool]) -> list:
        """Remove (and return, in priority order) every item matching `pred`.

        The cancellation path: a cancelled query still sitting in the queue
        is withdrawn here, freeing its depth slot immediately instead of
        waiting for a worker to pop and discard it. Items already popped are
        simply not found — the caller falls back to in-flight cancellation.
        """
        with self._lock:
            hit, keep = [], []
            for entry in self._heap:
                (hit if pred(entry[2]) else keep).append(entry)
            if hit:
                self._heap = keep
                heapq.heapify(self._heap)
            return [entry[2] for entry in sorted(hit)]

    def close(self) -> list:
        """Close the queue; returns (and removes) any undelivered items.

        Contract: the `notify_all` happens under the lock, BEFORE close()
        returns — so by the time a caller moves on to joining consumer
        threads, every `get_batch` waiter has already been woken (it will
        observe `_closed` and raise `QueueClosed` at next schedule). A
        close that returned before signaling would make the subsequent
        join wait out the waiter's full `timeout` — the teardown-ordering
        bug `BFSServer.close()` guards against (signal everything first,
        then join on one shared deadline)."""
        with self._lock:
            self._closed = True
            leftovers = [entry[2] for entry in sorted(self._heap)]
            self._heap.clear()
            self._not_empty.notify_all()
            return leftovers


class SessionUnavailable(RuntimeError):
    """Fast-fail rejection: the session's circuit breaker is open.

    Raised by `BFSServer.submit` while a session is tripping (N consecutive
    dispatch failures); clients back off instead of feeding a failing
    session — the breaker admits a half-open probe after `reset_after_s`
    and closes again on its success.
    """

    def __init__(self, session: str, state: str, detail: str = ""):
        self.session = session
        self.state = state
        super().__init__(
            f"session {session!r} unavailable (circuit {state})"
            + (f": {detail}" if detail else ""))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for transient dispatch failures.

    `max_retries` is per query (attempts beyond the first dispatch);
    backoff is exponential from `backoff_initial_s`, capped at
    `backoff_max_s`. The defaults are sized for the in-process engine —
    tens of milliseconds, not the seconds an RPC service would use.
    """

    max_retries: int = 2
    backoff_initial_s: float = 0.01
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 0.25

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_initial_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.backoff_multiplier < 1.0:
            raise ValueError(
                f"backoff_multiplier must be >= 1, "
                f"got {self.backoff_multiplier}")

    def backoff(self, attempt: int) -> float:
        """Delay before retry number `attempt` (1-based)."""
        return min(
            self.backoff_initial_s
            * self.backoff_multiplier ** max(attempt - 1, 0),
            self.backoff_max_s)


class CircuitBreaker:
    """Per-session circuit breaker: closed -> open -> half_open -> closed.

    `record_failure` counts CONSECUTIVE dispatch failures; at `threshold`
    the breaker opens and `allow()` rejects until `reset_after_s` has
    passed, after which exactly one caller is admitted as the half-open
    probe (`_probing` makes concurrent submitters lose). The probe's
    success closes the breaker; its failure re-opens it for another full
    `reset_after_s`. `record_abort` releases the probe slot when the
    admitted query dies before dispatch (cancelled/withdrawn) — neither
    success nor failure, so the breaker stays half-open for the next probe.
    """

    def __init__(self, threshold: int = 5, reset_after_s: float = 1.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.reset_after_s = reset_after_s
        self._lock = make_lock("breaker")
        self._failures = 0          # consecutive
        self._opened_at: Optional[float] = None
        self._probing = False
        self.trips = 0              # times the breaker opened (cumulative)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._opened_at is None:
            return "closed"
        if time.monotonic() - self._opened_at >= self.reset_after_s:
            return "half_open"
        return "open"

    def allow(self) -> bool:
        """May a new query enter? Claims the half-open probe slot."""
        with self._lock:
            state = self._state_locked()
            if state == "closed":
                return True
            if state == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._probing or self._failures >= self.threshold:
                # A failed half-open probe re-opens immediately; so does
                # reaching the consecutive-failure threshold while closed.
                if self._opened_at is None or self._probing:
                    self.trips += 1
                self._opened_at = time.monotonic()
                self._probing = False

    def record_abort(self) -> None:
        """The admitted query died before dispatch: free the probe slot."""
        with self._lock:
            self._probing = False

    def snapshot(self) -> dict:
        with self._lock:
            return dict(state=self._state_locked(),
                        consecutive_failures=self._failures,
                        trips=self.trips)


class ClientCaps:
    """Per-client in-flight caps: the second half of admission control.

    `acquire` raises `ServerOverloaded(reason="client_inflight")` when one
    client alone would exceed its budget — a single hot client cannot starve
    the shared queue. Always pair with `release` (the server does so in the
    worker's `finally`).
    """

    def __init__(self, max_inflight: int):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.max_inflight = max_inflight
        self._counts: dict[Any, int] = {}
        self._lock = make_lock("client_caps")

    def acquire(self, client: Any) -> None:
        with self._lock:
            n = self._counts.get(client, 0)
            if n >= self.max_inflight:
                raise ServerOverloaded(
                    "client_inflight",
                    f"client {client!r} has {n} queries in flight "
                    f"(cap {self.max_inflight})")
            self._counts[client] = n + 1

    def release(self, client: Any) -> None:
        with self._lock:
            n = self._counts.get(client, 0) - 1
            if n <= 0:
                self._counts.pop(client, None)
            else:
                self._counts[client] = n

    def inflight(self, client: Any) -> int:
        with self._lock:
            return self._counts.get(client, 0)

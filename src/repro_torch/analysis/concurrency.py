"""Runtime concurrency sanitizer: instrumented locks for the serving stack.

The port's copy of the JAX package's `analysis/concurrency.py` (which
imports no JAX); the two are held equal by `tests/test_torch_faults.py`.
The serving layer has many independently-locked subsystems (`BFSServer`
state/stats/timers, per-queue condition locks, per-session caches, circuit
breakers, client caps, the fault injector). Their safety contract — a consistent cross-thread lock
acquisition order, bounded hold times, no leaked timers — was enforced only
by convention. This module turns it into a *measured* invariant, mirroring
the `repro_torch.runtime.faults` pattern exactly:

* `make_lock` / `make_rlock` / `make_condition` / `make_timer` are the
  factories the threaded modules call instead of `threading.Lock()` etc.
  With no sanitizer installed they return the **plain threading primitive**
  — one module-global load plus a None check, zero steady-state overhead.
* With a sanitizer installed (`RuntimeConfig.sanitize` / ``REPRO_SANITIZE=1``
  via `ensure_installed`, or `install()` / `sanitize_scope()` in tests) the
  factories return instrumented wrappers that record, per thread:

  - the **lock-acquisition-order graph**: an edge ``A -> B`` whenever a
    thread acquires a lock named B while holding a lock named A. Edges are
    keyed by lock *name* (the subsystem), not instance, so the graph stays
    small and a cycle means "these subsystems can deadlock under the right
    interleaving" — `report()["cycles"]` lists every elementary cycle.
  - **hold times**: wall time from (outermost) acquire to (final) release;
    holds above `hold_threshold_s` land in `report()["long_holds"]` with
    the lock name and the holder's call site. `Condition.wait` releases
    the wrapped lock through the wrapper, so blocking in a wait does NOT
    count as holding (the `BoundedPriorityQueue` batching window would
    otherwise drown the report in false positives).
  - **live timers**: `make_timer` registers the timer until it fires or is
    cancelled; `report()["timers_live"]` after a clean shutdown proves the
    teardown path cancelled/joined every retry timer.

Wrappers are *observers*: they never change blocking semantics, fairness,
or reentrancy.

The cycle check is conservative by design: it reports *potential* deadlocks
(inconsistent acquisition order observed across threads), not only
deadlocks that actually occurred. The static half of the same contract
is the linter's lock-scope rule (LS001, `repro_torch.analysis.rules`).
"""
from __future__ import annotations

import contextlib
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_HOLD_THRESHOLD_S = 0.2


class LockSanitizer:
    """Process-wide recorder for instrumented synchronization primitives.

    One internal `threading.Lock` guards the graph/stats; it is a plain
    primitive (never wrapped), so the sanitizer cannot observe itself.
    """

    def __init__(self, hold_threshold_s: float = DEFAULT_HOLD_THRESHOLD_S):
        if hold_threshold_s < 0:
            raise ValueError(
                f"hold_threshold_s must be >= 0, got {hold_threshold_s}")
        self.hold_threshold_s = hold_threshold_s
        self._meta = threading.Lock()
        self._tls = threading.local()
        # (holder name, acquired name) -> count of observed orderings
        self._edges: Dict[Tuple[str, str], int] = {}
        self._acquires: Dict[str, int] = {}
        self._long_holds: List[dict] = []
        self._max_hold: Dict[str, float] = {}
        self._timers: Dict[int, str] = {}        # id(timer) -> name

    # ------------------------------------------------- wrapper callbacks --

    def _stack(self) -> list:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    def _acquired(self, name: str) -> None:
        st = self._stack()
        now = time.perf_counter()
        with self._meta:
            self._acquires[name] = self._acquires.get(name, 0) + 1
            for held_name, _t0 in st:
                if held_name != name:
                    edge = (held_name, name)
                    self._edges[edge] = self._edges.get(edge, 0) + 1
        st.append((name, now))

    def _released(self, name: str) -> None:
        st = self._stack()
        # Release in LIFO discipline is the common case, but condition
        # waits and explicit acquire/release pairs may interleave: pop the
        # most recent entry for this name.
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == name:
                _n, t0 = st.pop(i)
                held = time.perf_counter() - t0
                with self._meta:
                    if held > self._max_hold.get(name, 0.0):
                        self._max_hold[name] = held
                    if held >= self.hold_threshold_s:
                        site = traceback.extract_stack(limit=6)[0]
                        self._long_holds.append(dict(
                            lock=name, held_s=held,
                            site=f"{site.filename}:{site.lineno}"))
                return

    def _timer_started(self, timer: Any, name: str) -> None:
        with self._meta:
            self._timers[id(timer)] = name

    def _timer_finished(self, timer: Any) -> None:
        with self._meta:
            self._timers.pop(id(timer), None)

    # ------------------------------------------------------------ report --

    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the name-level acquisition-order graph.

        A cycle [A, B] means some thread acquired B while holding A and
        some (other) thread acquired A while holding B — the classic ABBA
        deadlock precondition. An empty list is the serving stack's
        deadlock-freedom certificate for everything this run exercised.
        """
        with self._meta:
            adj: Dict[str, set] = {}
            for a, b in self._edges:
                adj.setdefault(a, set()).add(b)
        cycles: List[List[str]] = []
        seen_keys: set = set()

        def dfs(start: str, node: str, path: list, visited: set) -> None:
            for nxt in sorted(adj.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_keys:
                        seen_keys.add(key)
                        cycles.append(list(path))
                elif nxt not in visited:
                    visited.add(nxt)
                    dfs(start, nxt, path + [nxt], visited)
                    visited.discard(nxt)

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return cycles

    def report(self) -> dict:
        cycles = self.cycles()
        with self._meta:
            return dict(
                locks=sorted(self._acquires),
                acquires=dict(self._acquires),
                edges={f"{a}->{b}": n
                       for (a, b), n in sorted(self._edges.items())},
                cycles=cycles,
                long_holds=list(self._long_holds),
                max_hold_s=dict(self._max_hold),
                timers_live=sorted(self._timers.values()),
            )


# ----------------------------------------------------------------- wrappers --


class _SanLockBase:
    """Shared acquire/release accounting over a raw threading primitive.

    Also exposes the `_release_save` / `_acquire_restore` / `_is_owned`
    protocol `threading.Condition` looks for, routed through the wrapper,
    so a condition wait correctly *ends* the hold (and restarts it on
    wake) instead of reporting the whole wait as one giant hold.
    """

    def __init__(self, san: LockSanitizer, name: str, raw):
        self._san = san
        self.name = name
        self._raw = raw

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._raw.acquire(blocking, timeout)
        if got:
            self._san._acquired(self.name)
        return got

    def release(self) -> None:
        self._san._released(self.name)
        self._raw.release()

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} wrapping {self._raw!r}>"

    # ------------------------------- threading.Condition integration --

    def _release_save(self):
        self._san._released(self.name)
        if hasattr(self._raw, "_release_save"):     # RLock: full unwind
            return self._raw._release_save()
        self._raw.release()
        return None

    def _acquire_restore(self, state) -> None:
        if hasattr(self._raw, "_acquire_restore"):
            self._raw._acquire_restore(state)
        else:
            self._raw.acquire()
        self._san._acquired(self.name)

    def _is_owned(self) -> bool:
        if hasattr(self._raw, "_is_owned"):
            return self._raw._is_owned()
        if self._raw.acquire(False):
            self._raw.release()
            return False
        return True


class SanLock(_SanLockBase):
    """Instrumented `threading.Lock`."""


class SanRLock(_SanLockBase):
    """Instrumented `threading.RLock`; only the OUTERMOST acquire/release
    pair is recorded, so reentrant re-acquisition neither double-counts
    edges nor resets the hold clock."""

    def __init__(self, san: LockSanitizer, name: str):
        super().__init__(san, name, threading.RLock())
        self._depth = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._raw.acquire(blocking, timeout)
        if got:
            d = getattr(self._depth, "n", 0)
            self._depth.n = d + 1
            if d == 0:
                self._san._acquired(self.name)
        return got

    def release(self) -> None:
        d = getattr(self._depth, "n", 0)
        self._depth.n = d - 1
        if d == 1:
            self._san._released(self.name)
        self._raw.release()

    def _release_save(self):
        # Condition.wait on an RLock unwinds every recursion level.
        self._san._released(self.name)
        state = self._raw._release_save()
        depth = getattr(self._depth, "n", 0)
        self._depth.n = 0
        return (state, depth)

    def _acquire_restore(self, state) -> None:
        raw_state, depth = state
        self._raw._acquire_restore(raw_state)
        self._depth.n = depth
        self._san._acquired(self.name)

    def _is_owned(self) -> bool:
        return self._raw._is_owned()


class SanTimer(threading.Timer):
    """`threading.Timer` that stays on the sanitizer's live-timer ledger
    until it fires or is cancelled — the teardown-leak detector."""

    def __init__(self, san: LockSanitizer, name: str, interval, function,
                 args=None, kwargs=None):
        super().__init__(interval, function, args=args, kwargs=kwargs)
        self._san = san
        self._san_name = name
        san._timer_started(self, name)

    def run(self) -> None:
        try:
            super().run()
        finally:
            self._san._timer_finished(self)

    def cancel(self) -> None:
        super().cancel()
        self._san._timer_finished(self)


# --------------------------------------------------------- module singleton --

_install_lock = threading.Lock()
_active: Optional[LockSanitizer] = None


def active() -> Optional[LockSanitizer]:
    return _active


def install(hold_threshold_s: float = DEFAULT_HOLD_THRESHOLD_S
            ) -> LockSanitizer:
    """Install a sanitizer process-wide (replaces any); returns it."""
    global _active
    san = LockSanitizer(hold_threshold_s)
    with _install_lock:
        _active = san
    return san


def uninstall() -> None:
    global _active
    with _install_lock:
        _active = None


@contextlib.contextmanager
def sanitize_scope(hold_threshold_s: float = DEFAULT_HOLD_THRESHOLD_S):
    """Install a sanitizer for a `with` block; restores the previous one.

    Locks are instrumented at CREATION time, so objects whose locks should
    be observed must be constructed inside the scope.
    """
    global _active
    with _install_lock:
        prev = _active
    san = install(hold_threshold_s)
    try:
        yield san
    finally:
        with _install_lock:
            _active = prev


def ensure_installed(runtime=None) -> Optional[LockSanitizer]:
    """Install from `RuntimeConfig.sanitize` (``REPRO_SANITIZE=1``) if
    nothing is installed yet — called by `GraphSession` / `BFSServer`
    construction, mirroring `repro_torch.runtime.faults.ensure_installed`, so an
    env-scheduled sanitizer run needs no code changes. An explicitly
    installed sanitizer (or a `sanitize_scope`) is never replaced."""
    if _active is not None:
        return _active
    if runtime is None:
        from repro_torch.runtime.config import get_runtime_config
        runtime = get_runtime_config()
    if not getattr(runtime, "sanitize", False):
        return None
    return install()


# ---------------------------------------------------------------- factories --


def make_lock(name: str):
    """A mutex for subsystem `name`: plain `threading.Lock` when the
    sanitizer is off (zero overhead), instrumented otherwise."""
    san = _active
    if san is None:
        return threading.Lock()
    return SanLock(san, name, threading.Lock())


def make_rlock(name: str):
    san = _active
    if san is None:
        return threading.RLock()
    return SanRLock(san, name)


def make_condition(lock, name: str = ""):
    """A condition over `lock` (which should come from `make_lock` so waits
    release through the wrapper). The raw `threading.Condition` machinery
    is reused either way — wrappers expose the `_release_save` protocol."""
    return threading.Condition(lock)


def make_timer(interval: float, function, args=None, kwargs=None, *,
               name: str = "timer"):
    san = _active
    if san is None:
        return threading.Timer(interval, function, args=args, kwargs=kwargs)
    return SanTimer(san, name, interval, function, args=args, kwargs=kwargs)

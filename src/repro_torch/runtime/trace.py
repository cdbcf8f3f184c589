"""The port's span recorder: where a query's time goes, on the host clock.

A span is a named interval on `time.perf_counter()` with the span it ran
under (`parent`), the query it belongs to (`query`: the id of the
outermost span open on its thread when it opened), the thread that ran it
and a few attributes. Finished spans go to a bounded in-memory ring; the
oldest are dropped first and counted (`dropped`). Recording is on by
default and costs two clock reads and one append a span; `set_enabled`
turns it off for the process. While a `torch.profiler` records this
thread, each span also holds a `record_function` range of its name, so
the program's spans sit in the profiler's trace on the device trace's
clock.

The search path's spans, each a child of the one above it:

    engine.query        Engine.bfs_plan, the whole call (roots, bucket,
                        backend)
      engine.warm       GraphSession.warm when it runs a warm-up search
      session.build     a plan or object built (kind)
      driver.run        LevelDriver.run
        driver.init     the driver's `init_s`
        level.issue     a level's step, issued by the host (level)
        level.wait      the level's device fence (level)
        level.sync      level_loop.host_sync, the per-level scalar copy
        finalize        the backend's finalize, the driver's `agg_s`
          finalize.map  its mapping to Graph500 conventions, issued on
                        the device before the copy
      engine.assemble   result assembly after the last driver run
        engine.tree_depth, engine.edges_traversed
    server.dispatch     a worker batch's busy time, `busy_s` (queries,
                        roots, bucket)
    server.queue_wait   submit (or requeue) to the worker's take (qid)

Spans that split one interval meet exactly: the driver's `init_s`, each
row's `seconds` (`level.issue` + `level.wait`), `agg_s` (`finalize`) and
a search's seconds (`driver.run`) are computed from the spans' own clock
reads, and the server's `busy_s` and `queue_wait_s` from
`server.dispatch`'s and `server.queue_wait`'s.

    with trace.span("engine.query", roots=16) as q:
        ...
    trace.spans(since, until)      # the finished spans that start there
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional

import torch

CAPACITY = 1 << 16


class Span:
    """One span: open from `span()` until `close()` (or the end of its
    `with` block), on the thread that opened it; then finished, and kept
    in the ring as it is. `parent` and `query` are span ids (`parent`
    None: a root span, whose `query` is its own id); `thread` is the
    opening thread's `threading.get_ident()`. With recording off a span
    only holds its clock reads."""

    __slots__ = ("name", "start", "end", "attrs", "id", "parent", "query",
                 "thread", "_rec", "_range")

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def split(self, name: str, **attrs) -> float:
        """End this span at one clock read and go on from that same read as
        `name`, under the same parent, `attrs` added to its attributes.
        Returns the read."""
        t = time.perf_counter()
        rec = self._rec
        if rec is not None:
            done = Span()
            done.name, done.start, done.end, done.attrs = (self.name,
                                                           self.start, t,
                                                           self.attrs)
            done.id, done.parent, done.query, done.thread = (
                self.id, self.parent, self.query, self.thread)
            done._rec = None
            self._end_range()
            rec._append(done)
            self.id = next(rec._ids)
            self._range = _profile(name)
        self.name, self.start = name, t
        self.attrs = {**self.attrs, **attrs}
        return t

    def close(self, t: Optional[float] = None) -> float:
        """End the span now, or at `t` (a clock read the caller made);
        returns its end. Spans still open under it (left by an exception)
        end with it, unrecorded. Closing again changes nothing."""
        if self.end is not None:
            return self.end
        self.end = time.perf_counter() if t is None else t
        rec = self._rec
        if rec is not None:
            self._rec = None
            stack = rec._local.stack
            top = stack.pop()
            while top is not self:
                top._end_range()
                top._rec = None
                top = stack.pop()
            self._end_range()
            rec._append(self)
        return self.end

    def _end_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


def _profile(name: str):
    """A `record_function` range of `name`, open, while a profiler
    records this thread; else None."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class Recorder:
    """A bounded ring of finished spans and each thread's open ones."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.enabled = True
        self.dropped = 0
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._dropped_until = float("-inf")   # latest end of a dropped span
        self._ids = itertools.count(1)
        self._local = threading.local()

    def span(self, name: str, t: Optional[float] = None, **attrs) -> Span:
        """Open `name` now, or at `t` (a clock read the caller made), under
        this thread's innermost open span."""
        sp = Span()
        sp.name, sp.attrs, sp.end = name, attrs, None
        if not self.enabled:
            sp._rec = sp._range = None
        else:
            try:
                stack = self._local.stack
            except AttributeError:
                stack = self._local.stack = []
            sp.id = sid = next(self._ids)
            if stack:
                top = stack[-1]
                sp.parent, sp.query = top.id, top.query
            else:
                sp.parent, sp.query = None, sid
            sp.thread = threading.get_ident()
            sp._rec = self
            sp._range = _profile(name)
            stack.append(sp)
        sp.start = time.perf_counter() if t is None else t
        return sp

    def record(self, name: str, start: float, end: float, **attrs) -> None:
        """A finished span from two clock reads the caller made, under this
        thread's innermost open span (no profiler range: it is over)."""
        if not self.enabled:
            return
        sp = Span()
        sp.name, sp.start, sp.end, sp.attrs = name, start, end, attrs
        sp.id = next(self._ids)
        top = self.current()
        sp.parent, sp.query = ((top.id, top.query) if top is not None
                               else (None, sp.id))
        sp.thread = threading.get_ident()
        sp._rec = sp._range = None
        self._append(sp)

    def _append(self, sp: Span) -> None:
        ring = self._ring
        if len(ring) == self.capacity:
            # Under racing threads the count may miss one; never all.
            self.dropped += 1
            self._dropped_until = max(self._dropped_until, ring[0].end)
        ring.append(sp)

    def current(self) -> Optional[Span]:
        """This thread's innermost open span (None: none, or recording
        off when it opened)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def spans(self, since: Optional[float] = None,
              until: Optional[float] = None) -> list:
        """The finished spans that start in [since, until), in the order
        they finished."""
        lo = float("-inf") if since is None else since
        hi = float("inf") if until is None else until
        return [r for r in list(self._ring) if lo <= r.start < hi]

    def lost(self, since: float) -> bool:
        """Whether a span that started at or after `since` was dropped."""
        return self._dropped_until >= since


RECORDER = Recorder()


def set_enabled(on: bool) -> None:
    """Record spans (the default) or not, in this process."""
    RECORDER.enabled = bool(on)


def span(name: str, t: Optional[float] = None, **attrs) -> Span:
    """`RECORDER.span`: open a span; use it in a `with` block or `close()`
    it."""
    return RECORDER.span(name, t, **attrs)


def record(name: str, start: float, end: float, **attrs) -> None:
    RECORDER.record(name, start, end, **attrs)


def spans(since: Optional[float] = None,
          until: Optional[float] = None) -> list:
    return RECORDER.spans(since, until)


def lost(since: float) -> bool:
    return RECORDER.lost(since)

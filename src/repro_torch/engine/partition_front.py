"""Serving partitioned plans: the front on rank 0, `follow` on the others.

In the JAX package one process drives a device mesh, so its server runs a
partitioned plan like any other. In the port every partition is a process
(one rank of a `torch.distributed` group), and every rank must issue the
same collectives in the same order. So a `BFSServer` serves partitioned
plans on rank 0 of the group, the **front**, which holds the queues, the
admission caps, the breaker, the retry timers and the handles; every other
rank, a **follower**, runs `follow`, which runs each dispatch the front
sends through its own `Engine.bfs_plan`. Every rank computes the same
result; the front returns its own copy.

    def rank_main(rank, group, device):          # on every rank
        sessions = {"web": GraphSession(graph, device, group=group)}
        if rank == 0:
            with BFSServer(sessions, front=PartitionFront(group)) as server:
                server.submit("web", roots, backend="sharded",
                              n_parts=dist.get_world_size(group)).result()
        else:
            follow(sessions, group)               # returns at close

**The control channel.** Its own gloo group over the group's ranks
(`dist.new_group`), made by `PartitionFront` on rank 0 and by `follow` on
the others: every rank of the default group must make its groups in the
same order. Its small messages never interleave with a search's OR/min
exchanges on the data group. The front broadcasts each message pickled
(`broadcast_object_list`; only the front writes them):

    ("run", session, roots, plan, batched, stream)   one dispatch
    ("beat",)                                        the front is idle
    ("close",)                                       `follow` returns

and inside a run the outcome of each check point, one int64 broadcast
(`level_loop.AgreedControl`): go on, cancelled, deadline, or a fault
raised at the front. The front alone polls the query's control and runs
the fault sites of a partitioned query; a follower runs with no fault
schedule.

**Idle time: heartbeats from the front.** A follower waits for the next
message in a broadcast on the channel, which the channel's collective
`timeout` bounds. While no dispatch holds the group, a thread of the front
sends ("beat",) every `timeout / 4` seconds, so an idle server does not
kill its followers, and a follower whose front is gone raises within
`timeout`. Give `PartitionFront` and `follow` the same `timeout`.

**One dispatch at a time.** Two sessions (two worker threads) may share a
group, and collectives issued from two threads would reach the ranks in
different orders: `run` holds the group's lock for the whole dispatch.

**Failures.** An abort at a check point ends the query on every rank at
the same point (the front re-raises its own exception, a follower raises
`AgreedAbort` and goes back to its loop), so the group serves the next
query. Anything else a rank raises inside a run (a rank that dies, a
collective that times out, an error outside a check point) leaves the
ranks at different points of the query, and the group is lost: the front
raises `PartitionLost` (a `SessionUnavailable`) for that dispatch and
every later one, and a follower re-raises out of `follow`. The data
group's collective timeout bounds how long the surviving ranks wait. A
gloo group that has timed out is not reused: serving again needs a new
group.
"""
from __future__ import annotations

import datetime
import threading
from typing import Callable, Mapping, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.analysis.concurrency import make_lock
from repro_torch.engine.engine import Engine, QueryPlan, RootsLike
from repro_torch.engine.level_loop import (AgreedAbort, AgreedControl,
                                           QueryControl)
from repro_torch.engine.queueing import SessionUnavailable
from repro_torch.engine.session import GraphSession
from repro_torch.runtime.faults import fault_scope

DEFAULT_TIMEOUT = 600.0


class PartitionLost(SessionUnavailable):
    """The group of a partitioned session can serve no more: a rank died
    or raised outside a check point, or a collective timed out."""

    def __init__(self, detail: str):
        self.session = None
        self.state = "lost"
        self.detail = detail
        RuntimeError.__init__(self, f"the partition group is lost: {detail}")


def _channel(group, timeout: float):
    """The control channel of `group` (a new gloo group over its ranks)
    and the global rank of its rank 0."""
    members = dist.get_process_group_ranks(group)
    channel = dist.new_group(members, backend="gloo",
                             timeout=datetime.timedelta(seconds=timeout))
    return channel, members[0]


def _ignore(_b, _row) -> None:
    """A follower's `on_level`: the front pushes the rows."""


class PartitionFront:
    """Rank 0's end of a group that serves partitioned plans.

    Made on rank 0 while every other rank calls `follow(sessions, group,
    timeout=...)`: both make the control channel. `BFSServer(front=...)`
    sends its partitioned dispatches through `run`; `close` ends the
    followers' loops. `stats()` counts dispatches, agreements (check
    points), agreed aborts, the seconds spent in the agreements'
    broadcasts (the cost a mesh does not pay), heartbeats, and whether the
    group is lost.
    """

    def __init__(self, group, *, timeout: float = DEFAULT_TIMEOUT):
        rank = dist.get_rank(group)
        if rank != 0:
            raise ValueError(f"rank {rank} of the group runs follow(); the "
                             "front is rank 0")
        self.group = group
        self.n_parts = dist.get_world_size(group)
        self.timeout = timeout
        self.channel, self._src = _channel(group, timeout)
        self._lock = make_lock("front.dispatch")
        self._stats_lock = make_lock("front.stats")
        self._counters = dict(dispatches=0, agreements=0, agreed_aborts=0,
                              agreement_s=0.0, beats=0)
        self.lost: Optional[PartitionLost] = None
        self._closed = False
        self._stop = threading.Event()
        self._beater = threading.Thread(target=self._beat_loop,
                                        name="partition-front-beat",
                                        daemon=True)
        self._beater.start()

    # ------------------------------------------------------------ messages --

    def _send(self, msg: tuple) -> None:
        dist.broadcast_object_list([msg], src=self._src, group=self.channel)

    def _beat_loop(self) -> None:
        while not self._stop.wait(self.timeout / 4):
            if not self._lock.acquire(blocking=False):
                continue                 # a dispatch holds the group
            try:
                if self.lost is None and not self._closed:
                    self._send(("beat",))
                    self._count(beats=1)
            except Exception as e:  # noqa: BLE001 — a follower is gone
                # repro-ok: LS001 _lock held: acquired by hand above
                self.lost = PartitionLost(f"heartbeat failed: {e!r}")
            finally:
                self._lock.release()

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._counters[k] += v

    def _agreed(self, seconds: float, aborted: bool) -> None:
        self._count(agreements=1, agreed_aborts=int(aborted),
                    agreement_s=seconds)

    def check(self) -> None:
        """Raise `PartitionLost` if the group can serve no more."""
        if self.lost is not None:
            raise PartitionLost(self.lost.detail)

    # ------------------------------------------------------------ dispatch --

    def run(self, engine: Engine, session: str, roots: RootsLike,
            plan: QueryPlan, *, batched: bool = True,
            on_level: Optional[Callable] = None,
            control: Optional[QueryControl] = None):
        """One partitioned dispatch on every rank of the group: send it,
        then run `engine.bfs_plan` here under an `AgreedControl` over
        `control`. Returns the front's result. An abort at a check point
        re-raises here (the followers end the query at the same point);
        any other failure loses the group and raises `PartitionLost`."""
        roots = np.asarray(roots)
        with self._lock:
            if self._closed:
                raise PartitionLost("the front is closed")
            self.check()
            ctl = AgreedControl(control, self.channel, True, self._agreed)
            self._count(dispatches=1)
            try:
                self._send(("run", session, roots, plan, batched,
                            on_level is not None))
                return engine.bfs_plan(roots, plan, batched=batched,
                                       on_level=on_level, control=ctl)
            except BaseException as e:
                if e is ctl.abort:
                    raise
                self.lost = PartitionLost(f"{type(e).__name__}: {e}")
                if isinstance(e, Exception):
                    raise self.lost from e
                raise

    # ------------------------------------------------------------ teardown --

    def close(self, timeout: Optional[float] = None) -> bool:
        """Send ("close",) (unless the group is lost) and stop the
        heartbeat. Waits up to `timeout` for a dispatch in flight; False
        when it did not end in time (the followers then stop at their
        channel's timeout)."""
        self._stop.set()
        if not self._lock.acquire(timeout=-1 if timeout is None else timeout):
            return False
        try:
            if self.lost is None and not self._closed:
                try:
                    self._send(("close",))
                except Exception as e:  # noqa: BLE001 — a follower is gone
                    # repro-ok: LS001 _lock held: acquired by hand above
                    self.lost = PartitionLost(f"close failed: {e!r}")
            # repro-ok: LS001 _lock held: acquired by hand above
            self._closed = True
        finally:
            self._lock.release()
        self._beater.join(timeout)
        return not self._beater.is_alive()

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._counters)
        out.update(n_parts=self.n_parts, lost=self.lost is not None,
                   agreement_s_mean=(out["agreement_s"]
                                     / max(out["agreements"], 1)))
        return out


def follow(sessions: Mapping[str, GraphSession], group, *,
           timeout: float = DEFAULT_TIMEOUT) -> dict:
    """Run the front's dispatches on this rank (> 0) until it closes.

    `sessions` holds the front's session names over the same graphs. Each
    ("run", ...) goes through that session's `Engine.bfs_plan` under an
    `AgreedControl`, with no fault schedule installed (the front runs the
    fault sites of a partitioned query); after its result, or an agreed
    abort, the loop waits for the next message. At ("close",) it closes
    the sessions, as the server closes the front's (a rank skips a warm-up
    search its session has run, so the ranks' sessions must forget theirs
    together), and returns the counts of runs, agreed aborts and
    heartbeats. Anything else a run raises, or a channel that times out,
    propagates: the group is lost.
    """
    rank = dist.get_rank(group)
    if rank == 0:
        raise ValueError("rank 0 of the group is the front "
                         "(PartitionFront); follow() runs on the others")
    channel, src = _channel(group, timeout)
    engines = {name: Engine(s) for name, s in sessions.items()}
    counts = dict(runs=0, aborts=0, beats=0)
    with fault_scope(()):
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=src, group=channel)
            kind = box[0][0]
            if kind == "close":
                # As `BFSServer.close` closes the front's sessions: their
                # warm-ups are forgotten on every rank alike.
                for sess in sessions.values():
                    sess.close()
                return counts
            if kind == "beat":
                counts["beats"] += 1
                continue
            _, name, roots, plan, batched, stream = box[0]
            counts["runs"] += 1
            try:
                engines[name].bfs_plan(
                    roots, plan, batched=batched,
                    on_level=_ignore if stream else None,
                    control=AgreedControl(None, channel, False))
            except AgreedAbort:
                counts["aborts"] += 1

"""The load generators: one for each `"loop"` a traffic file names.

* `ClosedLoop` ("closed"): one client calls `Engine.bfs` again the moment
  the last call returned, for `--seconds`; each query takes the next
  `roots_per_query` search keys, `batched` as the file says. Given a
  process group (a cell on more than one chip, rank 0 of its ranks), it
  sends each query through the port's `PartitionFront` instead, one
  partition a rank, with the configuration's `partition` block.
* `OpenLoop` ("open"): queries arrive on a schedule made from the seed and
  go to `BFSServer.submit`; a waiter takes each `QueryHandle.result` in
  arrival order. The gaps are exponential at the file's `rate_qps`, the
  same set of gaps for every seed in another order, so every seed offers
  the same load; each query is timed from its due time.

Both keep a sample of answers drawn from the seed (a reservoir of
`check_queries` whole queries) for the reference to judge, and
record on the host clock what the end-to-end metrics read. A traffic
file's `"query"` holds `BFSConfig` fields the queries are sent with.
"""
from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from portbench import graph500


class Reservoir:
    """A uniform sample of `k` queries' answers from a stream, drawn from
    `rng`. A query's answers are (root, parent, level) of each of its
    roots; the arrays are the result's own, kept without a copy."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.seen = 0
        self.queries: list = []

    def offer(self, roots, res) -> None:
        answers = [(int(r), res.parent[b], res.level[b])
                   for b, r in enumerate(roots)]
        if self.seen < self.k:
            self.queries.append(answers)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.queries[j] = answers
        self.seen += 1

    @property
    def kept(self) -> list:
        return [a for q in self.queries for a in q]


def _graph(csr: graph500.Csr):
    """The port's `Graph` over the benchmark's arrays, validated."""
    from repro_torch.core.graph import Graph
    g = Graph(csr.num_vertices, csr.indptr, csr.indices, csr.degrees)
    g.validate()
    return g


def _query_cfg(cfg: dict, traffic: dict):
    from repro_torch.core.bfs import BFSConfig
    return BFSConfig(**{**cfg.get("engine", {}), **traffic.get("query", {})})


# A configuration's `partition` block: the knobs of `Engine.plan` and of
# `HybridConfig`, under their names.
PARTITION_KEYS = ("strategy", "hub_edge_fraction", "exchange", "coordinator")


def partition_block(cfg: dict) -> dict:
    """The configuration's `partition` block (empty without one); raises on
    a key that is not one of `PARTITION_KEYS`."""
    block = dict(cfg.get("partition", {}))
    unknown = sorted(set(block) - set(PARTITION_KEYS))
    if unknown:
        raise ValueError(f"partition block: unknown keys {unknown}; want "
                         f"some of {list(PARTITION_KEYS)}")
    return block


class ClosedLoop:
    """One client, back to back, through `Engine.bfs`, or through
    `PartitionFront.run` on rank 0 of `group`."""

    def __init__(self, cfg: dict, traffic: dict, csr, seed: int, device,
                 group=None):
        self.csr = csr
        self.device = torch.device(device)
        self.batched = bool(traffic["batched"])
        rpq = int(traffic["roots_per_query"])
        keys = graph500.sample_roots(csr.degrees, int(traffic["keys"]),
                                     [seed, 1])
        self.queries = [keys[i:i + rpq] for i in range(0, len(keys), rpq)]
        self.qcfg = _query_cfg(cfg, traffic)
        self.sample = Reservoir(int(traffic["check_queries"]),
                                np.random.default_rng([seed, 2]))
        self.slice_s = float(traffic.get("trace_slice_s", 2.0))
        self.drain_s = float(traffic.get("drain_s", 60.0))
        self.group = group
        self.partition = partition_block(cfg) if group is not None else {}
        self.control = None
        self.spans = None            # trace.Spans of a traced run
        self.searches: list = []
        self.next = 0
        self.engine = None
        self.front = None            # PartitionFront, with a group
        self.plan = None             # its QueryPlan

    def setup(self) -> None:
        """The port's engine (with a group: on the group, its front and the
        partitioned plan), and one query of this cell's shape: the
        session's tiles, hash and kernels, and the first launches, all
        before the window. A warm-up that fails or outlives `drain_s` is
        reported and the run goes on: the window's queries will show it."""
        from repro_torch.engine import Engine, QueryControl
        if self.group is None:
            self.engine = Engine(_graph(self.csr), device=self.device)
        else:
            import torch.distributed as dist

            from repro_torch.core.hybrid_bfs import HybridConfig
            from repro_torch.engine.partition_front import PartitionFront
            p = self.partition
            self.engine = Engine(_graph(self.csr), device=self.device,
                                 group=self.group)
            self.plan = self.engine.plan(
                HybridConfig(bfs=self.qcfg, **{k: p[k] for k in
                                               ("exchange", "coordinator")
                                               if k in p}),
                n_parts=dist.get_world_size(self.group),
                strategy=p.get("strategy"),
                hub_edge_fraction=p.get("hub_edge_fraction"))
            self.front = PartitionFront(self.group, timeout=self.drain_s)
        self.control = QueryControl.with_timeout(self.drain_s)
        try:
            self._search(self.queries[0])
        except Exception as e:  # noqa: BLE001 — the window judges the path
            print(f"warm-up query failed: {e!r}", file=sys.stderr)
        self.control = None

    def runtime_stats(self) -> dict:
        return self.engine.session.runtime_stats()

    @property
    def lost(self) -> bool:
        """The partition group can serve no more (`PartitionFront.lost`,
        set where it raised `PartitionLost`): the loop stops."""
        return self.front is not None and self.front.lost is not None

    def _search(self, roots):
        t0 = time.perf_counter()
        try:
            if self.front is not None:
                return self.front.run(self.engine, "g", np.asarray(roots),
                                      self.plan, batched=self.batched,
                                      control=self.control)
            if self.batched:
                return self.engine.bfs(np.asarray(roots), self.qcfg,
                                       batched=True, control=self.control)
            return self.engine.bfs(int(roots[0]), self.qcfg, batched=False,
                                   control=self.control)
        finally:
            if self.spans is not None:
                self.spans.add(t0, time.perf_counter(), "engine.bfs")

    def _one(self, keep: bool):
        roots = self.queries[self.next % len(self.queries)]
        self.next += 1
        t0 = time.perf_counter()
        try:
            res = self._search(roots)
        except Exception as e:  # noqa: BLE001 — a failed query is counted
            print(f"query failed: {e!r}", file=sys.stderr, flush=True)
            res = None
        t1 = time.perf_counter()
        if res is not None and keep:
            self.sample.offer(roots, res)
        return dict(roots=roots, t0=t0, t1=t1, ok=res is not None)

    def window(self, seconds: float) -> tuple:
        """Run until `seconds` have passed, or the partition group is lost
        (at least one query); (start, last completion). A query still
        running `drain_s` past the close is given up (it never came)."""
        from repro_torch.engine import QueryControl
        t0 = time.perf_counter()
        self.control = QueryControl(deadline=time.monotonic() + seconds
                                    + self.drain_s)
        while True:
            self.searches.append(self._one(keep=True))
            if self.lost or time.perf_counter() - t0 >= seconds:
                break
        self.control = None
        return t0, self.searches[-1]["t1"]

    def traced_slice(self) -> tuple:
        """The queries of one slice (at least one, `trace_slice_s` of
        them; none once the group is lost), in order; `replay` runs the
        same again."""
        start = self.next
        t0 = time.perf_counter()
        while not self.lost and (self.next == start or time.perf_counter()
                                 - t0 < self.slice_s):
            self._one(keep=False)
        return start, self.next

    def replay(self, start: int, stop: int) -> None:
        self.next = start
        while self.next < stop and not self.lost:
            self._one(keep=False)

    @property
    def attempted(self) -> int:
        return len(self.searches)

    @property
    def failed(self) -> int:
        return sum(1 for s in self.searches if not s["ok"])

    def close(self) -> None:
        """End the followers' loops (with a group), then the session."""
        if self.front is not None:
            self.front.close(timeout=self.drain_s)
        self.engine.session.close()
        self.engine = None


class OpenLoop:
    """Poisson arrivals to a `BFSServer`, timed from each due time."""

    def __init__(self, cfg: dict, traffic: dict, csr, seed: int, device):
        self.csr = csr
        self.cfg = cfg
        self.device = torch.device(device)
        self.rate = float(traffic["rate_qps"])
        self.rpq = int(traffic["roots_per_query"])
        self.clients = int(traffic["clients"])
        self.drain_s = float(traffic.get("drain_s", 60.0))
        self.slice_s = float(traffic.get("trace_slice_s", 4.0))
        self.keys = graph500.sample_roots(csr.degrees, int(traffic["keys"]),
                                          [seed, 1])
        self.qcfg = _query_cfg(cfg, traffic)
        self.sample = Reservoir(int(traffic["check_queries"]),
                                np.random.default_rng([seed, 2]))
        self.order = np.random.default_rng([seed, 3])
        self.queries: list = []
        self.dispatches: list = []
        self.server = None
        self._next_key = 0

    def schedule(self, seconds: float) -> np.ndarray:
        """Due offsets of the window's queries: `round(rate * seconds)`
        exponential gaps at the quantiles (i + 0.5) / n, in an order drawn
        from the seed; the first query is due at 0."""
        n = max(1, round(self.rate * seconds))
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u) / self.rate
        self.order.shuffle(gaps)
        return np.concatenate([[0.0], np.cumsum(gaps[:-1])])

    def setup(self, spans=None) -> None:
        """The port's server, its dispatches timed when `spans` (a traced
        run's `trace.Spans`) is given, and every batch bucket the cell's
        coalescing can reach warm."""
        from repro_torch.engine import BFSServer
        self.server = BFSServer({"g": _graph(self.csr)}, device=self.device,
                                **self.cfg.get("server", {}))
        if spans is not None:
            dispatch = self.server._dispatch

            def timed(name, eng, batch):
                t0 = time.perf_counter()
                out = dispatch(name, eng, batch)
                t1 = time.perf_counter()
                spans.add(t0, t1, "server.dispatch")
                self.dispatches.append(dict(
                    t0=t0, t1=t1, roots=sum(len(it.roots) for it in batch)))
                return out
            self.server._dispatch = timed
        # Every batch bucket that coalescing can reach, warm: 1 root, and
        # the engine's pow2 buckets from 8 up to the largest dispatch.
        top = min(self.server.max_batch_queries * self.rpq,
                  self.server.max_batch_roots)
        sizes = [self.rpq] + ([8] if top >= 2 else [])
        while top > sizes[-1] >= 8:
            sizes.append(2 * sizes[-1])
        for size in sizes:
            roots = [self._key() for _ in range(size)]
            try:
                self.server.submit("g", roots, self.qcfg, client="warm"
                                   ).result(timeout=self.drain_s)
            except Exception as e:  # noqa: BLE001 — the window judges it
                print(f"warm-up query failed: {e!r}", file=sys.stderr)
                break

    def runtime_stats(self) -> dict:
        return self.server.engine("g").session.runtime_stats()

    def totals(self) -> dict:
        return dict(self.server.stats()["totals"])

    def _key(self) -> int:
        k = int(self.keys[self._next_key % len(self.keys)])
        self._next_key += 1
        return k

    def run(self, offsets: np.ndarray, keep: bool) -> tuple:
        """Offer queries due at `t0 + offsets`, wait for each (until the
        last is due plus `drain_s`); returns (t0, close, records): each
        query's `due`, `late` (how far behind its due time it was sent),
        `done` or `error` (`refused` when submit refused it), `latency`."""
        from repro_torch.engine import ServerOverloaded, SessionUnavailable
        recs = [dict(roots=[self._key() for _ in range(self.rpq)],
                     client=f"c{i % self.clients}") for i in range(len(offsets))]
        handles: queue.Queue = queue.Queue()
        t0 = time.perf_counter() + 0.05
        close = t0 + float(offsets[-1])
        deadline = close + self.drain_s

        def wait():
            while True:
                got = handles.get()
                if got is None:
                    return
                rec, h = got
                try:
                    res = h.result(timeout=max(0.0, deadline
                                               - time.perf_counter()))
                except Exception as e:  # noqa: BLE001 — counted as failed
                    rec["error"] = repr(e)
                    continue
                rec["done"] = time.perf_counter()
                if keep:
                    self.sample.offer(rec["roots"], res)

        waiter = threading.Thread(target=wait, name="portbench-waiter")
        waiter.start()
        try:
            for rec, off in zip(recs, offsets):
                rec["due"] = t0 + float(off)
                pause = rec["due"] - time.perf_counter()
                if pause > 0:
                    time.sleep(pause)
                rec["late"] = time.perf_counter() - rec["due"]
                try:
                    h = self.server.submit("g", rec["roots"], self.qcfg,
                                           client=rec["client"])
                except (ServerOverloaded, SessionUnavailable) as e:
                    rec["error"] = repr(e)
                    rec["refused"] = True
                    continue
                handles.put((rec, h))
        finally:
            handles.put(None)
            waiter.join()
        for rec in recs:
            rec["latency"] = rec.get("done", deadline) - rec["due"]
        return t0, close, recs

    def window(self, seconds: float) -> tuple:
        t0, close, self.queries = self.run(self.schedule(seconds), keep=True)
        return t0, close

    def traced_slice(self) -> None:
        self.run(self.schedule(self.slice_s), keep=False)

    @property
    def attempted(self) -> int:
        return len(self.queries)

    @property
    def failed(self) -> int:
        return sum(1 for q in self.queries if "error" in q)

    def close(self) -> None:
        self.server.close(timeout=min(10.0, self.drain_s))
        self.server = None


LOOPS = {"closed": ClosedLoop, "open": OpenLoop}


def make(cfg: dict, traffic: dict, csr, seed: int, device, group=None):
    """The traffic's load generator; with `group` (rank 0 of a cell on more
    than one chip) the closed loop through the partition front (the
    harness refuses any other loop there before a rank starts)."""
    loop = traffic["loop"]
    if loop not in LOOPS:
        raise ValueError(f"unknown loop {loop!r}; want one of {sorted(LOOPS)}")
    if group is None:
        return LOOPS[loop](cfg, traffic, csr, seed, device)
    return ClosedLoop(cfg, traffic, csr, seed, device, group)

"""What a `--trace 1` run reads, from the benchmark's own files.

* `Spans`: wrappers installed around the port's layer boundaries for the
  traced run only (never in a `--trace 0` run): each `LevelDriver.run`
  with its timings (`init_s`, `agg_s`, the per-level seconds), and the
  host ranges of `core.bfs.finalize` and `level_loop.host_sync` (with the
  drivers' `engine.bfs` and `server.dispatch`), so an idle gap of the
  device can be named by what the host was doing, on whatever thread.
* `profile_slice`: one bounded slice under `torch.profiler`, read from the
  raw kineto events: the union of device-busy intervals, the slice's
  length, device time by op, the port's BFS kernels' device time, and the
  longest idle gaps by the innermost host range around them.
* `BoundCapture`: the `kernels.ops` BFS wrappers wrapped to add up each
  call's least bytes and operations (`bounds.bound`), computed from the
  call's inputs before it runs.
"""
from __future__ import annotations

import threading
import time

import torch

from portbench import bounds


class Spans:
    """Records, from any thread, each `LevelDriver.run` with its timings
    (`runs`) and host ranges (`ranges`: start, end and label on the host
    clock: "level_driver", "finalize", "host_sync", and the drivers'
    "engine.bfs" and "server.dispatch"); `uninstall()` puts the port
    back."""

    def __init__(self):
        from repro_torch.core import bfs as core_bfs
        from repro_torch.engine import level_loop
        self.runs: list = []
        self.ranges: list = []
        self._lock = threading.Lock()
        self._saved = [(level_loop.LevelDriver, "run",
                        level_loop.LevelDriver.run),
                       (core_bfs, "finalize", core_bfs.finalize),
                       (level_loop, "host_sync", level_loop.host_sync)]
        run, finalize, host_sync = (s[2] for s in self._saved)
        spans = self

        def traced_run(driver, root, on_level=None, control=None):
            t0 = time.perf_counter()
            out = run(driver, root, on_level, control)
            t1 = time.perf_counter()
            _parent, _level, rows, timings = out
            spans.add(t0, t1, "level_driver", agg_s=timings["agg_s"],
                      init_s=timings["init_s"],
                      levels_s=sum(r["seconds"] for r in rows),
                      levels=len(rows))
            return out

        def traced_finalize(st):
            t0 = time.perf_counter()
            out = finalize(st)
            spans.add(t0, time.perf_counter(), "finalize")
            return out

        def traced_host_sync(payload):
            t0 = time.perf_counter()
            out = host_sync(payload)
            spans.add(t0, time.perf_counter(), "host_sync")
            return out

        level_loop.LevelDriver.run = traced_run
        core_bfs.finalize = traced_finalize
        level_loop.host_sync = traced_host_sync

    def add(self, t0: float, t1: float, label: str, **run) -> None:
        """One host range; with `run` fields, a level driver run too."""
        with self._lock:
            self.ranges.append((t0, t1, label))
            if run:
                self.runs.append(dict(t0=t0, t1=t1, **run))

    def uninstall(self) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def between(self, t0: float, t1: float) -> list:
        with self._lock:
            return [r for r in self.runs if t0 <= r["t0"] < t1]


class BoundCapture:
    """Adds up `bounds.bound` of every BFS wrapper call while installed."""

    def __init__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self.seconds = 0.0
        self.calls = 0
        self._saved = {n: getattr(ops, n) for n in bounds.BFS_WRAPPERS}

        def wrap(name, fn):
            def call(*args, **kw):
                bargs, packed = bounds.call_args(name, args, kw)
                nbytes, nops = bounds.bound(name, bargs, packed=packed)
                self.seconds += bounds.seconds(nbytes, nops)
                self.calls += 1
                return fn(*args, **kw)
            return call

        for n, fn in self._saved.items():
            setattr(ops, n, wrap(n, fn))

    def uninstall(self) -> None:
        for n, fn in self._saved.items():
            setattr(self._ops, n, fn)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_slice(fn, device, spans=None, top: int = 10) -> dict:
    """Run `fn()` under the profiler; return its device reading:
    `busy_s` (union of device-op intervals), `window_s` (the slice's
    wall), `kernel_s` (the port's BFS kernels' summed durations),
    `device_ops` and `idle_gaps` (the `top` longest pieces of idle time,
    each [label, seconds], named by the innermost of `spans.ranges`
    around them, mapped onto the trace's clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("portbench.slice"):
            t0 = time.perf_counter()
            n0 = len(spans.ranges) if spans is not None else 0
            fn()
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
    dev, edge = [], None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == "portbench.slice":
                edge = (s, s + d)
        elif d > 0 and not e.is_user_annotation():
            dev.append((s, s + d, e.name()))
    by_op: dict = {}
    kernel_ns = 0
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0) + (e - s)
        if bounds.is_bfs_kernel(name):
            kernel_ns += e - s
    lo, hi = edge if edge else (0, 0)
    busy = _merge([(max(s, lo), min(e, hi)) for s, e, _ in dev
                   if e > lo and s < hi])
    busy_ns = sum(e - s for s, e in busy)
    gaps, cur = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    ranges = []
    if spans is not None and edge is not None:
        ns = edge[0] - t0 * 1e9          # host clock -> trace clock
        ranges = [(int(a * 1e9 + ns), int(b * 1e9 + ns), name)
                  for a, b, name in spans.ranges[n0:]]
    pieces = [p for a, b in gaps for p in _split(ranges, a, b)]
    pieces.sort(key=lambda p: -p[1])
    named = [[name, ns / 1e9] for name, ns in pieces[:top]]
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy_ns / 1e9, window_s=wall, kernel_s=kernel_ns / 1e9,
                device_ops=[[n[:160], ns / 1e9] for n, ns in ops],
                idle_gaps=named)


def _split(ranges, a: int, b: int) -> list:
    """An idle gap [a, b) cut where the innermost of `ranges` (start, end,
    label) changes: [(label, ns), ...], "host" where none holds it."""
    ranges = [r for r in ranges if r[0] < b and r[1] > a]
    cuts = sorted({a, b} | {t for s, e, _ in ranges for t in (s, e)
                            if a < t < b})
    out = []
    for x, y in zip(cuts, cuts[1:]):
        mid = (x + y) // 2
        inner = max(((s, name) for s, e, name in ranges if s <= mid < e),
                    default=(0, "host"))[1]
        if out and out[-1][0] == inner:
            out[-1][1] += y - x
        else:
            out.append([inner, y - x])
    return out

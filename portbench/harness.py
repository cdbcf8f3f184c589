"""One run of one cell: inputs, set-up, the measured window, the traced
slice, the comparison with the reference, and the result line.

`run()` takes the device as an argument so the tests drive it on the CPU
at a small size; `run.py` refuses to start without the CUDA devices the
cell asks for and never falls back to the CPU.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import drivers, graph500, reference
from portbench import trace as tracing
from portbench.manifest import Manifest

# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Readings:
    """What a run recorded, for the metric readers (`metrics/<name>.py`).

    Host clock: `setup_s`; `start`/`close` of the window; `searches`
    (closed loop: each query's `t0`, `t1`, `ok` and Graph500 `edges`);
    `queries` (open loop: each query's `due`, `latency`, `error`).
    Program spans and counters (traced run): `driver_runs` (each
    `LevelDriver.run` in the window: `agg_s`, `levels_s`), `dispatches`
    (each server dispatch in the window), `launches` (`ops.LAUNCHES`
    added in the window), `roots` (roots searched in the window),
    `server` (`BFSServer.stats()` totals added in the window), `runtime`
    (`GraphSession.runtime_stats()`). Device trace: `device` (the traced
    slice's `busy_s`, `window_s`, `kernel_s`) and `bound_s` (the least
    time of the slice's BFS kernel calls).
    """

    def __init__(self, loop: str):
        self.loop = loop
        self.setup_s = None
        self.start = self.close = None
        self.searches: list = []
        self.queries: list = []
        self.driver_runs: list = []
        self.dispatches: list = []
        self.launches: dict = {}
        self.roots = 0
        self.server: dict = {}
        self.runtime: dict = {}
        self.device = None
        self.bound_s = None


def forbidden_modules(names=None) -> list:
    """Of the module `names` (default: the loaded ones), the top-level
    names (before the first dot) that are in `FORBIDDEN`, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1, memory_peak_bytes=int(peak))


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> dict:
    """One run; returns the result line's object (`checks` last)."""
    from repro_torch.kernels import ops
    device = torch.device(device)
    cuda = device.type == "cuda"
    m = Manifest(root)
    cell = m.workload(workload)
    cfg = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    t0 = time.perf_counter()
    csr = graph500.make_graph(cfg["generator"], seed, device)
    t_graph = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    loop = drivers.make(cfg, traffic, csr, seed, device)
    r = Readings(traffic["loop"])
    spans = tracing.Spans() if trace else None
    try:
        if r.loop == "open":
            loop.setup(spans)
            totals0 = loop.totals()
        else:
            loop.spans = spans
            loop.setup()
        launches0 = dict(ops.LAUNCHES)
        r.setup_s = time.perf_counter() - t_start
        print(f"setup: {r.setup_s:.3f} s, graph made in {t_graph:.3f} s "
              f"(V {csr.num_vertices}, {csr.num_directed_edges} directed "
              "edges)", file=sys.stderr)
        r.start, r.close = loop.window(seconds)
        r.launches = {k: v - launches0[k] for k, v in ops.LAUNCHES.items()}
        if r.loop == "open":
            r.server = {k: v - totals0.get(k, 0)
                        for k, v in loop.totals().items()}
        if trace:
            got = {}
            r.device = tracing.profile_slice(
                lambda: got.setdefault("slice", loop.traced_slice()), device,
                spans)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if trace and r.loop == "closed":
            capture = tracing.BoundCapture()
            try:
                loop.replay(*got["slice"])
            finally:
                capture.uninstall()
            r.bound_s = capture.seconds
        r.runtime = loop.runtime_stats()
    finally:
        if spans is not None:
            spans.uninstall()
    if trace:
        r.driver_runs = spans.between(r.start, r.close)
        if r.loop == "closed":
            wall = sum(s["t1"] - s["t0"] for s in loop.searches)
            inside = sum(d["t1"] - d["t0"] for d in r.driver_runs)
            print(f"engine outside LevelDriver.run: "
                  f"{100 * (1 - inside / wall):.3f}% of the window's query "
                  f"wall ({wall:.3f} s)", file=sys.stderr)
        r.dispatches = [d for d in getattr(loop, "dispatches", [])
                        if r.start <= d["t0"] < r.close]
    loop.close()
    sample = loop.sample.kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # Graph500 edges of each query: its keys' components' edges.
    t0 = time.perf_counter()
    label, comp = graph500.component_edges(csr, device)
    largest = comp.max()
    queries = loop.searches if r.loop == "closed" else loop.queries
    outside = 0
    for q in queries:
        edges = comp[label[torch.as_tensor(np.asarray(q["roots"], np.int64),
                                           device=device)]]
        q["edges"] = int(edges.sum())
        outside += int((edges < largest).sum())
    del label, comp
    r.roots = sum(len(q["roots"]) for q in queries)
    if r.loop == "closed":
        r.searches = queries
        unanswered = loop.failed
    else:
        r.queries = queries
        unanswered = sum(1 for q in queries
                         if "done" not in q and not q.get("refused"))
    print(f"largest component: {int(largest)} edges; {outside} of "
          f"{r.roots} keys searched outside it", file=sys.stderr)
    judge = reference.Judge(*csr.on(device))
    numbers = reference.judge_answers(judge, sample, unanswered)
    del judge
    print(f"check: {len(sample)} answers judged, {time.perf_counter() - t0:.3f}"
          " s with the component edge counts", file=sys.stderr)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for x in m.metrics(section, workload):
        value = m.reader(x["name"])(r)
        if value is not None:
            metrics[x["name"]] = {"value": value, "unit": x["unit"]}
    out = dict(correct=reference.is_correct(numbers),
               attempted=loop.attempted, failed=loop.failed,
               metrics=metrics, device=_device_info(device, peak))
    if trace and r.device is not None:
        out["device"]["busy_s"] = r.device["busy_s"]
        out["device"]["window_s"] = r.device["window_s"]
        out["breakdown"] = dict(device_ops=r.device["device_ops"],
                                idle_gaps=r.device["idle_gaps"])
    if r.loop == "open":
        late = np.asarray([q["late"] for q in r.queries if "late" in q])
        print(f"generator lateness: median {np.median(late):.6f} s, "
              f"max {late.max():.6f} s over {late.size} sends",
              file=sys.stderr)
    out["checks"] = reference.check_lines(numbers)
    return out

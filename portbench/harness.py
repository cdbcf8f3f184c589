"""One run of one cell: inputs, set-up, the measured window, the traced
slice, the comparison with the reference, and the result line.

`run()` takes the device as an argument so the tests drive it on the CPU
at a small size; `run.py` refuses to start without the CUDA devices the
cell asks for and never falls back to the CPU.

A cell whose `chips` is more than 1 runs one rank a chip, started by the
port's own launcher (`repro_torch.parallel.ranks.run_ranks`; NCCL on
CUDA, gloo on the CPU, or the backend asked for). Rank 0 runs the same
sequence as a one-chip run (`_sequence`), its closed loop sending each
query through the port's `PartitionFront`; every other rank makes the
graph from the seed on its own device, checks that it agrees with rank
0's, and serves the front (`partition_front.follow`) until rank 0 closes
it. The readings, the traced slice and the comparison are rank 0's; the
result's `device` holds every rank's memory peak.

A rank that fails ends the run without a hang. A follower that raises
leaves its ranks at once (gloo sees the closed connection), and rank 0
counts the query as failed (`PartitionLost`), stops its loop and still
returns its result, with `failed` above 0 where it was in the window; a
follower that failed anywhere reads in the check `ranks_failed` (limit
0), so the result is not `correct`. A rank stalled inside a
collective is given up at the data group's timeout, the traffic's
`drain_s`; the front's channel has the same. A rank whose process dies
makes `run_ranks` stop every rank within seconds, and one that stalls
outside a collective is stopped at `run_ranks`'s timeout,
`RANKS_TIMEOUT_S` after the process started (the kernels' first build
excepted); either way the run raises and has no result.
"""
from __future__ import annotations

import datetime
import gc
import sys
import tempfile
import time
import traceback
import zlib

import numpy as np
import torch

from portbench import drivers, graph500, reference
from portbench import trace as tracing
from portbench.manifest import Manifest

# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# The ranks of a multi-chip run end this long after the process started,
# less the kernels' build, whatever they are doing: inside the 360 s that
# one run may take.
RANKS_TIMEOUT_S = 330.0


class ForbiddenLoaded(RuntimeError):
    """A rank held a module of `FORBIDDEN` once its window had closed."""

    def __init__(self, names: list, by_rank: list):
        self.names = names
        super().__init__(", ".join(f"rank {r}: {', '.join(n)}"
                                   for r, n in enumerate(by_rank) if n))


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
        device, t_start: float, backend=None, follower=None) -> dict:
    """One run; returns the result line's object (`checks` last).

    On more than one chip: `backend` is the ranks' (None: NCCL on CUDA,
    gloo on the CPU; gloo lets ranks share one card), `follower` what
    ranks > 0 run (None: `follow_front`; a test gives a faulty one).
    Raises `ForbiddenLoaded` if a rank held a module of `FORBIDDEN`."""
    device = torch.device(device)
    m = Manifest(root)
    cell = m.workload(workload)
    chips = int(cell["chips"])
    if chips == 1:
        return _sequence(root, workload, seed, seconds, trace, device,
                         t_start)
    return _run_ranks(root, workload, chips, m.traffic(cell["traffic"]),
                      seed, seconds, trace, device, t_start, backend,
                      follower or follow_front)


def _run_ranks(root, workload, chips, traffic, seed, seconds, trace, device,
               t_start, backend, follower) -> dict:
    """`chips` ranks, one a device; rank 0's result, with every rank's
    memory peak in `device`."""
    from repro_torch.parallel.ranks import run_ranks
    if traffic["loop"] != "closed":
        raise ValueError(f"cell {workload}: a {traffic['loop']!r} loop on "
                         f"{chips} chips; a cell on more than one chip takes "
                         "a closed loop")
    cuda = device.type == "cuda"
    t_build = time.perf_counter()
    if cuda:
        # `run_ranks` builds the kernels too, before it starts its clock;
        # built here first, the build stays out of the ranks' timeout: the
        # first run in a checkout compiles for minutes, which its 1,200 s
        # allow, and `run_ranks` then finds them built
        from repro_torch.kernels import _build
        _build.build_all()
    t_spawn = time.perf_counter()
    ranks = run_ranks(
        _rank, chips, tempfile.gettempdir(),
        args=(str(root), workload, seed, seconds, trace, t_start,
              float(traffic.get("drain_s", 60.0)), follower),
        backend=backend or ("nccl" if cuda else "gloo"),
        # an index, so that this process never initializes CUDA itself
        device=torch.device("cuda", 0) if cuda else "cpu",
        timeout=RANKS_TIMEOUT_S - (t_build - t_start))
    t_end = time.perf_counter()
    failed = 0
    for r, got in enumerate(ranks):
        if got["error"] is not None:
            failed += 1
            print(f"rank {r} failed:\n{got['error']}", file=sys.stderr)
        # setup_s is rank 0's clock less this process's start: one clock
        if not t_spawn <= got["t_enter"] <= t_end:
            raise RuntimeError(
                f"rank {r} read perf_counter {got['t_enter']} outside this "
                f"process's [{t_spawn}, {t_end}]: not one clock")
    by_rank = [got["forbidden"] for got in ranks]
    if any(by_rank):
        raise ForbiddenLoaded(sorted({n for f in by_rank for n in f}),
                              by_rank)
    out = ranks[0]["out"]
    # a follower that failed anywhere (window, traced slice, replay, close)
    # fails the run, whatever rank 0 read
    out["checks"]["ranks_failed"] = reference.check_lines(
        {"ranks_failed": failed})["ranks_failed"]
    out["correct"] = out["correct"] and failed == 0
    peaks = [got["peak"] for got in ranks]
    out["device"].update(count=chips, memory_peak_bytes=max(peaks),
                         memory_peak_bytes_by_rank=peaks)
    return out


def _rank(rank, group, device, root, workload, seed, seconds, trace,
          t_start, drain_s, follower) -> dict:
    """One rank's process (`run_ranks`): a data group whose collectives
    time out after `drain_s`, then rank 0's sequence or `follower`."""
    import torch.distributed as dist
    t_enter = time.perf_counter()
    data = dist.new_group(timeout=datetime.timedelta(seconds=drain_s))
    if rank == 0:
        out = _sequence(root, workload, seed, seconds, trace, device,
                        t_start, data)
        peak, error = out["device"]["memory_peak_bytes"], None
    else:
        out = None
        peak, error = follower(data, device, root, workload, seed, drain_s)
    return dict(out=out, peak=peak, error=error, t_enter=t_enter,
                forbidden=forbidden_modules())


def follow_front(group, device, root, workload: str, seed: int,
                 drain_s: float) -> tuple:
    """A rank > 0: the cell's graph from the seed on `device`, checked
    against rank 0's, its session on `group`, then the front's dispatches
    (`partition_front.follow`) until rank 0 closes it. Returns (memory
    peak, None), or (peak, traceback) when `follow` raised."""
    from repro_torch.engine.partition_front import follow
    from repro_torch.engine.session import GraphSession
    m = Manifest(root)
    cfg = m.config(m.workload(workload)["config"])
    csr = graph500.make_graph(cfg["generator"], seed, device)
    agree(csr, group)
    _reset_peak(device)
    session = GraphSession(drivers._graph(csr), device, group=group)
    try:
        follow({"g": session}, group, timeout=drain_s)
        error = None
    except Exception:  # noqa: BLE001 — reported; rank 0 has its result
        error = traceback.format_exc()
    return _peak(device), error


def agree(csr, group) -> None:
    """Check over `group` that every rank made rank 0's graph: vertices,
    directed edges and a CRC-32 of the CSR arrays. Raises on every rank
    where any differs."""
    import torch.distributed as dist
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    mine = torch.tensor([csr.num_vertices, csr.num_directed_edges,
                         zlib.crc32(csr.indices, zlib.crc32(csr.indptr))],
                        dtype=torch.int64, device=dev)
    got = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, mine, group=group)
    rows = [g.tolist() for g in got]
    differ = [r for r, row in enumerate(rows) if row != rows[0]]
    if differ:
        raise RuntimeError(f"ranks {differ} made another graph than rank 0 "
                           f"(vertices, directed edges, CRC-32): {rows}")


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _sequence(root, workload: str, seed: int, seconds: float, trace: bool,
              device, t_start: float, group=None) -> dict:
    """The run on one process: the whole of a one-chip run, rank 0's part
    of a run on more (`group`: the ranks' data group)."""
    from repro_torch.kernels import ops
    cuda = device.type == "cuda"
    m = Manifest(root)
    cell = m.workload(workload)
    cfg = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    t0 = time.perf_counter()
    csr = graph500.make_graph(cfg["generator"], seed, device)
    t_graph = time.perf_counter() - t0
    if group is not None:
        agree(csr, group)
    _reset_peak(device)
    loop = drivers.make(cfg, traffic, csr, seed, device, group)
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
        peak = _peak(device)
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

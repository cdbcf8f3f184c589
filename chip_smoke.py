#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one GPU and check every kernel.

    python3 chip_smoke.py [--seed 0] [--scale 22] [--out record.json]

Needs one CUDA card and the CUDA toolkit; it imports nothing of JAX and
nothing of the JAX package. Phases, in order (any failure ends the run with
a nonzero exit; nothing is caught):

1. Device: the card's name and power limit, then the kernels' build time.
2. Each of the eight kernels against its plain PyTorch version on random
   inputs (ragged R, V not a multiple of 32, masked lanes, degree-0 rows,
   B in {1, 8}, rows of width 32 to 262,144), bitwise; the single-lane
   kernels on lane 0 of the same inputs.
3. Whole-search parity, `Engine(g, device="cuda")` against
   `Engine(g, device="cpu")` on RMAT scale 16: 8 roots batched and 2 in
   Graph500 mode, heuristics paper and beamer, unsplit and with
   `hub_split=True`; 2 roots through `backend="stepper"`. Parents, levels
   and the per-level rows must be equal.
4. The paths at full size, through `Engine.bfs` on Graph500 RMAT at
   --scale (generated once): unsplit (8 roots batched, then 4 in Graph500
   mode), hub split (the same), and 2 roots through the stepper. Launch
   counts are reset just before each path and read just after it; each
   path must have launched each of its kernels. Every tree passes a
   vectorised Graph500 check. Then each kernel is held against its plain
   version on the inputs captured at the level where it had the most live
   rows (2b).
5. Kernel times at those shapes: CUDA events (median), the plain version's
   time and the bound (bytes this call needs / 3.35 TB/s); a profile of
   one search on each path.
6. One JSON line listing the kernels, then the result line.

`--out FILE` also writes the full record (timings, shapes, profiles) as
JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
PARITY_SCALE = 16              # GPU-vs-CPU whole-search parity graph
TIMING_REPS = 20               # CUDA-event samples per timed kernel
KERNELS = {   # name: (CUDA source, the TPU kernel's `pl.pallas_call` line)
    "bottomup_batch": ("src/repro_torch/kernels/csrc/bottomup.cu",
                       "src/repro/kernels/bottomup.py:173"),
    "topdown_batch": ("src/repro_torch/kernels/csrc/topdown.cu",
                      "src/repro/kernels/topdown.py:108"),
    "frontier_fused_batch": ("src/repro_torch/kernels/csrc/frontier_fused.cu",
                             "src/repro/kernels/frontier_fused.py:124"),
    "hub_bottomup_batch": ("src/repro_torch/kernels/csrc/hub.cu",
                           "src/repro/kernels/hub.py:140"),
    "bottomup": ("src/repro_torch/kernels/csrc/bottomup.cu",
                 "src/repro/kernels/bottomup.py:92"),
    "topdown": ("src/repro_torch/kernels/csrc/topdown.cu",
                "src/repro/kernels/topdown.py:45"),
    "frontier_fused": ("src/repro_torch/kernels/csrc/frontier_fused.cu",
                       "src/repro/kernels/frontier_fused.py:61"),
    "hub_bottomup": ("src/repro_torch/kernels/csrc/hub.cu",
                     "src/repro/kernels/hub.py:77"),
}
# The kernels each full-size path must launch.
PATH_KERNELS = {
    "unsplit": ("bottomup_batch", "topdown_batch", "frontier_fused_batch"),
    "split": ("hub_bottomup_batch", "bottomup_batch", "topdown_batch",
              "frontier_fused_batch"),
    "stepper": ("bottomup", "topdown", "frontier_fused"),
}
HUB_BOTTOMUP_NOTE = (
    "no path of the JAX package calls hub_bottomup_pallas (only "
    "kernels/ops.py); checked in phase 2 and timed on lane 0 of a captured "
    "hub_bottomup_batch call")


def log(msg: str) -> None:
    print(msg, flush=True)


def equal(a, b) -> bool:
    """Bitwise equality of two tensors on any device (uint32 via int32)."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def max_abs_err(a, b) -> int:
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# ------------------------------------------------------------ kernel checks --

def plain_fn(name):
    from repro_torch.kernels import bottomup, frontier_fused, hub, topdown
    mod = {"bottomup": bottomup, "topdown": topdown,
           "frontier_fused": frontier_fused,
           "hub_bottomup": hub}[name.removesuffix("_batch")]
    return getattr(mod, name + "_plain")


def kernel_vs_plain(name, args, errs):
    """Run kernel `name` through its ops wrapper (CUDA tensors: the kernel)
    and its plain version on the same tensors; assert bitwise equality."""
    from repro_torch.kernels import ops
    out_k = getattr(ops, name)(*args)
    out_p = plain_fn(name)(*args)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    for k, p in zip(out_k, out_p):
        errs[name] = max(errs[name], max_abs_err(k, p))
        assert equal(k, p), f"{name}: kernel != plain version"


def make_case(rng, dev, b, r, w, v, masked, dens):
    """deg int32[B, R] (a quarter degree 0, the last `masked` lanes all 0),
    nbrs int32[R, W] (ids out of range on both sides, clipped), flags
    uint8[B, V] of density `dens`, vertex degrees int32[V]."""
    import torch
    deg = rng.integers(1, w + 1, (b, r)).astype(np.int32)
    deg[rng.random((b, r)) < 0.25] = 0                 # degree-0 rows
    deg[b - masked:] = 0                               # masked lanes
    nbrs = rng.integers(-2, v + 2, (r, w)).astype(np.int32)   # clipped
    flags = (rng.random((b, v)) < dens).astype(np.uint8)
    vdeg = rng.integers(0, 1 << 12, v).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (deg, nbrs, flags,
                                                       vdeg))


# (B, R, W, V, lanes masked, frontier density)
CASES = [(1, 5, 32, 37, 0, 0.3), (8, 333, 64, 4099, 3, 0.05),
         (8, 1000, 32, 100003, 2, 0.01), (1, 3, 4096, 70001, 0, 0.0005),
         (8, 9, 4096, 50000, 4, 0.001), (8, 20000, 32, 262144, 1, 0.02)]
# Hub widths: sparse frontiers, so that some rows hit deep or not at all.
HUB_CASES = [(8, 3000, 256, 1000003, 2, 0.002), (1, 700, 1024, 500001, 0,
                                                  0.0005),
             (8, 60, 16384, 4194304, 3, 0.0001),
             (8, 6, 262144, 4194304, 1, 0.00001),
             (1, 4, 262144, 4194304, 0, 0.000002)]


def phase_kernels(rng, hub_rng, dev, errs):
    """Every kernel on random cases; the single-lane ones on lane 0. The
    hub cases draw from `hub_rng`, so `rng` reaches the later phases (and
    picks the scale-22 roots) as it did before they were added."""
    import torch
    n = 0
    for spec in CASES + HUB_CASES:
        deg, nbrs, flags, vdeg = make_case(
            hub_rng if spec in HUB_CASES else rng, dev, *spec)
        d0, f0 = deg[0], flags[0]
        kernel_vs_plain("hub_bottomup_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("hub_bottomup", (d0, nbrs, f0), errs)
        if spec in HUB_CASES:
            continue
        kernel_vs_plain("bottomup_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("topdown_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("frontier_fused_batch", (flags, vdeg), errs)
        kernel_vs_plain("bottomup", (d0, nbrs, f0), errs)
        kernel_vs_plain("topdown", (d0, nbrs, f0), errs)
        kernel_vs_plain("frontier_fused", (f0, vdeg), errs)
        n += 1
    # nf/mf near the int32 limit: every flag set, degrees summing to
    # 2^31 - 1 - 5 per lane.
    v = 4096
    vdeg = np.full(v, (2**31 - 6) // v, np.int32)
    vdeg[0] += (2**31 - 6) - int(vdeg.astype(np.int64).sum())
    ones = torch.ones((2, v), dtype=torch.uint8, device=dev)
    vdeg = torch.from_numpy(vdeg).to(dev)
    kernel_vs_plain("frontier_fused_batch", (ones, vdeg), errs)
    kernel_vs_plain("frontier_fused", (ones[0], vdeg), errs)
    torch.cuda.synchronize()
    return n + 1, len(CASES) + len(HUB_CASES)


# ---------------------------------------------------------- whole searches --

ROW_KEYS = ("level", "direction", "td_lanes", "bu_lanes", "frontier_size",
            "frontier_edges", "lane_direction", "lane_frontier",
            "lane_hub_direction", "lane_hub_frontier", "hub_td_lanes",
            "hub_bu_lanes", "frontier_hub")
STEPPER_KEYS = ("level", "direction", "frontier_size", "frontier_edges")


def rows_of(res):
    return [tuple(str(r[k]) for k in ROW_KEYS) for r in res.batch_level_stats]


def stepper_rows(res):
    return [[tuple(r[k] for k in STEPPER_KEYS) for r in rows]
            for rows in res.per_level_stats]


def same_trees(a, b, what):
    assert np.array_equal(a.parent, b.parent), f"{what}: parents differ"
    assert np.array_equal(a.level, b.level), f"{what}: levels differ"


def phase_parity(scale, rng):
    from repro_torch.core import graph as G, ref
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import Engine
    g = G.rmat(scale, seed=int(rng.integers(1 << 30)))
    pos = np.flatnonzero(g.degrees > 0)
    roots = rng.choice(pos, 8, replace=False)
    gpu, cpu = Engine(g, device="cuda"), Engine(g, device="cpu")
    for h in ("paper", "beamer"):
        for split in (False, True):
            what = f"{h}{' split' if split else ''}"
            cfg = BFSConfig(heuristic=h, hub_split=split)
            a, b = gpu.bfs(roots, cfg), cpu.bfs(roots, cfg)
            same_trees(a, b, what)
            rows = rows_of(b)
            assert rows_of(a) == rows, what
            a = gpu.bfs(roots[:2], cfg, batched=False)
            same_trees(a, cpu.bfs(roots[:2], cfg, batched=False), what)
            for i, r in enumerate(roots[:2]):
                ref.validate_parents(g, int(r), a.parent[i], a.level[i])
            log(f"  {what}: batched {len(rows)} levels, directions "
                f"{[r[1] for r in rows]}")
    a = gpu.bfs(roots[:2], backend="stepper")
    b = cpu.bfs(roots[:2], backend="stepper")
    same_trees(a, b, "stepper")
    assert stepper_rows(a) == stepper_rows(b), "stepper rows differ"
    log(f"  stepper: directions {[r[1] for r in stepper_rows(a)[0]]}")
    return g


class Graph500Check:
    """Vectorised Graph500 validation on the card for big graphs."""

    def __init__(self, g, dev):
        import torch
        v = g.num_vertices
        self.v, self.dev = v, dev
        self.src = torch.repeat_interleave(
            torch.arange(v, device=dev, dtype=torch.int32),
            torch.from_numpy(g.degrees).to(dev).to(torch.int64))
        self.dst = torch.from_numpy(g.indices).to(dev)
        self.keys = torch.sort(self.src.to(torch.int64) * v
                               + self.dst.to(torch.int64)).values

    def levels(self, root):
        """Plain level-synchronous BFS over the edge list."""
        import torch
        level = torch.full((self.v,), -1, dtype=torch.int32, device=self.dev)
        level[root] = 0
        frontier = torch.zeros(self.v, dtype=torch.bool, device=self.dev)
        frontier[root] = True
        depth = 0
        while True:
            reached = torch.zeros(self.v, dtype=torch.bool, device=self.dev)
            reached[self.dst[frontier[self.src]].to(torch.int64)] = True
            new = reached & (level < 0)
            if not bool(new.any()):
                return level
            depth += 1
            level[new] = depth
            frontier = new

    def check(self, root, parent, level):
        import torch
        parent = torch.from_numpy(parent).to(self.dev).to(torch.int64)
        level = torch.from_numpy(level).to(self.dev)
        assert torch.equal(level, self.levels(root)), "levels differ"
        assert int(parent[root]) == root, "root is not its own parent"
        assert torch.equal(parent >= 0, level >= 0), "coverage != reached"
        vs = torch.nonzero(level > 0).flatten()
        p = parent[vs]
        key = vs * self.v + p
        pos = torch.searchsorted(self.keys, key).clamp(max=self.keys.numel() - 1)
        assert torch.equal(self.keys[pos], key), "a parent is not a neighbour"
        assert torch.equal(level[p], level[vs] - 1), "a tree edge skips a level"


def install_capture():
    """Record every wrapper call's inputs with the path and the level it
    ran at (a frontier_fused call closes a level). Returns (calls, path,
    restore): set `path[0]` to label the calls that follow."""
    from repro_torch.kernels import ops
    calls, level, path = [], [0], [None]
    saved = {n: getattr(ops, n) for n in KERNELS}

    def wrap(name):
        def fn(*args, **kw):
            calls.append((path[0], level[0], name, args))
            if name.startswith("frontier_fused"):
                level[0] += 1
            return saved[name](*args, **kw)
        return fn

    for n in KERNELS:
        setattr(ops, n, wrap(n))

    def restore():
        for n, f in saved.items():
            setattr(ops, n, f)
    return calls, path, restore


def pick_calls(calls):
    """Per kernel, the captured calls of the level where it had the most
    live rows (nonzero degrees); a packing kernel takes the level of its
    path's push kernel."""
    import torch
    work = {}
    for _, lvl, name, args in calls:
        if not name.startswith("frontier_fused"):
            key = (name, lvl)
            work[key] = work.get(key, 0) + int((args[0] != 0).sum())
    best = {}
    for (name, lvl), w in work.items():
        if w > best.get(name, (-1, 0))[1]:
            best[name] = (lvl, w)
    levels = {n: lvl for n, (lvl, _) in best.items()}
    levels["frontier_fused_batch"] = levels["topdown_batch"]
    levels["frontier_fused"] = levels["topdown"]
    torch.cuda.synchronize()
    return {name: [c for c in calls if c[2] == name and c[1] == lvl]
            for name, lvl in levels.items()}


# --------------------------------------------------------------- timing --

def time_ms(fn, reps, flush):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def profile_search(search, top=10):
    """One more search (`search()`) under torch.profiler: device time by op
    (self time, ms) and the device's busy share of the search's wall time.
    Not part of the paths' launch counts (read before this runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue                      # host ops; kernels are listed alone
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / 1e3 / wall),
                top=[dict(op=k[:80], device_ms=ms, calls=n)
                     for k, ms, n in rows[:top]])


def touched_bytes(table, lanes_idx):
    """Distinct (lane, vertex) bytes a gather reads from a [B, V] table."""
    import torch
    b, v = table.shape
    seen = torch.zeros(b * v, dtype=torch.bool, device=table.device)
    seen[lanes_idx] = True
    return int(seen.sum())


def as_batch(name, args):
    """A single-lane call's inputs with a lane axis of 1 (views)."""
    if name in ("bottomup", "hub_bottomup", "topdown"):
        deg, nbrs, table = args
        return deg[None], nbrs, table[None]
    if name == "frontier_fused":
        flags, deg = args
        return flags[None], deg
    return args


def bound(name, args):
    """(bytes, ops) this call needs: each input byte it must read once,
    each output byte written once; data-dependent reads counted for these
    inputs (slots up to the first hit, live slots only)."""
    import torch
    args = as_batch(name, args)
    if name.startswith("frontier_fused"):
        flags, deg = args
        b, v = flags.shape
        flagged = int((flags != 0).any(dim=0).sum())
        return b * v + 4 * flagged + b * ((v + 31) // 32) * 4 + 8 * b, b * v
    deg, nbrs, table = args
    b, r = deg.shape
    w = nbrs.shape[1]
    v = table.shape[1]
    live = deg.clamp(max=w).to(torch.int64)                  # [B, R]
    cols = torch.arange(w, device=deg.device)
    if name.removesuffix("_batch") in ("bottomup", "hub_bottomup"):
        # Needed slots stop at the first hit.
        need = torch.zeros_like(live)
        safe = nbrs.clamp(0, v - 1).to(torch.int64)
        for lane in range(b):
            hit = (cols[None] < live[lane][:, None]) & (table[lane][safe] != 0)
            first = hit.to(torch.uint8).argmax(dim=1)
            need[lane] = torch.where(hit.any(dim=1), first + 1, live[lane])
        out_bytes = b * r * 5
    else:
        need = live
        out_bytes = b * r * w
    nbr_bytes = 4 * int(need.max(dim=0).values.sum())
    if name == "topdown":
        # dst = clip(nbrs) for every slot: the whole tile in, int32 out.
        nbr_bytes = 4 * r * w
        out_bytes += 4 * r * w
    idx = []
    for lane in range(b):
        m = cols[None] < need[lane][:, None]
        idx.append(lane * v + nbrs.clamp(0, v - 1).to(torch.int64)[m])
    table_bytes = touched_bytes(table, torch.cat(idx))
    return 4 * b * r + nbr_bytes + table_bytes + out_bytes, int(need.sum())


def time_kernel(name, args, reps, flush):
    """(kernel ms, plain ms) for one captured call. The kernel's launcher
    is timed alone, on the inputs `ops` hands it (a lane axis of 1 for a
    single-lane kernel, V padded to whole words for a packing kernel); the
    plain version on the call's own inputs."""
    from repro_torch.kernels import bottomup, frontier_fused, hub, ops, topdown
    if name == "topdown":
        deg, nbrs, table = args
        dc = deg.contiguous()
        cuda = (lambda: topdown.topdown_cuda(dc, nbrs, table))
    elif name.startswith("frontier_fused"):
        flags, deg = as_batch(name, args)
        fp, dp = ops.pad_words(flags), ops.pad_words(deg)
        cuda = (lambda: frontier_fused.frontier_fused_batch_cuda(fp, dp))
    else:
        deg, nbrs, table = as_batch(name, args)
        dc = deg.contiguous()
        launch = {"bottomup": bottomup.bottomup_batch_cuda,
                  "topdown": topdown.topdown_batch_cuda,
                  "hub_bottomup": hub.hub_bottomup_batch_cuda}[
                      name.removesuffix("_batch")]
        cuda = (lambda: launch(dc, nbrs, table))
    plain = plain_fn(name)
    return (time_ms(cuda, reps, flush),
            time_ms(lambda: plain(*args), reps, flush))


def trees_ok(check, *results):
    n = 0
    for res in results:
        for i, r in enumerate(res.roots):
            check.check(int(r), res.parent[i], res.level[i])
            n += 1
    return n


def level_rows(res):
    return [dict(level=r["level"], direction=r["direction"],
                 frontier_size=r["frontier_size"], seconds=r["seconds"])
            for r in res]


# ------------------------------------------------------------------ main --

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--out", default=None,
                    help="also write the full record as JSON to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    record = dict(seed=args.seed, scale=args.scale)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    record["card"] = smi
    record["torch"] = torch.__version__
    build_s = _build.build_all()
    record["build_s"] = build_s
    log(f"phase 1: built {len(_build.SOURCES)} kernel sources in "
        f"{build_s:.3f} s ({_build.BUILD_DIR})")

    # 2. kernels against their plain versions, random inputs
    errs = {n: 0 for n in KERNELS}
    t0 = time.perf_counter()
    n_cases, n_hub = phase_kernels(rng, np.random.default_rng([args.seed, 1]),
                                   dev, errs)
    log(f"phase 2: {n_cases} random cases per kernel, {n_hub} per hub "
        f"kernel, bitwise equal ({time.perf_counter() - t0:.1f} s)")

    # 3. whole-search parity, GPU against CPU
    t0 = time.perf_counter()
    phase_parity(PARITY_SCALE, rng)
    record["parity_s"] = time.perf_counter() - t0
    log(f"phase 3: scale-{PARITY_SCALE} searches equal on cuda and cpu "
        f"({record['parity_s']:.1f} s)")

    # 4. the paths at full size, on one graph
    from repro_torch.core import ell as ELL
    from repro_torch.core.bfs import BFSConfig
    t0 = time.perf_counter()
    g = G.rmat(args.scale, seed=args.seed)
    record["graph_s"] = time.perf_counter() - t0
    engine = Engine(g)
    t1 = time.perf_counter()
    engine.session.device_graph()
    ell = engine.session.ell_tiles()
    torch.cuda.synchronize()
    record["session_s"] = time.perf_counter() - t1
    split_cfg = BFSConfig(hub_split=True)
    _, hub_tiles = ELL.split_tiles(ell, split_cfg.hub_deg)
    record["graph"] = dict(
        V=g.num_vertices, E_directed=g.num_directed_edges,
        ell_buckets=[list(t.nbrs.shape) for t in ell],
        hub_floor=ELL.hub_degree_floor(split_cfg.hub_deg),
        hub_rows=sum(int(t.nbrs.shape[0]) for t in hub_tiles),
        hub_buckets=[list(t.nbrs.shape) for t in hub_tiles])
    log(f"phase 4: RMAT scale {args.scale}: V={g.num_vertices} "
        f"E={g.num_directed_edges} directed; generation "
        f"{record['graph_s']:.1f} s, device graph + ELL "
        f"{record['session_s']:.1f} s; hub (degree > "
        f"{record['graph']['hub_floor']}): {record['graph']['hub_rows']} "
        f"rows in buckets {record['graph']['hub_buckets']}")
    pos = np.flatnonzero(g.degrees > 0)
    roots = rng.choice(pos, 12, replace=False)
    calls, path, restore = install_capture()
    launches = {n: 0 for n in KERNELS}
    runs = {}

    def drive(name, label, fn):
        """One path's run: counts zeroed just before, read just after."""
        path[0] = name
        ops.reset_launches()
        t = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t
        got = dict(ops.LAUNCHES)
        for k in PATH_KERNELS[name]:
            assert got[k] > 0, f"{k} never launched on the {name} path"
        for k, c in got.items():
            launches[k] += c
        runs[label] = dict(path=name, launches=got, wall_s=wall)
        log(f"  {label}: {wall:.3f} s, launches "
            f"{ {k: c for k, c in got.items() if c} }")
        return res

    batched = drive("unsplit", "unsplit batch of 8",
                    lambda: engine.bfs(roots[:8]))
    g500 = drive("unsplit", "unsplit Graph500 mode, 4 roots",
                 lambda: engine.bfs(roots[8:], batched=False))
    split_b = drive("split", "split batch of 8",
                    lambda: engine.bfs(roots[:8], split_cfg))
    split_g = drive("split", "split Graph500 mode, 4 roots",
                    lambda: engine.bfs(roots[8:], split_cfg, batched=False))
    stepper = drive("stepper", "stepper, 2 roots",
                    lambda: engine.bfs(roots[:2], backend="stepper"))
    restore()
    record["runs"] = runs
    record["launches"] = launches
    check = Graph500Check(g, dev)
    n_trees = trees_ok(check, batched, g500, split_b, split_g, stepper)
    for key, res in (("batched", batched), ("split", split_b)):
        record[f"teps_{key}"] = res.teps
        record[f"seconds_{key}"] = res.seconds
        record[f"levels_{key}"] = level_rows(res.batch_level_stats)
    for key, res in (("g500", g500), ("split_g500", split_g),
                     ("stepper", stepper)):
        record[f"teps_hmean_{key}"] = res.teps_hmean
        record[f"per_root_seconds_{key}"] = res.per_root_seconds.tolist()
    record["levels_stepper"] = [level_rows(s) for s in stepper.per_level_stats]
    log(f"  {n_trees} trees pass the Graph500 check. Batch of 8: unsplit "
        f"{batched.seconds:.4f} s, {batched.teps / 1e9:.3f} GTEPS; split "
        f"{split_b.seconds:.4f} s, {split_b.teps / 1e9:.3f} GTEPS. Graph500 "
        f"mode harmonic mean: unsplit {g500.teps_hmean / 1e9:.3f}, split "
        f"{split_g.teps_hmean / 1e9:.3f}, stepper "
        f"{stepper.teps_hmean / 1e9:.3f} GTEPS")
    picked = pick_calls(calls)
    n_checked = 0
    for name, mine in picked.items():
        for _, _, _, cargs in mine:
            kernel_vs_plain(name, cargs, errs)
            n_checked += 1
    # hub_bottomup: lane 0 of every checked hub_bottomup_batch call
    for _, _, _, (deg, nbrs, fr) in picked["hub_bottomup_batch"]:
        kernel_vs_plain("hub_bottomup", (deg[0], nbrs, fr[0]), errs)
    torch.cuda.synchronize()
    log(f"phase 2b: {n_checked} captured calls bitwise equal, at levels "
        f"{ {n: c[0][1] for n, c in picked.items()} }")

    # 5. kernel times at the captured full-size shapes
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    entries = []
    for name, (source, replaces) in KERNELS.items():
        src_name = "hub_bottomup_batch" if name == "hub_bottomup" else name
        # the call moving the most bytes at that level
        _, lvl, _, cargs = max(
            picked[src_name], key=lambda c: c[3][1].numel()
            if not src_name.startswith("frontier_fused")
            else int(c[3][0].sum()))
        if name == "hub_bottomup":
            deg, nbrs, fr = cargs
            lane = int((deg != 0).sum(dim=1).argmax())
            cargs = (deg[lane], nbrs, fr[lane])
        ms, plain_ms = time_kernel(name, cargs, TIMING_REPS, flush)
        nbytes, nops = bound(name, cargs)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        if name == "hub_bottomup":
            entry["note"] = HUB_BOTTOMUP_NOTE
        entries.append(entry)
        record.setdefault("timed_calls", []).append(dict(
            name=name, level=lvl, shapes=[list(a.shape) for a in cargs],
            bytes=nbytes, ops=nops))
        log(f"phase 5: {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms by {entry['bound_by']}) "
            f"at {[list(a.shape) for a in cargs]}")
    record["kernels"] = entries
    record["profiles"] = {}
    for label, fn in (
            ("unsplit batch of 8", lambda: engine.bfs(roots[:8])),
            ("split batch of 8", lambda: engine.bfs(roots[:8], split_cfg)),
            ("stepper, 1 root",
             lambda: engine.bfs(roots[:1], backend="stepper"))):
        prof = profile_search(fn)
        record["profiles"][label] = prof
        log(f"phase 5: profiled {label}: wall {prof['wall_s']:.3f} s, "
            f"device busy {prof['device_busy_ms']:.1f} ms (idle share "
            f"{prof['idle_share']:.3f}); top device time:")
        for row in prof["top"]:
            log(f"    {row['device_ms']:10.2f} ms {row['calls']:6d}x "
                f"{row['op']}")
    record["total_s"] = time.perf_counter() - t_start
    log(f"total {record['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    # 6. the kernels line, then the result line
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one GPU and check every kernel.

    python3 chip_smoke.py [--seed 0] [--scale 22] [--out record.json]

Needs one CUDA card and the CUDA toolkit; it imports nothing of JAX and
nothing of the JAX package. Phases, in order (any failure ends the run with
a nonzero exit; nothing is caught):

1. Device: the card's name and power limit, then the kernels' build time.
2. Each of the eight BFS kernels against its plain PyTorch version on
   random inputs (ragged R, V not a multiple of 32, masked lanes, degree-0
   rows, B in {1, 8}, rows of width 32 to 262,144), bitwise; the
   single-lane kernels on lane 0 of the same inputs. The decode attention
   kernel against its plain version on random (B, S, K, g, h) cases:
   gemma2-9b's, yi-9b's and stablelm-3b's decode shapes, g = 16, rows not
   16-byte aligned, S not a multiple of the split length, tiny edges; fp32
   and bf16, cap 0 and 50, cache_len 1 (every split of S but the first
   empty), S and random (fp32 within 3e-5; bf16 within one bf16 step,
   rtol 2^-7, atol 1e-5); a second call on the same inputs gives the same
   bits, and cache_len 0 gives exact zeros. Then each case with q scaled
   by 30, so that scores reach the cap: the cap-50 output matches the
   plain one and is far from the kernel's own cap-0 output (standard
   normal scores sit where the cap changes them by about 1e-4, below any
   tolerance).
3. Whole-search parity, `Engine(g, device="cuda")` against
   `Engine(g, device="cpu")` on RMAT scale 16: 8 roots batched and 2 in
   Graph500 mode, heuristics paper and beamer, unsplit and with
   `hub_split=True`; 2 roots through `backend="stepper"`. Parents, levels
   and the per-level rows must be equal. Serving parity (3b): gemma2-9b
   and yi-9b smoke in fp32, prefill and 8 greedy decode steps on the card
   against the same weights on the CPU: equal tokens, logits within 1e-4.
4. The paths at full size, through `Engine.bfs` on Graph500 RMAT at
   --scale (generated once): unsplit (8 roots batched, then 4 in Graph500
   mode), hub split (the same), and 2 roots through the stepper. Launch
   counts are reset just before each path and read just after it; each
   path must have launched each of its kernels. Every tree passes a
   vectorised Graph500 check. Then each kernel is held against its plain
   version on the inputs captured at the level where it had the most live
   rows (2b).
5. BFS kernel times at those shapes: CUDA events (median), the plain
   version's time and the bound (bytes this call needs / 3.35 TB/s); a
   profile of one search on each path.
6. The serving path at gemma2-9b's full width (42 layers, bf16, random
   weights from --seed), after the BFS phases' tensors are freed:
   `launch.serve.serve` (what `main` runs) with batch 4, a 4,200-token
   prompt and 32 greedy tokens. The decode kernel's launch count is reset
   just before and read just after (42 x 31); its calls at the first and
   last decode step on layers 0 (local) and 1 (global) are captured and
   held against the plain version (bf16, one step). Then the kernel's time at
   that shape (cap 50 and cap 0) with its split count, achieved GB/s and
   share of the bound, its plain version's time, one
   `F.scaled_dot_product_attention` call at cap 0 as the library
   yardstick, and the host's cost of a launcher call; the kernel and SDPA
   at yi-9b's and stablelm-3b's decode shapes too; a profile of one
   decode step.
7. One JSON line listing the kernels, then the result line.

`--out FILE` also writes the full record (timings, shapes, profiles) as
JSON.
"""
from __future__ import annotations

import argparse
import gc
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
SLEEP_CYCLES = 200_000_000     # ~0.1 s at 1.98 GHz: the host queues ahead
# name: (CUDA source, the TPU kernel's `pl.pallas_call` line)
BFS_KERNELS = {
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
DECODE = ("decode_attention", "src/repro_torch/kernels/csrc/decode_attn.cu",
          "src/repro/kernels/decode_attn.py:90")
# (B, S, K, g, h): the JAX kernel tests' sweep, tiny edges, the decode
# shapes of gemma2-9b, yi-9b and stablelm-3b (context 4,232, not a multiple
# of their split lengths), g = 16 at S = 333 (not a multiple of the 32-
# position split), bf16 rows of 40 bytes (no 16-byte copies).
DECODE_CASES = [(2, 1024, 4, 2, 64), (3, 700, 2, 5, 32), (1, 64, 1, 1, 16),
                (1, 1, 1, 1, 8), (4, 4232, 8, 2, 256), (4, 4232, 4, 8, 128),
                (2, 4232, 32, 1, 80), (1, 333, 2, 16, 256), (3, 77, 2, 3, 20)]
# (rtol, atol) of kernel against plain: fp32 sums in another order; bf16
# one step of the value (both round the same fp32 result, up to its order)
DECODE_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2 ** -7, 1e-5)}
CAP_SCALE = 30.0     # q scale at which the scores reach the soft cap of 50
# SDPA against the plain version: it rounds p to bf16 before p @ v
SDPA_TOL = 1e-2
# The serve run: gemma2-9b at full width, cut from configs/shapes.py's
# decode_32k (B = 128, S = 32,768) to one card.
SERVE = dict(arch="gemma2-9b", batch=4, prompt_len=4200, gen=32)
OTHER_DECODE = ("yi-9b", "stablelm-3b")   # decode kernel timed at their shape
SDPA_NOTE = ("F.scaled_dot_product_attention (enable_gqa, boolean mask from "
             "cache_len) computes the cap-0 function; no single PyTorch call "
             "computes the soft-capped one the model runs (cap 50)")
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
    saved = {n: getattr(ops, n) for n in BFS_KERNELS}

    def wrap(name):
        def fn(*args, **kw):
            calls.append((path[0], level[0], name, args))
            if name.startswith("frontier_fused"):
                level[0] += 1
            return saved[name](*args, **kw)
        return fn

    for n in BFS_KERNELS:
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
    """Median device ms of `fn` between two CUDA events, over `reps` runs,
    each after a read of `flush` (larger than the L2, so inputs come from
    device memory; a read leaves no dirty lines for `fn` to write back).
    All runs are queued behind a device-side sleep, so the host's time to
    launch `fn` is not in the events' interval."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in events:
        flush.amax()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


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


# ------------------------------------------------------------- serving --

def decode_inputs(rng, dev, dtype, b, s, k, g, h, clen):
    """q [B,K,g,h], k/v caches [B,S,K,h] (standard normal, in `dtype`),
    cache_len int32[B] on the card."""
    import torch
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for shape in ((b, k, g, h), (b, s, k, h),
                                                  (b, s, k, h)))
    return q, kc, vc, torch.as_tensor(np.asarray(clen, np.int32), device=dev)


def decode_vs_plain(args, cap, out=None):
    """The kernel's output on `args` (or `out`, captured from a run)
    against the plain version on the same tensors, within the dtype's
    tolerance; returns max |kernel - plain| in fp32."""
    import torch
    from repro_torch.kernels import decode_attn, ops
    if out is None:
        out = ops.decode_attention(*args, logit_cap=cap)
    want = decode_attn.decode_attention_plain(*args, logit_cap=cap)
    rtol, atol = DECODE_TOL[str(args[0].dtype).removeprefix("torch.")]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    return float((out.float() - want.float()).abs().max())


def phase_decode_kernel(rng, dev):
    """Every case in fp32 and bf16, cap 0 and 50, cache_len all 1, all S
    and random, each call made twice and equal bit for bit; then cache_len
    0 must give exact zeros; then (S > 1) q scaled by CAP_SCALE at
    cache_len S: the cap-50 output matches the plain one and differs from
    the kernel's cap-0 output by more than 1000 x the fp32 tolerance.
    Returns (calls, max |kernel - plain|, the least cap-50 vs cap-0 gap)."""
    import torch
    from repro_torch.kernels import ops
    err, n, gap = 0.0, 0, float("inf")
    for b, s, k, g, h in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for clen in ([1] * b, [s] * b, rng.integers(1, s + 1, b)):
                args = decode_inputs(rng, dev, dtype, b, s, k, g, h, clen)
                for cap in (0.0, 50.0):
                    out = ops.decode_attention(*args, logit_cap=cap)
                    again = ops.decode_attention(*args, logit_cap=cap)
                    assert torch.equal(out, again), \
                        f"{(b, s, k, g, h)} {dtype}: two calls differ"
                    err = max(err, decode_vs_plain(args, cap, out))
                    n += 2
            args = decode_inputs(rng, dev, dtype, b, s, k, g, h, [0] * b)
            zero = ops.decode_attention(*args, logit_cap=50.0)
            assert not bool(zero.any()), "cache_len 0: output is not zeros"
            if s == 1:
                continue
            q, kc, vc, clen = decode_inputs(rng, dev, dtype, b, s, k, g, h,
                                            [s] * b)
            args = (q * CAP_SCALE, kc, vc, clen)
            capped = ops.decode_attention(*args, logit_cap=50.0)
            err = max(err, decode_vs_plain(args, 50.0, capped))
            uncapped = ops.decode_attention(*args, logit_cap=0.0)
            n += 2
            case_gap = float((capped.float() - uncapped.float()).abs().max())
            assert case_gap > 1000 * DECODE_TOL["float32"][1], \
                f"{(b, s, k, g, h)} {dtype}: the soft cap moves the output " \
                f"by only {case_gap}"
            gap = min(gap, case_gap)
    torch.cuda.synchronize()
    return n, err, gap


def phase_serve_parity(seed, dev):
    """Smoke configs in fp32 (matmuls in full fp32): the same weights and
    prompt on the card and on the CPU, prefill and 8 greedy steps."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs.base import smoke_config
    from repro_torch.models import decode as D, model as M
    from repro_torch.train.serve_step import greedy_generate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    for arch in ("gemma2-9b", "yi-9b"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        cpu = M.init_params(cfg, torch.Generator().manual_seed(seed))
        gpu = copy.deepcopy(cpu).to(dev)
        prompt = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (2, 24), dtype=np.int32))
        lc, _ = D.prefill(cfg, cpu, {"tokens": prompt}, 32)
        lg, _ = D.prefill(cfg, gpu, {"tokens": prompt.to(dev)}, 32)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        assert worst <= 1e-4, f"{arch}: prefill logits differ by {worst}"
        tc = greedy_generate(cfg, cpu, prompt, 9, 33)
        tg = greedy_generate(cfg, gpu, prompt.to(dev), 9, 33)
        assert torch.equal(tg.cpu(), tc), f"{arch}: greedy tokens differ"
    return worst


def install_decode_capture(n_layers, steps):
    """Wrap `ops.decode_attention`: call c is decode step c // n_layers,
    layer c % n_layers; the calls of the first and last step on layers 0
    (local) and 1 (global) are kept with clones of their inputs (the
    caches change in place) and their outputs. Returns (kept, restore)."""
    from repro_torch.kernels import ops
    saved, kept, count = ops.decode_attention, [], [0]

    def fn(*args, **kw):
        step, layer = divmod(count[0], n_layers)
        count[0] += 1
        out = saved(*args, **kw)
        if step in (0, steps - 1) and layer in (0, 1):
            kept.append((step, layer, tuple(a.clone() for a in args),
                         kw["logit_cap"], out))
        return out

    ops.decode_attention = fn

    def restore():
        ops.decode_attention = saved
    return kept, restore


def decode_bound(q, kc, clen):
    """(bytes, ops) one decode-attention call needs: K and V rows up to
    cache_len, q and the output once; a multiply-add each for q.k and
    p.v per element of those rows and query heads."""
    b, kk, g, h = q.shape
    n = int(clen.clamp(0, kc.shape[1]).sum())
    esize = q.element_size()
    nbytes = 2 * n * kk * h * esize + 2 * q.numel() * esize + 4 * b
    return nbytes, 4 * n * kk * g * h


def time_decode(q, kc, vc, clen, flush, plain=True):
    """Kernel ms at cap 50 and cap 0, plain ms at both (with `plain`), SDPA
    ms at cap 0 (the library call, checked against the plain cap-0
    output), and the host's microseconds per launcher call (200 calls
    queued back to back, no sync between)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    b, kk, g, h = q.shape
    s = kc.shape[1]
    out = {}
    for cap in (50.0, 0.0):
        out[f"ms_cap{cap:g}"] = time_ms(
            lambda: decode_attn.decode_attention_cuda(q, kc, vc, clen,
                                                      logit_cap=cap),
            TIMING_REPS, flush)
        if plain:
            out[f"plain_ms_cap{cap:g}"] = time_ms(
                lambda: decode_attn.decode_attention_plain(
                    q, kc, vc, clen, logit_cap=cap), TIMING_REPS, flush)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        decode_attn.decode_attention_cuda(q, kc, vc, clen, logit_cap=50.0)
    out["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    qs = q.reshape(b, kk * g, 1, h)
    ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)       # [B, K, S, h]
    mask = (torch.arange(s, device=q.device)[None] < clen[:, None])[
        :, None, None]                                     # [B, 1, 1, S]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    got = sdpa().reshape(b, kk, g, h)
    want = decode_attn.decode_attention_plain(q, kc, vc, clen)
    torch.testing.assert_close(got.float(), want.float(), rtol=SDPA_TOL,
                               atol=SDPA_TOL)
    out["library_ms_cap0"] = time_ms(sdpa, TIMING_REPS, flush)
    return out


def profile_decode_step(step):
    """One decode step under torch.profiler: top device ops, and the
    decode kernel's and the matrix products' shares of device time."""
    prof = profile_search(step, top=1 << 20)
    busy = prof["device_busy_ms"]

    def share(*keys):
        return sum(r["device_ms"] for r in prof["top"]
                   if any(k in r["op"].lower() for k in keys)) / busy
    prof["decode_attn_share"] = share("decode_attn")
    prof["matmul_share"] = share("gemm", "matmul", "cutlass", "xmma",
                                 "cublas", "nvjet")
    prof["top"] = prof["top"][:12]
    return prof


def bfs_paths(args, rng, dev, record, errs):
    """Phases 4, 2b and 5: the BFS paths on Graph500 RMAT at --scale; the
    kernels line's entries of the eight BFS kernels."""
    import torch
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
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
    launches = {n: 0 for n in BFS_KERNELS}
    runs = {}

    def drive(name, label, fn):
        """One path's run: counts zeroed just before, read just after."""
        path[0] = name
        ops.reset_launches()
        t = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t
        got = {k: ops.LAUNCHES[k] for k in BFS_KERNELS}
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
    for name, (source, replaces) in BFS_KERNELS.items():
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
    return entries


def serve_phase(args, dev, record, dec_err):
    """Phase 6: gemma2-9b at full width through `launch.serve.serve`, its
    captured decode calls against the plain version, the kernel's times
    and a profile of one decode step; the kernels line's entry of the
    decode kernel."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    cfg = get_config(SERVE["arch"])
    b, s0, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    steps = gen - 1
    kept, restore = install_decode_capture(cfg.n_layers, steps)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    run = serve.serve(cfg, batch=b, prompt_len=s0, gen=gen, seed=args.seed,
                      device=dev)
    launches = ops.LAUNCHES["decode_attention"]
    restore()
    peak = torch.cuda.max_memory_allocated(dev)
    assert launches == cfg.n_layers * steps, \
        f"decode_attention launched {launches} times, not {cfg.n_layers} x " \
        f"{steps}"
    assert run.tokens.shape == (b, gen), run.tokens.shape
    assert tuple(run.logits.shape) == (b, cfg.vocab)
    assert bool(torch.isfinite(run.logits).all()), "non-finite logits"
    assert sorted((st, ly) for st, ly, *_ in kept) == [
        (0, 0), (0, 1), (steps - 1, 0), (steps - 1, 1)], "capture missed"
    err = dec_err
    for _, _, cargs, cap, out in kept:
        err = max(err, decode_vs_plain(cargs, cap, out))
    torch.cuda.synchronize()
    record["serve"] = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv, head_dim=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.dtype, batch=b,
        prompt_len=s0, gen=gen, decode_steps=steps, launches=launches,
        init_s=run.init_s, prefill_s=run.prefill_s,
        decode_ms_per_step=run.decode_s / steps * 1e3,
        tokens_per_s=steps * b / run.decode_s, peak_bytes=peak,
        tokens_head=run.tokens[:, :8].tolist())
    log(f"phase 6: {cfg.name} at full width ({cfg.n_layers} layers, "
        f"{cfg.dtype}), batch {b}, prompt {s0}, {gen} greedy tokens: weights "
        f"{run.init_s:.1f} s, prefill {run.prefill_s:.3f} s, decode "
        f"{run.decode_s / steps * 1e3:.2f} ms/step "
        f"({steps * b / run.decode_s:.1f} tokens/s), peak memory "
        f"{peak / 2**30:.2f} GiB; decode_attention launched {launches} = "
        f"{cfg.n_layers} x {steps}; its calls at steps 0 and {steps - 1} on "
        f"layers 0 and 1 equal the plain version (max |kernel - plain| "
        f"{err:.3g}); tokens[0] {run.tokens[0, :8].tolist()}")

    # the kernel's time at the serve shape, cache_len = the whole context
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    s = s0 + gen
    q, kc, vc, clen = decode_inputs(
        np.random.default_rng([args.seed, 3]), dev, torch.bfloat16, b, s,
        cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim, [s] * b)
    t = time_decode(q, kc, vc, clen, flush)
    nbytes, nops = decode_bound(q, kc, clen)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
    plan = dict(decode_attn.LAST_PLAN)     # of the launches just timed
    nsplit, split_len = plan["nsplit"], plan["split_len"]
    for cap in ("50", "0"):
        t[f"gb_per_s_cap{cap}"] = nbytes / t[f"ms_cap{cap}"] / 1e6
        t[f"bound_share_cap{cap}"] = max(t_bytes, t_ops) / t[f"ms_cap{cap}"]
    t.update(plan)
    record["decode_timing"] = dict(t, shape=[list(q.shape), list(kc.shape)],
                                   bytes=nbytes, ops=nops)
    log(f"phase 6: decode_attention at q {list(q.shape)}, caches "
        f"{list(kc.shape)} bf16, cache_len {s}, {nsplit} splits of "
        f"{split_len} ({t['blocks']} blocks, {t['resident']} per SM "
        f"resident): {t['ms_cap50']:.4f} ms at "
        f"cap 50 ({t['gb_per_s_cap50']:.0f} GB/s, "
        f"{t['bound_share_cap50']:.3f} of the bound), {t['ms_cap0']:.4f} ms "
        f"at cap 0 ({t['gb_per_s_cap0']:.0f} GB/s, "
        f"{t['bound_share_cap0']:.3f}); plain {t['plain_ms_cap50']:.4f} / "
        f"{t['plain_ms_cap0']:.4f} ms; SDPA at cap 0 "
        f"{t['library_ms_cap0']:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes} bytes); host {t['host_us_per_call']:.1f} us a call")
    del q, kc, vc

    # the same at the decode shapes of the other dense configs the port
    # serves (not driven end to end here)
    record["decode_timing_other"] = {}
    for arch in OTHER_DECODE:
        oc = get_config(arch)
        q, kc, vc, clen = decode_inputs(
            np.random.default_rng([args.seed, 4]), dev, torch.bfloat16, b, s,
            oc.n_kv, oc.n_heads // oc.n_kv, oc.head_dim, [s] * b)
        o = time_decode(q, kc, vc, clen, flush, plain=False)
        nb, _ = decode_bound(q, kc, clen)
        o.update(decode_attn.LAST_PLAN, shape=[list(q.shape),
                                               list(kc.shape)],
                 bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3)
        record["decode_timing_other"][arch] = o
        log(f"phase 6: decode_attention, {arch}'s shape q {list(q.shape)}: "
            f"{o['ms_cap50']:.4f} ms at cap 50, {o['ms_cap0']:.4f} at cap 0 "
            f"({o['nsplit']} splits, {o['resident']} per SM resident), SDPA "
            f"{o['library_ms_cap0']:.4f} ms, bound {o['bound_ms']:.4f} ms")
        del q, kc, vc
    del flush

    # one more decode step (position s - 1) under the profiler
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    tok = torch.from_numpy(run.tokens[:, -1:].astype(np.int32)).to(dev)
    prof = profile_decode_step(
        lambda: D.decode_step(cfg, run.params, run.cache, tok, pos))
    record["decode_profile"] = prof
    log(f"phase 6: profiled one decode step: wall {prof['wall_s'] * 1e3:.2f} "
        f"ms, device busy {prof['device_busy_ms']:.2f} ms (idle share "
        f"{prof['idle_share']:.3f}); decode_attention "
        f"{prof['decode_attn_share']:.3f} of device time, matrix products "
        f"{prof['matmul_share']:.3f}; top device time:")
    for row in prof["top"]:
        log(f"    {row['device_ms']:10.3f} ms {row['calls']:6d}x {row['op']}")
    return dict(
        name=DECODE[0], route="cuda", source=DECODE[1], replaces=DECODE[2],
        launches=launches, max_abs_err=err, ms=t["ms_cap50"],
        plain_ms=t["plain_ms_cap50"], bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=t["library_ms_cap0"], ms_cap0=t["ms_cap0"],
        plain_ms_cap0=t["plain_ms_cap0"], nsplit=nsplit,
        gb_per_s=t["gb_per_s_cap50"], bound_share=t["bound_share_cap50"],
        library_note=SDPA_NOTE)


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
    from repro_torch.kernels import _build

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
    errs = {n: 0 for n in BFS_KERNELS}
    t0 = time.perf_counter()
    n_cases, n_hub = phase_kernels(rng, np.random.default_rng([args.seed, 1]),
                                   dev, errs)
    log(f"phase 2: {n_cases} random cases per kernel, {n_hub} per hub "
        f"kernel, bitwise equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_dec, dec_err, cap_gap = phase_decode_kernel(
        np.random.default_rng([args.seed, 2]), dev)
    record["decode_cases"] = dict(calls=n_dec, max_abs_err=dec_err,
                                  cap_gap=cap_gap)
    log(f"phase 2: decode_attention: {n_dec} random calls within tolerance "
        f"(max |kernel - plain| {dec_err:.3g}), exact zeros at cache_len 0, "
        f"soft cap moves every scaled case by >= {cap_gap:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")

    # 3. whole-search parity, GPU against CPU
    t0 = time.perf_counter()
    phase_parity(PARITY_SCALE, rng)
    record["parity_s"] = time.perf_counter() - t0
    log(f"phase 3: scale-{PARITY_SCALE} searches equal on cuda and cpu "
        f"({record['parity_s']:.1f} s)")

    # 3b. the serving path: smoke configs on the card against the CPU
    t0 = time.perf_counter()
    worst = phase_serve_parity(args.seed, dev)
    log(f"phase 3b: gemma2-9b and yi-9b smoke (fp32) serve alike on cuda "
        f"and cpu: prefill logits within {worst:.2g}, 9 greedy tokens equal "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4, 2b, 5: the BFS paths at full size (their tensors are freed on
    # return, before the serving path needs the card's memory)
    entries = bfs_paths(args, rng, dev, record, errs)
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the serving path at full width
    entries.append(serve_phase(args, dev, record, dec_err))
    record["total_s"] = time.perf_counter() - t_start
    log(f"total {record['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    # 7. the kernels line, then the result line
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

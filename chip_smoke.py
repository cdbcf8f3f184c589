#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one GPU and check every kernel.

    python3 chip_smoke.py [--seed 0] [--scale 22] [--out record.json]

Needs one CUDA card and the CUDA toolkit; it imports nothing of JAX and
nothing of the JAX package. Phases, in order (any failure ends the run with
a nonzero exit; nothing is caught):

1. Device: the card's name and power limit, then the kernels' build time.
2. Each of the ten BFS kernel entries against its plain PyTorch version
   on random inputs (ragged R, V not a multiple of 32, masked lanes,
   degree-0 rows, B in {1, 8}, rows of width 32 to 262,144), bitwise; the
   single-lane kernels on lane 0 of the same inputs; the two pull kernels
   and the push also on cases with RMAT-like skew (most rows of degree
   1-4, a few whose first hit lies deep, B in {1, 8, 16}); the push with
   `keep` on and off, from a `pcand` that already holds ids, and with
   10^5 rows pushing into 16 vertices; the packing kernels with the
   bitmap and without, on their own cases too (B in {1, 3, 8, 16, 40}, V
   from 1 to 2^22 and not a multiple of 32, an empty lane, rows that
   start one byte in with degrees one int32 in, all flags set at V = 2^22,
   nf/mf at the int32 limit and one past it). The decode attention
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
   mode), hub split (the same), and 2 roots through the stepper (each on
   a fresh bucket warms first, inside the path's run). Launch counts are
   reset just before each path and read just after it; each path must
   have launched each of its kernels. Every tree passes a vectorised
   Graph500 check. Then each kernel is held against its plain version on
   the inputs captured at the level where it had the most live rows (2b):
   the push from INT_MAX and from the level's final `pcand`, the fresh
   entries on the push's calls, the packing kernels with the bitmap and
   without, there and on the call with the most set flags.
5. BFS kernel times at those shapes: CUDA events (median), the plain
   version's time and the bound (bytes this call needs / 3.35 TB/s); the
   launch floor (an empty kernel timed the same way); for the push also
   the parent's route on the same call (the fresh entry, `where` and
   `scatter_reduce_`, timed as one); for the packing kernels (timed as
   the paths call them, without the bitmap) also with the bitmap, and
   both again on the call with the most set flags, each beside its
   bound (the degrees counted by 32-byte sector); a profile of one search
   on each path, with the summed device time and calls of each of the
   port's kernels in it and the device ops each wrapper launched (one a
   packing call: no fill).
5s. The partitioned BSP search (`Engine.bfs` with n_parts > 1) on gloo
   ranks that share the card (`repro_torch.parallel.ranks`; NCCL refuses
   two ranks on one GPU), after the BFS tensors are freed; each rank loads
   the graph from a temporary .npz the parent writes. Parity on the
   phase-3 graph: P = 2 and P = 4 ranks each run every case (the three
   strategies at the defaults, then the bitmap exchange, the global
   coordinator and beamer, each as `sharded` and as `stepper`) on a CUDA
   session and on a CPU session over the same group: trees and rows
   equal; rank 0 validates the default case's trees. Full size on the
   --scale graph: P = 4, specialized, 4 roots `sharded` (Graph500 mode), 2
   `stepper` and 1 `stepper` with the bitmap exchange; each rank's launch
   counts are zeroed just before and read just after, and `bottomup`,
   `topdown_push` and `frontier_fused` must each have launched. Rank 0
   holds the trees against the Graph500 check and its captured calls of
   the three kernels against their plain versions bitwise, and times them
   at their largest call. Printed: per-root seconds and TEPS, per-level
   compute_s / exchange_s for psum and bitmap, agg_s, the bytes a level on
   the wire, the group's backend. The times are of P ranks sharing one
   card over gloo, not of a multi-GPU run.
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
    "topdown_push_batch": ("src/repro_torch/kernels/csrc/topdown.cu",
                           "src/repro/kernels/topdown.py:108"),
    "frontier_fused_batch": ("src/repro_torch/kernels/csrc/frontier_fused.cu",
                             "src/repro/kernels/frontier_fused.py:124"),
    "hub_bottomup_batch": ("src/repro_torch/kernels/csrc/bottomup.cu",
                           "src/repro/kernels/hub.py:140"),
    "bottomup": ("src/repro_torch/kernels/csrc/bottomup.cu",
                 "src/repro/kernels/bottomup.py:92"),
    "topdown": ("src/repro_torch/kernels/csrc/topdown.cu",
                "src/repro/kernels/topdown.py:45"),
    "topdown_push": ("src/repro_torch/kernels/csrc/topdown.cu",
                     "src/repro/kernels/topdown.py:45"),
    "frontier_fused": ("src/repro_torch/kernels/csrc/frontier_fused.cu",
                       "src/repro/kernels/frontier_fused.py:61"),
    "hub_bottomup": ("src/repro_torch/kernels/csrc/bottomup.cu",
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
    "unsplit": ("bottomup_batch", "topdown_push_batch",
                "frontier_fused_batch"),
    "split": ("hub_bottomup_batch", "bottomup_batch", "topdown_push_batch",
              "frontier_fused_batch"),
    "stepper": ("bottomup", "topdown_push", "frontier_fused"),
}
# The push updates `pcand` (its argument 4) in place.
PUSH = ("topdown_push_batch", "topdown_push")
# The fresh entries leave the paths: each is checked and timed on the
# calls of its push.
FRESH_OF = {"topdown_batch": "topdown_push_batch", "topdown": "topdown_push"}
FRESH_NOTE = ("the TPU kernel's function (fresh uint8[B, C, W]); no path "
              "launches it since the push replaced it with its caller's "
              "scatter-min; checked in phases 2 and 2b and timed on the "
              "push's call")
INT_MAX = 2**31 - 1
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
    mod = {"bottomup": bottomup, "topdown": topdown, "topdown_push": topdown,
           "frontier_fused": frontier_fused,
           "hub_bottomup": hub}[name.removesuffix("_batch")]
    return getattr(mod, name + "_plain")


def kernel_vs_plain(name, args, errs, **kw):
    """Run kernel `name` through its ops wrapper (CUDA tensors: the kernel)
    and its plain version on the same tensors and keywords; assert bitwise
    equality (an output both leave out, None, is equal). The push runs each
    side on its own copy of `pcand`."""
    from repro_torch.kernels import ops
    if name in PUSH:
        ka, pa = list(args), list(args)
        ka[4], pa[4] = args[4].clone(), args[4].clone()
        getattr(ops, name)(*ka, **kw)
        plain_fn(name)(*pa, **kw)
        out_k, out_p = ka[4], pa[4]
    else:
        out_k = getattr(ops, name)(*args, **kw)
        out_p = plain_fn(name)(*args, **kw)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    for k, p in zip(out_k, out_p):
        if k is None or p is None:
            assert k is None and p is None, f"{name}: an output is missing"
            continue
        errs[name] = max(errs[name], max_abs_err(k, p))
        assert equal(k, p), f"{name}: kernel != plain version"


def check_frontier(flags, vdeg, errs):
    """The packing kernel with the bitmap and without, batched and on lane
    0."""
    for packed in (True, False):
        kernel_vs_plain("frontier_fused_batch", (flags, vdeg), errs,
                        packed=packed)
        kernel_vs_plain("frontier_fused", (flags[0], vdeg), errs,
                        packed=packed)


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


def make_skewed_case(rng, dev, b, r, w, v, deep):
    """A pull case with RMAT-like skew: most rows of degree 1-4, a few up
    to W; a frontier of density 0.02 that never holds vertex 0; and a
    fraction `deep` of the rows whose first hit, in every lane, lies at a
    random slot past 3/4 of the degree (the slots before it hold -1, which
    clips to vertex 0). Returns (deg, nbrs, flags) on `dev`."""
    import torch
    small = rng.integers(1, 5, (b, r))
    big = rng.integers(1, w + 1, (b, r))
    deg = np.where(rng.random((b, r)) < 0.9, small, big).astype(np.int32)
    deg[rng.random((b, r)) < 0.2] = 0                  # settled rows
    nbrs = rng.integers(1, v, (r, w)).astype(np.int32)
    flags = (rng.random((b, v)) < 0.02).astype(np.uint8)
    flags[:, 0] = 0
    for i in np.flatnonzero(rng.random(r) < deep):
        d = max(1, int(deg[:, i].max()))
        s = int(rng.integers(d * 3 // 4, d))
        deg[:, i] = np.where(deg[:, i] > 0, d, 0)
        nbrs[i, :s] = -1
        flags[:, nbrs[i, s]] = 1
    return tuple(torch.from_numpy(x).to(dev) for x in (deg, nbrs, flags))


# (B, R, W, V, deep-row fraction): the base bucket's width with 16 and 1
# lanes, a hub width, and wide rows whose first hits lie past the hub
# kernel's warp phase.
SKEWED_CASES = [(16, 300001, 32, 4194304, 0.001), (8, 200003, 32, 1000003,
                                                   0.01),
                (1, 300001, 32, 4194304, 0.001), (16, 5000, 256, 4194304, 0.05),
                (8, 300, 4096, 4194304, 0.2), (16, 40, 65536, 4194304, 0.5)]


# (B, R, W, V, targets): 10^5 rows live in every lane, every slot naming
# one of 16 unvisited vertices (slots past the degree too).
CONTENTION = (8, 100_000, 32, 1 << 20, 16)


def make_contention_case(rng, dev, b, r, w, v, targets):
    """(deg, nbrs, flags) on `dev`: every row live in every lane, ids in
    0 .. targets - 1, those vertices unvisited in every lane."""
    import torch
    deg = np.repeat(rng.integers(1, w + 1, (1, r)), b, 0).astype(np.int32)
    nbrs = rng.integers(0, targets, (r, w)).astype(np.int32)
    flags = (rng.random((b, v)) < 0.5).astype(np.uint8)
    flags[:, :targets] = 0
    return tuple(torch.from_numpy(x).to(dev) for x in (deg, nbrs, flags))


def push_args(rng, deg, nbrs, flags, keep):
    """The push's inputs on a pull case's tensors: distinct row ids, the
    flags as `visited`, a `pcand` that holds ids at 30% of its entries (as
    after earlier buckets of a level), and `keep` (half the vertices) or
    None."""
    import torch
    b, r = deg.shape
    v = flags.shape[1]
    rows = rng.permutation(max(r, v))[:r].astype(np.int32)
    pcand = np.full((b, v), INT_MAX, np.int32)
    some = rng.random((b, v)) < 0.3
    pcand[some] = rng.integers(0, v, int(some.sum()))
    kp = (rng.random(v) < 0.5).astype(np.uint8) if keep else None
    rows, pcand, kp = (None if x is None else torch.from_numpy(x).to(
        deg.device) for x in (rows, pcand, kp))
    return deg, nbrs, rows, flags, pcand, kp


def check_push(rng, deg, nbrs, flags, errs):
    """The push, batched and on lane 0, with `keep` off and on."""
    for keep in (False, True):
        args = push_args(rng, deg, nbrs, flags, keep)
        kernel_vs_plain("topdown_push_batch", args, errs)
        d, n, r, f, pc, kp = args
        kernel_vs_plain("topdown_push", (d[0], n, r, f[0], pc[0], kp), errs)


def phase_kernels(rng, hub_rng, push_rng, dev, errs):
    """Every kernel on random cases; the single-lane ones on lane 0. The
    hub and skewed cases draw from `hub_rng` and the push's own inputs
    from `push_rng`, so `rng` reaches the later phases (and picks the
    scale-22 roots) as it did before they were added."""
    import torch
    n = 0
    for spec in CASES + HUB_CASES:
        deg, nbrs, flags, vdeg = make_case(
            hub_rng if spec in HUB_CASES else rng, dev, *spec)
        d0, f0 = deg[0], flags[0]
        kernel_vs_plain("hub_bottomup_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("hub_bottomup", (d0, nbrs, f0), errs)
        check_push(push_rng, deg, nbrs, flags, errs)
        if spec in HUB_CASES:
            continue
        kernel_vs_plain("bottomup_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("topdown_batch", (deg, nbrs, flags), errs)
        check_frontier(flags, vdeg, errs)
        kernel_vs_plain("bottomup", (d0, nbrs, f0), errs)
        kernel_vs_plain("topdown", (d0, nbrs, f0), errs)
        n += 1
    for spec in SKEWED_CASES:
        deg, nbrs, flags = make_skewed_case(hub_rng, dev, *spec)
        for name in ("bottomup", "hub_bottomup"):
            kernel_vs_plain(name + "_batch", (deg, nbrs, flags), errs)
            kernel_vs_plain(name, (deg[0], nbrs, flags[0]), errs)
        check_push(push_rng, deg, nbrs, flags, errs)
    check_push(push_rng, *make_contention_case(push_rng, dev, *CONTENTION),
               errs)
    n_ff = phase_frontier(hub_rng, dev, errs)
    torch.cuda.synchronize()
    return n + 1, n_ff


# The packing kernel's own cases: (B, V, density), an empty last lane;
# each also on a view whose rows start one byte in (an unaligned start, a
# row stride of V + 1) and with degrees one int32 off 16-byte alignment.
FRONTIER_CASES = [(b, v, 0.3) for b in (1, 3, 8, 16, 40)
                  for v in (1, 31, 37, 4096, 10000)] + [
                      (8, 1 << 22, 0.002), (40, 1 << 20, 0.05)]
FRONTIER_WIDE = 1 << 22     # all flags set, B = 1, 8, 16 and 40


def frontier_wrap(dev, b, v, total):
    """Every flag of B lanes set, degrees summing to `total` (mod 2^32, as
    int32) per lane; with more than one lane, the last one's first flag
    clear."""
    import torch
    vdeg = np.full(v, total // v, np.int64)
    vdeg[0] += total - int(vdeg.sum())
    flags = torch.ones((b, v), dtype=torch.uint8, device=dev)
    if b > 1:
        flags[b - 1, 0] = 0
    return flags, torch.from_numpy(vdeg.astype(np.int32)).to(dev)


def phase_frontier(rng, dev, errs):
    """The packing kernel, both stores, on FRONTIER_CASES (plain rows,
    rows that start one byte in, degrees off alignment), all flags set at
    V = 2^22, and nf/mf at the int32 limit and one past it (the wrap).
    Returns the cases run."""
    import torch
    n = 0
    for b, v, dens in FRONTIER_CASES:
        wide = (rng.random((b, v + 1)) < dens).astype(np.uint8)
        wide[b - 1] = 0                               # an empty lane
        wide = torch.from_numpy(wide).to(dev)
        deg = torch.from_numpy(
            rng.integers(0, 1 << 12, v + 1).astype(np.int32)).to(dev)
        for flags, vdeg in ((wide[:, :v].contiguous(), deg[:v]),
                            (wide[:, 1:], deg[1:])):
            check_frontier(flags, vdeg, errs)
            n += 1
    for b in (1, 8, 16, 40):
        flags = torch.ones((b, FRONTIER_WIDE), dtype=torch.uint8, device=dev)
        vdeg = torch.from_numpy(rng.integers(
            0, 1 << 8, FRONTIER_WIDE).astype(np.int32)).to(dev)
        check_frontier(flags, vdeg, errs)
        n += 1
    for total in (2**31 - 1, 2**31):
        for b, v in ((2, 4096), (3, 10000), (1, 37)):
            check_frontier(*frontier_wrap(dev, b, v, total), errs)
            n += 1
    return n


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
    saved = {n: getattr(ops, n) for n in BFS_KERNELS if hasattr(ops, n)}

    def wrap(name):
        def fn(*args, **kw):
            if name in PUSH and len(args) == 5:     # keep by default
                calls.append((path[0], level[0], name,
                              args + (kw.get("keep"),)))
            else:
                calls.append((path[0], level[0], name, args))
            if name.startswith("frontier_fused"):
                level[0] += 1
            return saved[name](*args, **kw)
        return fn

    for n in saved:
        setattr(ops, n, wrap(n))

    def restore():
        for n, f in saved.items():
            setattr(ops, n, f)
    return calls, path, restore


def pick_calls(calls):
    """Per kernel, the captured calls of the level where it had the most
    live rows (nonzero degrees); a packing kernel takes the level of its
    path's push kernel (the fresh entry in a checkout older than the
    push)."""
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
    for fresh, push in FRESH_OF.items():
        src = push if push in levels else fresh
        if src in levels:
            levels["frontier_fused" + fresh.removeprefix("topdown")] = \
                levels[src]
    torch.cuda.synchronize()
    return {name: [c for c in calls if c[2] == name and c[1] == lvl]
            for name, lvl in levels.items()}


def flag_call(calls, name):
    """(level, args) of the captured call of packing kernel `name` with the
    most set flags, on any path and level (the bottom-up levels' wide next
    frontiers, where the kernel reads most of the degrees)."""
    _, lvl, _, cargs = max((c for c in calls if c[2] == name),
                           key=lambda c: int((c[3][0] != 0).sum()))
    return lvl, cargs


# --------------------------------------------------------------- timing --

def time_ms(fn, reps, flush, setup=None):
    """Median device ms of `fn` between two CUDA events, over `reps` runs,
    each after `setup()` (if given; outside the events, for a kernel that
    works in place) and a read of `flush` (larger than the L2, so inputs
    come from device memory; a read leaves no dirty lines for `fn` to
    write back). All runs are queued behind a device-side sleep, so the
    host's time to launch `fn` is not in the events' interval."""
    import torch
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in events:
        if setup is not None:
            setup()
        flush.amax()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# The port's kernels in a profile, by source: the first symbol (a part of
# the kernel's name) that a device op's name contains. Older checkouts'
# kernels match too (`scripts/time_bfs.py` profiles them): their hub.cu
# kernel's name also contains "bottomup_", so it goes first.
KERNEL_SYMBOLS = (("hub.cu", "::hub_"), ("bottomup.cu", "::bottomup_"),
                  ("bottomup.cu", "::pull_kernel"),
                  ("bottomup.cu", "::pack_kernel"),
                  ("topdown.cu", "::topdown_"),
                  ("topdown.cu", "::push_kernel"),
                  ("frontier_fused.cu", "::frontier_fused_"),
                  ("frontier_fused.cu", "::fused_kernel"),
                  ("decode_attn.cu", "::decode_attn_"))


def kernel_sums(rows):
    """{source: {device_ms, calls}} of the port's kernels among profile
    rows (op, device ms, calls)."""
    sums = {}
    for op, ms, n in rows:
        for source, symbol in KERNEL_SYMBOLS:
            if symbol in op:
                acc = sums.setdefault(source, dict(device_ms=0.0, calls=0))
                acc["device_ms"] += ms
                acc["calls"] += n
                break
    return sums


# CUDA runtime calls that put one op on a stream (kernels, fills, copies)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync",
                "cudaMemcpyAsync")


def range_launches(events) -> dict:
    """{`ops` range name: the CUDA runtime launch calls made inside its
    ranges}, by host time: a kernel launched through ctypes is linked to no
    PyTorch op, so the range's own tree does not hold it, but its runtime
    call lies inside the range (one thread launches)."""
    import bisect
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    starts = sorted(e.time_range.start for e in host
                    if e.name.startswith(LAUNCH_CALLS))
    out = {}
    for e in host:           # the device's copy of a range is not counted
        if e.name.startswith("ops."):
            n = (bisect.bisect_left(starts, e.time_range.end)
                 - bisect.bisect_left(starts, e.time_range.start))
            out[e.name[4:]] = out.get(e.name[4:], 0) + n
    return out


def profile_search(search, top=10):
    """One more search (`search()`) under torch.profiler: device time by op
    (self time, ms), the summed device time and calls of each of the port's
    kernels by source (`kernel_sums`) and by `ops` wrapper (each wrapper
    call runs in a `record_function` range named after it: a range's
    device time is that of the kernels linked to it, its device ops the
    runtime launches inside it, `range_launches`), and the device's
    busy share of the search's wall time. Not part of the paths' launch
    counts (read before this runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in BFS_KERNELS if hasattr(ops, n)}

    def labelled(name):
        def fn(*args, **kw):
            with record_function(f"ops.{name}"):
                return saved[name](*args, **kw)
        return fn
    for n in saved:
        setattr(ops, n, labelled(n))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for n, f in saved.items():
        setattr(ops, n, f)
    rows, wrappers = [], {}
    for evt in prof.key_averages():
        if evt.key.startswith("ops."):   # a range, not a device op
            wrappers[evt.key[4:]] = dict(
                device_ms=getattr(evt, "device_time_total",
                                  getattr(evt, "cuda_time_total", 0)) / 1e3,
                calls=evt.count, device_ops=0)
            continue
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue                      # host ops; kernels are listed alone
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    for name, n in range_launches(prof.events()).items():
        if name in wrappers:
            wrappers[name]["device_ops"] = n
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / 1e3 / wall),
                kernels=kernel_sums(rows), wrappers=wrappers,
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
    if name == "topdown_push":
        deg, nbrs, rows, table, pcand, keep = args
        return deg[None], nbrs, rows, table[None], pcand[None], keep
    if name == "frontier_fused":
        flags, deg = args
        return flags[None], deg
    return args


def push_bound(args):
    """(bytes, ops, sector bytes) a push call (batch form) needs: the [B, R]
    degrees; the ids of each row up to its largest live degree and the
    ids of the live rows; one byte of `keep` per vertex those slots name;
    one visited byte per distinct (lane, vertex) of the live slots that
    `keep` lets through; a read and a write of pcand per distinct fresh
    (lane, vertex). The ops are the live (lane, slot) tests. The sector
    bytes count instead 32 bytes (a sector) for every visited gather and
    for every fresh slot's pcand."""
    import torch
    deg, nbrs, rows, table, pcand, keep = args
    b, r = deg.shape
    w = nbrs.shape[1]
    v = table.shape[1]
    live = deg.clamp(0, w).to(torch.int64)                   # [B, R]
    need = live.max(dim=0).values                            # [R]
    cols = torch.arange(w, device=deg.device)
    safe = nbrs.clamp(0, v - 1).to(torch.int64)
    head = 4 * b * r + 4 * int(need.sum()) + 4 * int((need > 0).sum())
    kept = None
    if keep is not None:
        named = safe[cols[None] < need[:, None]]
        head += touched_bytes(keep[None], named)
        kept = keep[safe] != 0
    gathers, fresh = [], []
    for lane in range(b):
        m = cols[None] < live[lane][:, None]                 # [R, W]
        if kept is not None:
            m &= kept
        gathers.append(lane * v + safe[m])
        fresh.append(lane * v + safe[m & (table[lane][safe] == 0)])
    gathers, fresh = torch.cat(gathers), torch.cat(fresh)
    nbytes = (head + touched_bytes(table, gathers)
              + 8 * touched_bytes(pcand, fresh))
    sector = head + 32 * (gathers.numel() + fresh.numel())
    return nbytes, int(live.sum()), sector


def frontier_bound(flags, deg, packed=False):
    """(bytes, ops) a packing call needs: every flag byte; of the degrees,
    each 32-byte sector (at its place in memory) that holds the degree of
    a flag set in some lane; the bitmap if `packed`; nf and mf. One test a
    flag."""
    import torch
    b, v = flags.shape
    first = deg.data_ptr() % 32 // 4               # deg[0]'s slot in a sector
    on = torch.cat([torch.zeros(first, dtype=torch.bool, device=deg.device),
                    (flags != 0).any(dim=0)])
    on = torch.cat([on, on.new_zeros((-on.numel()) % 8)])
    sectors = int(on.view(-1, 8).any(dim=1).sum())
    out = b * ((v + 31) // 32) * 4 if packed else 0
    return b * v + 32 * sectors + out + 8 * b, b * v


def bound(name, args, packed=False):
    """(bytes, ops) this call needs: each input byte it must read once,
    each output byte written once; data-dependent reads counted for these
    inputs (slots up to the first hit, live slots only; for a packing
    kernel the degree sectors its flags name, and the bitmap with
    `packed`)."""
    import torch
    args = as_batch(name, args)
    if name in PUSH:
        return push_bound(args)[:2]
    if name.startswith("frontier_fused"):
        return frontier_bound(*args, packed=packed)
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


def timed_call(picked, name):
    """(level, args) of the captured call a kernel is timed on: of the
    calls `pick_calls` chose for it, the one with the largest tile (for a
    packing kernel, the most flags); hub_bottomup on the lane of the timed
    hub_bottomup_batch call with the most live rows; a fresh entry on its
    push's call (deg, nbrs, visited), where the checkout has the push."""
    src_name = "hub_bottomup_batch" if name == "hub_bottomup" else name
    if FRESH_OF.get(name) in picked:
        src_name = FRESH_OF[name]
    _, lvl, _, cargs = max(
        picked[src_name], key=lambda c: c[3][1].numel()
        if not src_name.startswith("frontier_fused")
        else int(c[3][0].sum()))
    if name == "hub_bottomup":
        deg, nbrs, fr = cargs
        lane = int((deg != 0).sum(dim=1).argmax())
        cargs = (deg[lane], nbrs, fr[lane])
    if src_name != name and name in FRESH_OF:
        cargs = (cargs[0], cargs[1], cargs[3])
    return lvl, cargs


def launch_plan(name):
    """The plan of a pull or packing kernel's last launch (empty for the
    others, and for a tree whose kernels record none)."""
    from repro_torch.kernels import bottomup, frontier_fused
    if name.startswith("frontier_fused"):
        return dict(getattr(frontier_fused, "LAST_PLAN", {}))
    if name.removesuffix("_batch") not in ("bottomup", "hub_bottomup"):
        return {}
    return dict(getattr(bottomup, "LAST_PLAN", {}))


def kernel_fn(name, args, packed=False):
    """A call of kernel `name`'s launcher alone on a captured call's inputs,
    as `ops` hands them over (a lane axis of 1 for a single-lane kernel; a
    packing kernel without the bitmap, as the paths call it, unless
    `packed`)."""
    from repro_torch.kernels import bottomup, frontier_fused, hub, topdown
    if name == "topdown":
        deg, nbrs, table = args
        dc = deg.contiguous()
        return lambda: topdown.topdown_cuda(dc, nbrs, table)
    if name.startswith("frontier_fused"):
        flags, deg = as_batch(name, args)
        return lambda: frontier_fused.frontier_fused_batch_cuda(
            flags, deg, packed=packed)
    deg, nbrs, table = as_batch(name, args)
    dc = deg.contiguous()
    launch = {"bottomup": bottomup.bottomup_batch_cuda,
              "topdown": topdown.topdown_batch_cuda,
              "hub_bottomup": hub.hub_bottomup_batch_cuda}[
                  name.removesuffix("_batch")]
    return lambda: launch(dc, nbrs, table)


def parent_route(deg, nbrs, rows, visited, pcand, keep):
    """The top-down route of the checkouts before the push, on one bucket:
    the fresh entry's kernel, the `keep` mask of the destinations, `where`,
    then `scatter_reduce_("amin")` into `pcand`, all on the card."""
    import torch
    from repro_torch.kernels import topdown
    b, v = visited.shape
    fresh = topdown.topdown_batch_cuda(deg, nbrs, visited)
    dst = nbrs.clamp(0, v - 1).reshape(-1).to(torch.int64)
    if keep is not None:
        fresh = fresh & keep[dst].reshape(nbrs.shape)[None]
    src = torch.where(fresh != 0, rows[None, :, None], INT_MAX)
    pcand.scatter_reduce_(1, dst[None].expand(b, -1), src.reshape(b, -1),
                          "amin", include_self=True)


def time_kernel(name, args, reps, flush):
    """(kernel ms, plain ms, route ms) for one captured call: the launcher
    alone (`kernel_fn`), the plain version on the call's own inputs (a
    packing kernel's both without the bitmap, as the paths call them); for
    the push, each from a `pcand` of INT_MAX (refilled before every run,
    outside the timing), and the parent's route (`parent_route`) on the
    same call, which must give the push's bits; None for the others."""
    import torch
    plain = plain_fn(name)
    kw = dict(packed=False) if name.startswith("frontier_fused") else {}
    if name not in PUSH:
        return (time_ms(kernel_fn(name, args), reps, flush),
                time_ms(lambda: plain(*args, **kw), reps, flush), None)
    from repro_torch.kernels import topdown
    deg, nbrs, rows, vis, pc, keep = as_batch(name, args)
    deg = deg.contiguous()
    work = torch.empty_like(pc)

    def setup():
        work.fill_(INT_MAX)
    out = []
    for fn in (topdown.topdown_push_cuda, topdown.topdown_push_batch_plain,
               parent_route):
        out.append(time_ms(lambda: fn(deg, nbrs, rows, vis, work, keep),
                           reps, flush, setup))
        if fn is topdown.topdown_push_cuda:
            pushed = work.clone()
        else:
            assert equal(work, pushed), f"{fn.__name__} != the push"
    return tuple(out)


def frontier_times(name, cargs, flagged, flush, floor_ms):
    """A packing kernel's extra numbers: on phase 5's call (`cargs`) the
    kernel with the bitmap and its bound; on the call with the most set
    flags (`flagged`: level, args) the kernel with and without the bitmap,
    the plain version without, the bounds and the launch plan; the launch
    floor beside them."""
    from repro_torch.kernels import frontier_fused
    plain = plain_fn(name)
    out = dict(ms_packed=time_ms(kernel_fn(name, cargs, packed=True),
                                 TIMING_REPS, flush),
               bound_ms_packed=bound(name, cargs, packed=True)[0]
               / HBM_BYTES_PER_S * 1e3,
               flags_set=int((cargs[0] != 0).sum()), floor_ms=floor_ms)
    lvl, fargs = flagged
    most = dict(level=lvl, flags_set=int((fargs[0] != 0).sum()),
                shapes=[list(a.shape) for a in fargs])
    for key, packed in (("ms", False), ("ms_packed", True)):
        most[key] = time_ms(kernel_fn(name, fargs, packed=packed),
                            TIMING_REPS, flush)
        most["plan"] = dict(frontier_fused.LAST_PLAN)
        nbytes, nops = bound(name, fargs, packed=packed)
        most["bound_ms" + key[2:]] = max(
            nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S) * 1e3
        most["bytes" + key[2:]] = nbytes
    most["plain_ms"] = time_ms(lambda: plain(*fargs, packed=False),
                               TIMING_REPS, flush)
    out["most_flags"] = most
    return out


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
    """Phases 4, 2b and 5: the BFS paths on Graph500 RMAT at --scale.
    Returns the kernels line's entries of the ten BFS kernel entries and
    the graph (host arrays only)."""
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
    fresh_of_push = {push: fresh for fresh, push in FRESH_OF.items()}
    flagged = {n: flag_call(calls, n) for n in BFS_KERNELS
               if n.startswith("frontier_fused")}
    for name, mine in picked.items():
        for _, _, _, cargs in mine + ([(None, None, None, flagged[name][1])]
                                      if name in flagged else []):
            if name in flagged:
                for packed in (True, False):
                    kernel_vs_plain(name, cargs, errs, packed=packed)
                n_checked += 2
                continue
            if name not in PUSH:
                kernel_vs_plain(name, cargs, errs)
                n_checked += 1
                continue
            # The captured pcand is the level's final one (the push
            # updated it in place after the capture): from it, and from
            # INT_MAX as the level's first bucket saw it.
            deg, nbrs, rows, vis, pcand, keep = cargs
            for start in (torch.full_like(pcand, INT_MAX), pcand):
                kernel_vs_plain(name, (deg, nbrs, rows, vis, start, keep),
                                errs)
            kernel_vs_plain(fresh_of_push[name], (deg, nbrs, vis), errs)
            n_checked += 3
    # hub_bottomup: lane 0 of every checked hub_bottomup_batch call
    for _, _, _, (deg, nbrs, fr) in picked["hub_bottomup_batch"]:
        kernel_vs_plain("hub_bottomup", (deg[0], nbrs, fr[0]), errs)
    torch.cuda.synchronize()
    log(f"phase 2b: {n_checked} captured calls bitwise equal, at levels "
        f"{ {n: c[0][1] for n, c in picked.items()} }")

    # 5. kernel times at the captured full-size shapes
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), TIMING_REPS, flush)
    record["launch_floor_ms"] = floor_ms
    log(f"phase 5: launch floor (torch.cuda._sleep(0), a one-thread kernel "
        f"that returns at once, timed as the kernels are): {floor_ms:.4f} ms")
    entries = []
    for name, (source, replaces) in BFS_KERNELS.items():
        lvl, cargs = timed_call(picked, name)
        ms, plain_ms, route_ms = time_kernel(name, cargs, TIMING_REPS,
                                             flush)
        plan = launch_plan(name)
        nbytes, nops = bound(name, cargs)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        extra = ""
        if name == "hub_bottomup":
            entry["note"] = HUB_BOTTOMUP_NOTE
        if name in FRESH_OF:
            entry["note"] = FRESH_NOTE
        if name in PUSH:
            sector = push_bound(as_batch(name, cargs))[2]
            entry.update(parent_route_ms=route_ms,
                         sector_bound_ms=sector / HBM_BYTES_PER_S * 1e3)
            extra = (f"; the parent's route {route_ms:.4f} ms; bound with a "
                     f"sector a gather {entry['sector_bound_ms']:.4f} ms")
        if name in flagged:
            entry.update(frontier_times(name, cargs, flagged[name], flush,
                                        floor_ms))
            extra = (f"; with the bitmap {entry['ms_packed']:.4f} ms (bound "
                     f"{entry['bound_ms_packed']:.4f}); {entry['flags_set']} "
                     f"flags set; at the call with the most flags ("
                     f"{entry['most_flags']['flags_set']}, level "
                     f"{entry['most_flags']['level']}) "
                     f"{entry['most_flags']['ms']:.4f} ms, with the bitmap "
                     f"{entry['most_flags']['ms_packed']:.4f}, plain "
                     f"{entry['most_flags']['plain_ms']:.4f}, bound "
                     f"{entry['most_flags']['bound_ms']:.4f} (with the bitmap "
                     f"{entry['most_flags']['bound_ms_packed']:.4f}); launch "
                     f"floor {floor_ms:.4f}; plan "
                     f"{entry['most_flags']['plan']}")
        entries.append(entry)
        record.setdefault("timed_calls", []).append(dict(
            name=name, level=lvl,
            shapes=[None if a is None else list(a.shape) for a in cargs],
            bytes=nbytes, ops=nops, plan=plan,
            live_rows=int((cargs[0] != 0).any(dim=0).sum())
            if cargs[0].dim() == 2 else int((cargs[0] != 0).sum())))
        log(f"phase 5: {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms by {entry['bound_by']}{extra}) "
            f"at {[None if a is None else list(a.shape) for a in cargs]}"
            + (f", plan {plan}" if plan else ""))
    record["kernels"] = entries
    record["profiles"] = {}
    for label, fn in (
            ("unsplit batch of 8", lambda: engine.bfs(roots[:8])),
            ("split batch of 8", lambda: engine.bfs(roots[:8], split_cfg)),
            ("stepper, 1 root",
             lambda: engine.bfs(roots[:1], backend="stepper"))):
        prof = profile_search(fn)
        record["profiles"][label] = prof
        for n, w in prof["wrappers"].items():
            if n in flagged:
                assert w["device_ops"] <= w["calls"], \
                    f"{label}: {n} launched {w['device_ops']} device ops in " \
                    f"{w['calls']} calls"
        log(f"phase 5: profiled {label}: wall {prof['wall_s']:.3f} s, "
            f"device busy {prof['device_busy_ms']:.1f} ms (idle share "
            f"{prof['idle_share']:.3f}); the port's kernels: "
            + ", ".join(f"{src} {k['device_ms']:.3f} ms in {k['calls']} calls"
                        for src, k in sorted(prof["kernels"].items()))
            + "; by wrapper: "
            + ", ".join(f"{n} {k['device_ms']:.3f} ms in {k['calls']} calls, "
                        f"{k['device_ops']} device ops"
                        for n, k in sorted(prof["wrappers"].items()))
            + "; top device time:")
        for row in prof["top"]:
            log(f"    {row['device_ms']:10.2f} ms {row['calls']:6d}x "
                f"{row['op']}")
    return entries, g


# -------------------------------------------------------------- sharded --

SHARDED_PARTS = (2, 4)            # phase 5s parity: ranks at PARITY_SCALE
SHARDED_FULL = (4, "specialized")  # phase 5s at full size: ranks, strategy
SHARDED_KERNELS = ("bottomup", "topdown_push", "frontier_fused")
SHARDED_NOTE = ("P ranks time-share one H100 and exchange through gloo "
                "(host memory); not a multi-GPU figure")
RANK_TIMEOUT = 900                # seconds a spawn of ranks may take


def save_graph(g, path):
    np.savez(path, v=g.num_vertices, indptr=g.indptr, indices=g.indices,
             degrees=g.degrees)


def load_graph(path):
    from repro_torch.interop import graph_from_arrays
    with np.load(path) as z:
        return graph_from_arrays(int(z["v"]), z["indptr"], z["indices"],
                                 z["degrees"])


def sharded_cases():
    """(label, strategy, HybridConfig): each strategy at the defaults, then
    the bitmap exchange, the global coordinator and beamer."""
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.core.hybrid_bfs import HybridConfig
    cases = [(s, s, HybridConfig()) for s in ("random", "hub0", "specialized")]
    return cases + [
        ("specialized bitmap", "specialized", HybridConfig(exchange="bitmap")),
        ("specialized global", "specialized",
         HybridConfig(coordinator="global")),
        ("specialized beamer", "specialized",
         HybridConfig(bfs=BFSConfig(heuristic="beamer")))]


def sharded_parity_rank(rank, group, device, graph_path, roots):
    """Phase 5s parity on one rank: every case through `Engine.bfs` as
    `sharded` and as `stepper`, once on a CUDA session (the kernels) and
    once on a CPU session (the plain versions), over the same group;
    trees and rows must be equal. Rank 0 validates the default case's
    trees with `ref.validate_parents`."""
    import torch.distributed as dist
    from repro_torch.core import ref
    from repro_torch.engine import Engine
    g = load_graph(graph_path)
    n = dist.get_world_size(group)
    gpu, cpu = Engine(g, device=device), Engine(g, device="cpu")
    out = []
    for label, strategy, hcfg in sharded_cases():
        for backend in ("sharded", "stepper"):
            what = f"P={n} {label} {backend}"
            a = gpu.bfs(roots, hcfg, backend=backend, n_parts=n,
                        strategy=strategy)
            b = cpu.bfs(roots, hcfg, backend=backend, n_parts=n,
                        strategy=strategy)
            same_trees(a, b, what)
            assert (a.backend, a.n_parts) == (backend, n), what
            if backend == "stepper":
                assert stepper_rows(a) == stepper_rows(b), f"{what}: rows"
                out.append(dict(case=what, directions=[
                    r[1] for r in stepper_rows(a)[0]]))
            if rank == 0 and label == "specialized":
                for i, r in enumerate(roots):
                    ref.validate_parents(g, int(r), b.parent[i], b.level[i])
    return out


def sharded_full_rank(rank, group, device, graph_path, roots):
    """Phase 5s at full size on one rank: `Engine.bfs` over the partitioned
    graph (4 roots `sharded` in Graph500 mode, 2 `stepper` with the psum
    exchange, 1 with the bitmap), launch counts zeroed just before and read
    just after. Rank 0 also holds the trees against the Graph500 check,
    every sharded kernel's captured calls (the level with the most live
    rows) against their plain versions, and times them."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.hybrid_bfs import HybridConfig
    from repro_torch.engine import Engine
    from repro_torch.engine.level_loop import fence
    from repro_torch.kernels import ops
    n, strategy = SHARDED_FULL
    assert dist.get_world_size(group) == n
    t0 = time.perf_counter()
    g = load_graph(graph_path)
    eng = Engine(g, device=device, default_strategy=strategy)
    plan, pg = eng.session.partitioned(n)
    ell = eng.session.hybrid_ell(n)
    fence(device)
    out = dict(rank=rank, setup_s=time.perf_counter() - t0,
               backend=str(dist.get_backend(group)), v_pad=plan.v_pad,
               hub_count=plan.hub_count, local_rows=pg.num_local_rows,
               buckets=[list(b.nbrs.shape) for b in ell],
               padding_rows=sum(int((b.rows == plan.v_pad).sum())
                                for b in ell))
    if rank == 0:
        calls, path, restore = install_capture()
        path[0] = "sharded"
    dist.barrier(group)
    ops.reset_launches()
    t1 = time.perf_counter()
    sharded = eng.bfs(roots[:4], backend="sharded", n_parts=n,
                      batched=False)
    stepper = eng.bfs(roots[4:6], backend="stepper", n_parts=n)
    bitmap = eng.bfs(roots[6:7], HybridConfig(exchange="bitmap"),
                     backend="stepper", n_parts=n)
    out["wall_s"] = time.perf_counter() - t1
    out["launches"] = {k: c for k, c in ops.LAUNCHES.items() if c}
    for k in SHARDED_KERNELS:
        assert ops.LAUNCHES[k] > 0, f"rank {rank}: {k} never launched"
    out.update(
        per_root_s=sharded.per_root_seconds.tolist(),
        teps=sharded.teps_per_root.tolist(),
        levels=[int(x) for x in sharded.num_levels],
        stepper_per_root_s=stepper.per_root_seconds.tolist(),
        bitmap_per_root_s=bitmap.per_root_seconds.tolist(),
        stepper_teps=stepper.teps_per_root.tolist(),
        psum_rows=[[dict(level=r["level"], direction=r["direction"],
                         frontier_size=r["frontier_size"],
                         compute_s=r["compute_s"], exchange_s=r["exchange_s"])
                    for r in rows] for rows in stepper.per_level_stats],
        bitmap_rows=[[dict(level=r["level"], direction=r["direction"],
                           frontier_size=r["frontier_size"],
                           compute_s=r["compute_s"],
                           exchange_s=r["exchange_s"])
                      for r in rows] for rows in bitmap.per_level_stats],
        timings=stepper.timings + bitmap.timings)
    if rank == 0:
        restore()
        check = Graph500Check(g, device)
        out["trees"] = trees_ok(check, sharded, stepper, bitmap)
        del check
        out.update(sharded_kernel_checks(calls, device))
        del calls
    dist.barrier(group)
    return out


def sharded_kernel_checks(calls, device):
    """Rank 0's captured sharded calls: each kernel of the level with the
    most live rows against its plain version, bitwise (the push from
    INT_MAX and from the level's final `pcand`; the packing kernel with the
    bitmap and without, there and at the call with the most set flags),
    then timed on its largest call beside its plain version and bound."""
    import torch
    picked = {k: v for k, v in pick_calls(calls).items()
              if k in SHARDED_KERNELS}
    flagged = flag_call(calls, "frontier_fused")[1]
    errs = {k: 0 for k in SHARDED_KERNELS}
    n_checked = 0
    for name, mine in picked.items():
        for _, _, _, cargs in mine:
            if name == "frontier_fused":
                for args in (cargs, flagged):
                    for packed in (True, False):
                        kernel_vs_plain(name, args, errs, packed=packed)
                        n_checked += 1
            elif name in PUSH:
                deg, nbrs, rows, vis, pcand, keep = cargs
                for start in (torch.full_like(pcand, INT_MAX), pcand):
                    kernel_vs_plain(name, (deg, nbrs, rows, vis, start, keep),
                                    errs)
                    n_checked += 1
            else:
                kernel_vs_plain(name, cargs, errs)
                n_checked += 1
    torch.cuda.synchronize(device)
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=device)
    times = {}
    for name in SHARDED_KERNELS:
        lvl, cargs = timed_call(picked, name)
        ms, plain_ms, _ = time_kernel(name, cargs, TIMING_REPS, flush)
        nbytes, nops = bound(name, cargs)
        times[name] = dict(
            level=lvl, ms=ms, plain_ms=plain_ms,
            bound_ms=max(nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S)
            * 1e3, shapes=[None if a is None else list(a.shape)
                           for a in cargs])
    return dict(checked=n_checked, errs=errs, kernel_times=times,
                levels_checked={k: v[0][1] for k, v in picked.items()})


def sharded_phase(args, g16, g22, rng, record, entries):
    """Phase 5s: the partitioned BSP search on gloo ranks that share the
    card. Parity at PARITY_SCALE (P = 2 and 4, CUDA ranks against CPU
    ranks), then the full-size run (P = 4, specialized); the sharded
    kernels' counts, errors and times join their `entries`."""
    import tempfile
    from repro_torch.parallel import ranks
    record["sharded"] = rec = dict(note=SHARDED_NOTE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        path16 = os.path.join(tmp, "parity.npz")
        save_graph(g16, path16)
        roots16 = rng.choice(np.flatnonzero(g16.degrees > 0), 2,
                             replace=False)
        for p in SHARDED_PARTS:
            t0 = time.perf_counter()
            out = ranks.run_ranks(sharded_parity_rank, p, tmp,
                                  args=(path16, roots16), backend="gloo",
                                  timeout=RANK_TIMEOUT)
            rec[f"parity_p{p}_s"] = time.perf_counter() - t0
            rec[f"parity_p{p}"] = out[0]
            log(f"phase 5s: scale-{PARITY_SCALE} parity, P = {p} gloo ranks "
                f"on one card: {len(sharded_cases())} cases x (sharded, "
                f"stepper) equal on cuda and cpu, trees and rows, every rank "
                f"({rec[f'parity_p{p}_s']:.1f} s); stepper directions "
                + "; ".join(f"{c['case']}: {''.join(d[0] for d in c['directions'])}"
                            for c in out[0][:3]))
        path22 = os.path.join(tmp, "full.npz")
        t0 = time.perf_counter()
        save_graph(g22, path22)
        rec["save_s"] = time.perf_counter() - t0
        roots22 = rng.choice(np.flatnonzero(g22.degrees > 0), 7,
                             replace=False)
        n, strategy = SHARDED_FULL
        t0 = time.perf_counter()
        outs = ranks.run_ranks(sharded_full_rank, n, tmp,
                               args=(path22, roots22), backend="gloo",
                               timeout=RANK_TIMEOUT)
        rec["full_s"] = time.perf_counter() - t0
    r0 = outs[0]
    rec["full"] = outs
    v_pad = r0["v_pad"]
    wire = dict(psum=4 * v_pad, bitmap=4 * ((v_pad + 31) // 32))
    rec["wire_bytes_per_level"] = wire
    log(f"phase 5s: RMAT scale {args.scale}, P = {n} "
        f"{strategy}, {r0['backend']} ranks: {SHARDED_NOTE}. v_pad {v_pad}, "
        f"{r0['hub_count']} delegated hubs, {r0['local_rows']} rows a rank, "
        f"setup (load, partition, tiles) {max(o['setup_s'] for o in outs):.1f}"
        f" s, spawn to exit {rec['full_s']:.1f} s; rank 0's buckets "
        f"{r0['buckets']} ({r0['padding_rows']} padding rows)")
    log(f"  {r0['trees']} trees pass the Graph500 check; wire a level: psum "
        f"{wire['psum']} bytes, bitmap {wire['bitmap']} bytes a rank")
    for i, (s, t) in enumerate(zip(r0["per_root_s"], r0["teps"])):
        log(f"  sharded root {i}: {s:.4f} s, {t / 1e9:.4f} GTEPS, "
            f"{r0['levels'][i]} levels")
    for label, key in (("psum", "psum_rows"), ("bitmap", "bitmap_rows")):
        for i, rows in enumerate(r0[key]):
            log(f"  stepper {label} root {i} (compute_s / exchange_s a "
                f"level, ms): " + ", ".join(
                    f"{r['direction']} {r['compute_s'] * 1e3:.2f}/"
                    f"{r['exchange_s'] * 1e3:.2f}" for r in rows))
    log("  agg_s (the min all-reduce, the copy and the mapping back): "
        + ", ".join(f"{t['agg_s']:.4f}" for t in r0["timings"]))
    log(f"  launches by rank: "
        + "; ".join(f"rank {o['rank']} {o['launches']}" for o in outs))
    log(f"  rank 0: {r0['checked']} captured sharded calls bitwise equal to "
        f"the plain versions at levels {r0['levels_checked']}; at their "
        f"largest call: " + ", ".join(
            f"{k} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f}) at {t['shapes']}"
            for k, t in r0["kernel_times"].items()))
    for entry in entries:
        name = entry["name"]
        if name not in SHARDED_KERNELS:
            continue
        per_rank = [o["launches"].get(name, 0) for o in outs]
        t = r0["kernel_times"][name]
        entry.update(
            launches=entry["launches"] + sum(per_rank),
            sharded_launches=per_rank,
            max_abs_err=max(entry["max_abs_err"], r0["errs"][name]),
            sharded_ms=t["ms"], sharded_plain_ms=t["plain_ms"],
            sharded_bound_ms=t["bound_ms"])


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
    n_cases, n_ff = phase_kernels(
        rng, np.random.default_rng([args.seed, 1]),
        np.random.default_rng([args.seed, 5]), dev, errs)
    log(f"phase 2: {n_cases} random cases per kernel, {len(HUB_CASES)} more "
        f"wide ones per hub kernel and push, {len(SKEWED_CASES)} skewed ones "
        f"per pull kernel and push, the push with keep off and on and on "
        f"{CONTENTION[1]} rows into {CONTENTION[4]} vertices, {n_ff} more "
        f"per packing kernel with the bitmap and without (B up to 40, V not "
        f"a multiple of 32, rows starting one byte in, all flags set at V = "
        f"{FRONTIER_WIDE}, nf/mf at the int32 limit and past it), bitwise "
        f"equal ({time.perf_counter() - t0:.1f} s)")
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
    g16 = phase_parity(PARITY_SCALE, rng)
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
    # return, before the ranks and the serving path need the card's memory)
    entries, g22 = bfs_paths(args, rng, dev, record, errs)
    gc.collect()
    torch.cuda.empty_cache()

    # 5s. the partitioned BSP search on gloo ranks sharing the card
    t0 = time.perf_counter()
    sharded_phase(args, g16, g22, rng, record, entries)
    record["sharded_s"] = time.perf_counter() - t0
    log(f"phase 5s: {record['sharded_s']:.1f} s")
    del g16, g22

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

"""Time the BFS paths of one or more checkouts of this repo on one GPU, in
turns, on Graph500 RMAT: each run's seconds, TEPS and per-level seconds,
the top-down route on one captured call, the packing kernels on two, and a
profile of a search on each path.

    python3 scripts/time_bfs.py build/parent . . build/parent

Each RUN is a checkout's root. The graph (--scale, --seed) is made
once, by this checkout, and saved under `build/time_bfs/`; each run is a
process of its own with that checkout's `src` first on the path, which
loads it and, with `chip_smoke.py`'s code from this checkout:

1. drives the five BFS runs of `chip_smoke.py` phase 4 (unsplit and hub
   split, a batch of 8 roots and 4 in Graph500 mode; the stepper on 2
   roots), recording each run's wall seconds (first query on its batch
   bucket or plan included), the result's seconds and TEPS, its per-level
   rows (level, direction, seconds), the level driver's own timings of
   each search it ran (init_s, agg_s: the result's copy to the host,
   driver_overhead_s) and launches, and capturing every kernel call;
2. times the top-down route on the call with the most live rows of the
   unsplit batch of 8 and of the stepper (`chip_smoke.pick_calls` and
   `timed_call` on that run's calls): the route of the checkouts before
   the push (`chip_smoke.parent_route`: the fresh entry's kernel, `where`
   and `scatter_reduce_`) in every checkout, and the push kernel where
   the checkout has it, each from a `pcand` of INT_MAX (`time_ms`: median
   of 20, cold L2, queued behind a device sleep); a digest of the call's
   (deg, nbrs, visited) shows that every run timed the same call;
3. times the packing kernels (`frontier_fused_batch`, `frontier_fused`)
   on `chip_smoke.py` phase 5's call (`pick_calls`, `timed_call`) and on
   the call with the most set flags (`flag_call`), with a digest of the
   flags and degrees: the launcher as `ops` calls it, the launch floor
   (`torch.cuda._sleep(0)`, a one-thread kernel that returns at once), the
   bounds with the bitmap and without (`chip_smoke.frontier_bound`); in a
   checkout whose launcher zero-fills nf and mf (before the `packed`
   keyword), also the kernel launch alone (nf and mf zeroed outside the
   timing) and the two fills alone; in one with the keyword, the launcher
   with the bitmap and without;
4. profiles one search on each path (unsplit batch of 8, split batch of
   8, stepper on 1 root): wall, device busy, idle share, the summed
   device time and calls of each of the port's kernels by source and by
   `ops` wrapper (with the device ops launched in each wrapper's calls),
   and the top device ops.

One JSON line per run. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (run label, push entry, fresh entry): the calls whose route is timed
ROUTE_CALLS = (("unsplit batch of 8", "topdown_push_batch", "topdown_batch"),
               ("stepper, 2 roots", "topdown_push", "topdown"))


def digest(args) -> int:
    """A cheap fingerprint of a call's tensors (sums of their int64 values,
    position-weighted)."""
    import torch
    h = 0
    for a in args:
        x = a.reshape(-1).to(torch.int64)
        w = torch.arange(1, x.numel() + 1, device=x.device) % 1009
        h = (h * 1000003 + int((x * w).sum())) % (1 << 61)
    return h


def level_rows(res):
    """Per-level (level, direction, seconds): the batch rows, or one list
    per root on the stepper, or none (Graph500 mode on the fused path)."""
    def rows(stats):
        return [(r["level"], r["direction"], r["seconds"]) for r in stats]
    if res.batch_level_stats:
        return rows(res.batch_level_stats)
    return [rows(s) for s in res.per_level_stats or []]


def route_times(cs, calls, ell, flush) -> dict:
    """The top-down route on each of ROUTE_CALLS' timed calls."""
    import torch
    from repro_torch.kernels import topdown
    rows_of = {id(t.nbrs): t.rows for t in ell}
    out = {}
    for label, push, fresh in ROUTE_CALLS:
        picked = cs.pick_calls([c for c in calls if c[0] == label])
        name = push if push in picked else fresh
        lvl, cargs = cs.timed_call(picked, name)
        if name == push:
            deg, nbrs, rows, vis, _, keep = cs.as_batch(push, cargs)
        else:
            deg, nbrs, vis = cs.as_batch(fresh, cargs)
            rows, keep = rows_of[id(nbrs)], None
        assert keep is None, "the unsplit path and the stepper keep all"
        deg = deg.contiguous()
        work = torch.empty((deg.shape[0], vis.shape[1]), dtype=torch.int32,
                           device=deg.device)

        def setup():
            work.fill_(cs.INT_MAX)
        row = dict(level=lvl, shapes=[list(a.shape) for a in (deg, nbrs)],
                   live_rows=int((deg != 0).any(dim=0).sum()),
                   digest=digest((deg, nbrs, vis)),
                   route_ms=cs.time_ms(
                       lambda: cs.parent_route(deg, nbrs, rows, vis, work,
                                               None),
                       cs.TIMING_REPS, flush, setup))
        routed = work.clone()
        if name == push:
            row["push_ms"] = cs.time_ms(
                lambda: topdown.topdown_push_cuda(deg, nbrs, rows, vis, work),
                cs.TIMING_REPS, flush, setup)
            assert cs.equal(work, routed), f"{label}: push != route"
        out[label] = row
    return out


def frontier_times(cs, calls, flush) -> dict:
    """The packing kernels of this checkout on two captured calls each (see
    the module's docstring, item 3)."""
    import inspect
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import frontier_fused as ff
    keyword = "packed" in inspect.signature(
        ff.frontier_fused_batch_cuda).parameters

    def t(fn, setup=None):
        return cs.time_ms(fn, cs.TIMING_REPS, flush, setup)
    out = dict(floor_ms=t(lambda: torch.cuda._sleep(0)))
    picked = cs.pick_calls(calls)
    for name in ("frontier_fused_batch", "frontier_fused"):
        for which, (lvl, cargs) in (
                ("phase 5", cs.timed_call(picked, name)),
                ("most flags", cs.flag_call(calls, name))):
            flags, deg = cs.as_batch(name, cargs)
            b, v = flags.shape
            dev = flags.device
            row = dict(level=lvl, shape=[b, v],
                       flags_set=int((flags != 0).sum()),
                       digest=digest((flags, deg)),
                       bound_ms=cs.frontier_bound(flags, deg)[0]
                       / cs.HBM_BYTES_PER_S * 1e3,
                       bound_ms_packed=cs.frontier_bound(
                           flags, deg, packed=True)[0]
                       / cs.HBM_BYTES_PER_S * 1e3)
            if keyword:
                for key, packed in (("launcher_ms", True),
                                    ("launcher_nopack_ms", False)):
                    row[key] = t(lambda: ff.frontier_fused_batch_cuda(
                        flags, deg, packed=packed))
            else:
                fp, dp = ops.pad_words(flags), ops.pad_words(deg)
                row["launcher_ms"] = t(
                    lambda: ff.frontier_fused_batch_cuda(fp, dp))
                words = torch.empty((b, fp.shape[1] // 32),
                                    dtype=torch.uint32, device=dev)
                nf = torch.empty(b, dtype=torch.int32, device=dev)
                mf = torch.empty(b, dtype=torch.int32, device=dev)
                stream = torch.cuda.current_stream(dev).cuda_stream

                def zero():
                    nf.zero_()
                    mf.zero_()
                row["kernel_ms"] = t(lambda: _build.launch(
                    "frontier_fused", fp.data_ptr(), dp.data_ptr(),
                    words.data_ptr(), nf.data_ptr(), mf.data_ptr(), b,
                    fp.shape[1], device=dev.index, stream=stream), zero)
                row["fills_ms"] = t(lambda: (
                    torch.zeros(b, dtype=torch.int32, device=dev),
                    torch.zeros(b, dtype=torch.int32, device=dev)))
            out[f"{name} @ {which}"] = row
    return out


def child(tree: str, graph: str, seed: int) -> None:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.core.graph import Graph
    from repro_torch.engine import Engine, level_loop
    from repro_torch.kernels import _build, ops
    _build.build_all()
    z = np.load(graph)
    g = Graph(int(z["v"]), z["indptr"], z["indices"], z["degrees"])
    dev = torch.device("cuda", 0)
    engine = Engine(g)
    engine.session.device_graph()
    ell = engine.session.ell_tiles()
    roots = np.random.default_rng(seed).choice(np.flatnonzero(g.degrees > 0),
                                               12, replace=False)
    split = BFSConfig(hub_split=True)
    row = dict(tree=tree, card=torch.cuda.get_device_name(0), runs={})
    driver = []
    real_run = level_loop.LevelDriver.run

    def run(self, *a, **k):
        out = real_run(self, *a, **k)
        driver.append(out[3])
        return out
    level_loop.LevelDriver.run = run
    calls, path, restore = cs.install_capture()
    for label, fn, teps in (
            ("unsplit batch of 8", lambda: engine.bfs(roots[:8]), "teps"),
            ("unsplit Graph500 mode, 4 roots",
             lambda: engine.bfs(roots[8:], batched=False), "teps_hmean"),
            ("split batch of 8", lambda: engine.bfs(roots[:8], split),
             "teps"),
            ("split Graph500 mode, 4 roots",
             lambda: engine.bfs(roots[8:], split, batched=False),
             "teps_hmean"),
            ("stepper, 2 roots",
             lambda: engine.bfs(roots[:2], backend="stepper"), "teps_hmean")):
        path[0] = label
        ops.reset_launches()
        driver.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        row["runs"][label] = dict(
            wall_s=time.perf_counter() - t, seconds=res.seconds,
            per_root_seconds=res.per_root_seconds.tolist(),
            teps=float(getattr(res, teps)), levels=level_rows(res),
            driver=list(driver),
            launches={k: c for k, c in ops.LAUNCHES.items() if c})
    restore()
    level_loop.LevelDriver.run = real_run
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    row["route"] = route_times(cs, calls, ell, flush)
    row["frontier"] = frontier_times(cs, calls, flush)
    del flush, calls
    row["profiles"] = {}
    for label, fn in (
            ("unsplit batch of 8", lambda: engine.bfs(roots[:8])),
            ("split batch of 8", lambda: engine.bfs(roots[:8], split)),
            ("stepper, 1 root",
             lambda: engine.bfs(roots[:1], backend="stepper"))):
        prof = cs.profile_search(fn)
        row["profiles"][label] = {k: prof[k] for k in (
            "wall_s", "device_busy_ms", "idle_share", "kernels", "wrappers",
            "top")}
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="*", default=["."],
                    help="checkout roots")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--graph", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_bfs: no CUDA device", file=sys.stderr)
        return 2
    if args.child is not None:
        child(args.child, args.graph, args.seed)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    graph = os.path.join(ROOT, "build", "time_bfs",
                         f"rmat-{args.scale}-{args.seed}.npz")
    if not os.path.exists(graph):
        sys.path.insert(0, os.path.join(ROOT, "src"))
        from repro_torch.core import graph as G
        t = time.perf_counter()
        g = G.rmat(args.scale, seed=args.seed)
        os.makedirs(os.path.dirname(graph), exist_ok=True)
        np.savez(graph, v=g.num_vertices, indptr=g.indptr, indices=g.indices,
                 degrees=g.degrees)
        print(f"RMAT scale {args.scale}: {time.perf_counter() - t:.1f} s",
              flush=True)
    for tree in args.runs:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
               "--graph", graph, "--seed", str(args.seed)]
        out = subprocess.run(
            cmd, check=True, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(
                os.path.abspath(tree), "src"))).stdout
        print(out, end="", flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

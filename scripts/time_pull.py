"""Time the two pull-scan kernels (`bottomup.cu`, `hub.cu`) of one or more
checkouts of this repo on one GPU, in turns, on the calls the BFS paths
make on Graph500 RMAT, and profile a search on each path.

    python3 scripts/time_pull.py build/parent . . build/parent

Each RUN is a checkout's root. The graph (--scale, --seed) is made
once, by this checkout, and saved under `build/time_pull/`; each run is a
process of its own with that checkout's `src` first on the path, which
loads it and, with `chip_smoke.py`'s code from this checkout:

1. drives the four BFS runs of `chip_smoke.py` phase 4 (unsplit and hub
   split, a batch of 8 roots and 4 in Graph500 mode) and the stepper on 2
   roots, recording each run's seconds, TEPS and launches, and capturing
   every kernel call;
2. times `bottomup_batch`, `hub_bottomup_batch`, `bottomup` and
   `hub_bottomup` on the captured call `chip_smoke.py` phase 5 times
   (`time_ms`: median of 20, each after an L2 flush, queued behind a
   device sleep), after holding each against its plain version; a digest
   of the inputs shows that every run timed the same call;
3. sums the pull kernels' time over every captured call of each run
   (`time_ms`, median of 5, cold L2 each);
4. profiles one search on each path (unsplit batch of 8, split batch of
   8, stepper on 1 root): wall, device busy, and the summed device time
   and calls of each of the port's kernels, by source and by wrapper.

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
PULL = ("bottomup_batch", "hub_bottomup_batch", "bottomup", "hub_bottomup")
SUM_REPS = 5      # time_ms samples per call in the per-path sums


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


def child(tree: str, graph: str, seed: int) -> None:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.core.graph import Graph
    from repro_torch.engine import Engine
    from repro_torch.kernels import _build, ops
    _build.build_all()
    z = np.load(graph)
    g = Graph(int(z["v"]), z["indptr"], z["indices"], z["degrees"])
    dev = torch.device("cuda", 0)
    engine = Engine(g)
    engine.session.device_graph()
    engine.session.ell_tiles()
    roots = np.random.default_rng(seed).choice(np.flatnonzero(g.degrees > 0),
                                               12, replace=False)
    split = BFSConfig(hub_split=True)
    row = dict(tree=tree, runs={})
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
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        row["runs"][label] = dict(
            wall_s=time.perf_counter() - t, teps=float(getattr(res, teps)),
            launches={k: c for k, c in ops.LAUNCHES.items() if c})
    restore()
    picked = cs.pick_calls(calls)
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    errs = {n: 0 for n in cs.BFS_KERNELS}
    row["kernels"] = {}
    for name in PULL:
        lvl, cargs = cs.timed_call(picked, name)
        cs.kernel_vs_plain(name, cargs, errs)
        ms, plain_ms = cs.time_kernel(name, cargs, cs.TIMING_REPS, flush)
        nbytes, nops = cs.bound(name, cargs)
        row["kernels"][name] = dict(
            ms=ms, plain_ms=plain_ms, level=lvl,
            bound_ms=max(nbytes / cs.HBM_BYTES_PER_S,
                         nops / cs.CUDA_CORE_OPS_PER_S) * 1e3,
            shapes=[list(a.shape) for a in cargs], digest=digest(cargs),
            plan=cs.launch_plan(name))
    # every captured pull call of each path, cold L2 each
    row["summed"] = {}
    for label, _, name, cargs in calls:
        if name in PULL:
            acc = row["summed"].setdefault(f"{label}: {name}",
                                           dict(ms=0.0, calls=0))
            acc["ms"] += cs.time_ms(cs.kernel_fn(name, cargs), SUM_REPS,
                                    flush)
            acc["calls"] += 1
    del flush
    row["profiles"] = {}
    for label, fn in (
            ("unsplit batch of 8", lambda: engine.bfs(roots[:8])),
            ("split batch of 8", lambda: engine.bfs(roots[:8], split)),
            ("stepper, 1 root",
             lambda: engine.bfs(roots[:1], backend="stepper"))):
        prof = cs.profile_search(fn)
        row["profiles"][label] = {k: prof[k] for k in (
            "wall_s", "device_busy_ms", "idle_share", "kernels", "wrappers")}
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
        print("time_pull: no CUDA device", file=sys.stderr)
        return 2
    if args.child is not None:
        child(args.child, args.graph, args.seed)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    graph = os.path.join(ROOT, "build", "time_pull",
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

"""A copy of the benchmark at a size the CPU tests hold: the manifest and
every file under `portbench/`, with each configuration's graph at scale 8
and each traffic mix's windows and samples short, and two cells that
`BENCHMARK.json` does not hold: the server's (`SVC`) and one on four
ranks (`RANKED`)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

SCALE = 8


# The open-loop cell over the server, which `BENCHMARK.json` leaves out
# (its tail spread too wide for any bound: PERF.md §7); its files are
# under `portbench/`, and the tests run it from these entries.
SVC = {
    "configs": [{"name": "svc-s22", "source": "Graph500 Kronecker graph "
                 "served as one-key queries by the port's BFSServer",
                 "file": "portbench/configs/svc-s22.json",
                 "reduced": ["scale"], "why": "the server"}],
    "workloads": [{"name": "svc-s22.poisson", "config": "svc-s22",
                   "traffic": "poisson", "chips": 1,
                   "why": "open loop of one-key queries"}],
    "end_to_end": [{"name": "query_p95_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["svc-s22.poisson"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": src, "layer": layer,
         "moves": "query_p95_ms", "workloads": ["svc-s22.poisson"]}
        for n, u, b, src, layer in (
            ("driver.finalize_share.svc", "%", "lower", "program_span",
             "level driver"),
            ("server.roots_per_dispatch", "roots", "higher",
             "program_counter", "server"),
            ("device.idle_share.svc", "%", "lower", "device_trace",
             "device"))],
}


# A keys cell on four ranks, one partition a rank, over the g500
# configuration with a `partition` block (`PARTITION`): the paper's
# partitioned search, through the port's `PartitionFront`. Its
# configuration file is written by `tiny_root`; every metric that lists
# `g500-s24.keys` lists it too.
RANKED = {
    "configs": [{"name": "g500-p4", "source": "Graph500 BFS specification "
                 "(graph500.org), partitioned one part a rank",
                 "file": "portbench/configs/g500-p4.json",
                 "reduced": ["scale"], "why": "the partitioned search"}],
    "workloads": [{"name": "g500-p4.keys", "config": "g500-p4",
                   "traffic": "keys", "chips": 4,
                   "why": "one key at a time over four partitions"}],
}
PARTITION = {"strategy": "specialized", "hub_edge_fraction": 0.5,
             "exchange": "bitmap", "coordinator": "hub"}
# The readers of the level driver's spans and timings, which the
# partitioned search (`core.hybrid_bfs.make_hybrid_search`) does not run:
# they find nothing on the ranked cell.
LEVEL_DRIVER_ONLY = ("driver.finalize_share.g500", "driver.levels_share.g500",
                     "driver.copy_share.g500", "driver.init_share.g500",
                     "step.issue_ms.g500", "step.wait_ms.g500")
# The readers of the one-chip session's tile build and graph hash, which
# rank 0's session on the partitioned path does not make.
SESSION_BUILDS = ("setup.tiles_s", "setup.fingerprint_s")
# The readers of the device trace and of kernel launches, which find
# nothing on the CPU.
CPU_SILENT = ("bfs_kernels_roofline", "device.idle_share.g500",
              "ops.launches_per_root.g500")


def tiny_root(dst: Path, drain_s: float = 120.0) -> Path:
    """Copy the benchmark into `dst`, cut to test size, with the open-loop
    cell (`SVC`) and the ranked one (`RANKED`) added, and queries given up
    `drain_s` past the window; returns `dst`."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for extra in (SVC, RANKED):
        for key, entries in extra.items():
            manifest[key] += entries
    for x in manifest["end_to_end"] + manifest["per_layer"]:
        if "g500-s24.keys" in x.get("workloads", ()):
            x["workloads"].append("g500-p4.keys")
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((REPO / "portbench" / "configs" / "g500-s24.json")
                     .read_text())
    cfg.update(name="g500-p4", partition=PARTITION)
    (dst / "portbench" / "configs" / "g500-p4.json").write_text(
        json.dumps(cfg))
    for f in (dst / "portbench" / "configs").glob("*.json"):
        d = json.loads(f.read_text())
        d["generator"]["scale"] = SCALE
        f.write_text(json.dumps(d))
    for f in (dst / "portbench" / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        d.update(keys=min(d["keys"], 32), check_queries=2,
                 trace_slice_s=0.2, drain_s=drain_s)
        if d["loop"] == "open":
            d.update(rate_qps=30.0)
        f.write_text(json.dumps(d))
    return dst


def run_cell(root: Path, workload: str, *, trace: bool = False,
             seed: int = 2**31 + 11, seconds: float = 0.4,
             follower=None) -> dict:
    """One run of `workload` on the CPU, as `run.py` would make it (a cell
    on four chips: on four gloo ranks, `follower` on ranks > 0)."""
    import time

    from portbench import harness
    return harness.run(root, workload, seed, seconds, trace, "cpu",
                       time.perf_counter(), follower=follower)


def failing_follower(group, device, *args, at: int) -> tuple:
    """A follower that serves the front until its `at`-th dispatch (the
    first is the warm-up) raises on rank 1."""
    import torch.distributed as dist

    from portbench import harness
    from repro_torch.engine.engine import Engine
    if dist.get_rank() == 1:
        bfs_plan = Engine.bfs_plan
        calls = []

        def failing(self, *a, **kw):
            calls.append(1)
            if len(calls) == at:
                raise RuntimeError(f"rank 1 fails at dispatch {at}")
            return bfs_plan(self, *a, **kw)
        Engine.bfs_plan = failing
    return harness.follow_front(group, device, *args)

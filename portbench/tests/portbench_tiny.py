"""A copy of the benchmark at a size the CPU tests hold: the manifest and
every file under `portbench/`, with each configuration's graph at scale 8
and each traffic mix's windows and samples short."""
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


def tiny_root(dst: Path, drain_s: float = 120.0) -> Path:
    """Copy the benchmark into `dst`, cut to test size, with the open-loop
    cell added (`SVC`) and queries given up `drain_s` past the window;
    returns `dst`."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for key, entries in SVC.items():
        manifest[key] += entries
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
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
             seed: int = 2**31 + 11, seconds: float = 0.4) -> dict:
    """One run of `workload` on the CPU, as `run.py` would make it."""
    import time

    from portbench import harness
    return harness.run(root, workload, seed, seconds, trace, "cpu",
                       time.perf_counter())

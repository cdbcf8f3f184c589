"""Find the highest rate an open-loop cell's server sustains: offer its
traffic at each of a list of rates, one window each, in one process.

    python3 portbench/sweep.py --workload svc-s22.poisson --seed 5 \
        --seconds 30 --rates 4 6 8 10 12

A rate is sustained when nothing is refused or failed and the backlog
does not grow: the median latency of the window's last third stays
within twice that of its first third. One JSON line a rate: the
latencies' p50 and p95 (ms), queries offered, refused and failed, those
thirds' medians, and the roots a dispatch. The cell's traffic file then
holds four fifths of the highest sustained rate as a number.
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    from portbench import drivers, graph500
    from portbench.manifest import Manifest
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    m = Manifest(ROOT)
    cell = m.workload(args.workload)
    cfg = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    csr = graph500.make_graph(cfg["generator"], args.seed, dev)
    loop = drivers.OpenLoop(cfg, traffic, csr, args.seed, dev)
    loop.setup()
    try:
        for rate in args.rates:
            loop.rate = rate
            before = loop.totals()
            t0 = time.perf_counter()
            _, _, recs = loop.run(loop.schedule(args.seconds), keep=False)
            after = loop.totals()
            lat = sorted(q["latency"] for q in recs)
            done = [q["latency"] for q in recs if "done" in q]
            third = max(1, len(recs) // 3)
            first = float(np.median([q["latency"] for q in recs[:third]]))
            last = float(np.median([q["latency"] for q in recs[-third:]]))
            batches = after["batches"] - before["batches"]
            out = dict(
                rate_qps=rate, offered=len(recs), completed=len(done),
                refused=sum(1 for q in recs if q.get("refused")),
                failed=sum(1 for q in recs if "error" in q),
                p50_ms=float(np.median(lat)) * 1e3,
                p95_ms=lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3,
                first_third_median_ms=first * 1e3,
                last_third_median_ms=last * 1e3,
                roots_per_dispatch=((after["roots"] - before["roots"])
                                    / batches if batches else None),
                sustained=(len(done) == len(recs) and last <= 2 * first),
                seconds=time.perf_counter() - t0,
                card=torch.cuda.get_device_name(dev))
            print(json.dumps(out), flush=True)
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

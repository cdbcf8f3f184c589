"""The control of `correct`, at a cell's own size: the reference search
ending one level early (`reference.control_search`) put in the program's
place, judged as the program's answers are.

    python3 portbench/control.py --workload g500-s24.keys --seeds 11 12 13

For each seed: the cell's graph and keys as a run makes them, the keys
of its first `check_queries` queries searched by the control, and the
numbers the
comparison reads, one JSON line each. Every line has to read above the
limits (`reference.LIMITS`), or the comparison cannot tell the control
from the program.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root, workload: str, seed: int, device) -> dict:
    from portbench import graph500, reference
    from portbench.manifest import Manifest
    m = Manifest(root)
    cell = m.workload(workload)
    cfg = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    csr = graph500.make_graph(cfg["generator"], seed, device)
    n = int(traffic["check_queries"]) * int(traffic["roots_per_query"])
    keys = graph500.sample_roots(csr.degrees, int(traffic["keys"]),
                                 [seed, 1])[:n]
    indptr, indices = csr.on(device)
    judge = reference.Judge(indptr, indices)
    answers = []
    for k in keys:
        parent, level = reference.control_search(indptr, indices, int(k))
        answers.append((int(k), parent.cpu().numpy(), level.cpu().numpy()))
    numbers = reference.judge_answers(judge, answers, 0)
    return dict(workload=workload, seed=seed, numbers=numbers,
                correct=reference.is_correct(numbers))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for w in args.workload:
        for s in args.seeds:
            t0 = time.perf_counter()
            out = readings(ROOT, w, s, torch.device("cuda", 0))
            out["seconds"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of `BENCHMARK.json` once on this machine's CUDA device.

    python3 portbench/run.py --workload g500-s24.keys --seed 7 --seconds 30 --trace 0

From the root of a checkout. The last line of standard output is the
result's JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error and the result's
last key. Exits non-zero, with no result, without CUDA or with fewer
devices than the cell asks for, when the port cannot be imported, or
when JAX or the JAX package is loaded once the window has closed, in
this process or in any rank of a cell on more than one chip (exit 3).
Such a cell runs one rank a card over NCCL (`harness.run`). The port's
kernels build into `build/` of the checkout; caches of PyTorch's own go
there too.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from portbench import harness
    from portbench.manifest import Manifest

    chips = int(Manifest(ROOT).workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), T_START)
    except harness.ForbiddenLoaded as e:
        print(f"loaded after the window: {e}", file=sys.stderr)
        return 3
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        card = f"nvidia-smi failed: {e!r}"
    print(f"card: {card}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The dry-run's records as a table: for each arch and shape, a rank's
estimated GB (`bytes_per_rank_est`) and its FLOPs against the model's
(`flops_per_rank_est` x ranks / `model_flops`), on 16 x 16 and 2 x 16 x 16.

    python3 scripts/dryrun_table.py [build/dryrun_torch.json ...]

Reads the JSON lists that `python -m repro_torch.launch.dryrun --out FILE`
writes (several files are merged, a later record of the same cell
winning) and prints one markdown row an arch: "GB, ratio; GB, ratio"
(16 x 16; 2 x 16 x 16), "skip", or "err <op>"; then the count of records
by status and every `seq_axis` seen. Runs on the CPU; imports nothing but
the standard library.
"""
from __future__ import annotations

import json
import pathlib
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")
DEFAULT = pathlib.Path(__file__).resolve().parents[1] / "build" / \
    "dryrun_torch.json"


def cell(rec) -> str:
    if rec is None:
        return "-"
    if rec["status"] == "skipped":
        return "skip"
    if rec["status"] == "error":
        return f"err {rec.get('op')}"
    gb = rec["bytes_per_rank_est"] / 1e9
    ratio = rec["flops_per_rank_est"] * rec["n_devices"] / rec["model_flops"]
    digits = 1 if gb >= 1 else 2
    return f"{gb:.{digits}f}, {ratio:.2f}x"


def main(argv=None) -> int:
    paths = [pathlib.Path(p) for p in (argv or sys.argv[1:])] or [DEFAULT]
    recs = {}
    for path in paths:
        for r in json.loads(path.read_text()):
            recs[r["arch"], r["shape"], r["mesh"]] = r
    archs = list(dict.fromkeys(a for a, _, _ in recs))
    print("| arch | " + " | ".join(SHAPES) + " |")
    print("| --- |" + " --- |" * len(SHAPES))
    for a in archs:
        row = ["; ".join(cell(recs.get((a, s, m))) for m in MESHES)
               for s in SHAPES]
        print(f"| {a} | " + " | ".join(row) + " |")
    status = {}
    for r in recs.values():
        status[r["status"]] = status.get(r["status"], 0) + 1
    seq = sorted({str(r.get("seq_axis")) for r in recs.values()
                  if r["status"] == "ok"})
    print(f"\n{len(recs)} records: {status}; seq_axis {seq}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

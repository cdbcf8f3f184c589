"""Serve models of one or more checkouts of this repo on one GPU, in turns,
at `chip_smoke.py` phase 6/6b's shape (batch 4, a 4,200-token prompt, 32
greedy tokens, random weights from seed 0, bf16).

    python3 scripts/time_serve.py build/parent . . build/parent
    python3 scripts/time_serve.py . --arch gemma2-9b --layers 0

Each RUN is a checkout's root, served in a process of its own with that
checkout's `src` first on the path, so two versions are timed by the same
code on the same card in one call; give them in turns (parent, change,
change, parent), since a decode step is bound by the host's launches and
its milliseconds move from one run to the next. Per run and model, one
JSON line: the decode ms a step, the prefill seconds, the first tokens of
each row and a digest of the last logits (equal digests: the same bits),
beside the card's name and power limit. `--layers` cuts the depth (0: the
published depth; the default cuts qwen3-moe to phase 6b's 8 layers).
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = """
import dataclasses, hashlib, json, sys
import torch
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
arch, layers, card = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cfg = get_config(arch)
if layers:
    cfg = dataclasses.replace(cfg, n_layers=layers)
run = serve.serve(cfg, batch=4, prompt_len=4200, gen=32, seed=0,
                  device=torch.device("cuda"))
bits = run.logits.float().cpu().numpy().tobytes()
print(json.dumps(dict(
    arch=arch, layers=cfg.n_layers,
    decode_ms_per_step=run.decode_s / run.steps * 1e3,
    prefill_s=run.prefill_s, tokens_head=run.tokens[:, :6].tolist(),
    logits_sha256=hashlib.sha256(bits).hexdigest()[:16], card=card)))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", help="checkout roots, in turns")
    ap.add_argument("--arch", action="append",
                    help="default: qwen3-moe-235b-a22b and gemma2-9b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut for every arch (default: qwen3-moe 8, "
                         "the others whole)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_serve: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    archs = args.arch or ["qwen3-moe-235b-a22b", "gemma2-9b"]
    for run in args.runs:
        root = os.path.abspath(os.path.join(os.getcwd(), run))
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        for arch in archs:
            layers = args.layers if args.layers is not None else (
                8 if arch.startswith("qwen3-moe") else 0)
            out = subprocess.run(
                [sys.executable, "-c", CHILD, arch, str(layers), card],
                env=env, cwd=root, capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stderr[-3000:], file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec["run"] = run
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the decode-attention kernel of one or more checkouts of this repo
on one GPU, in turns, at the decode shapes of the dense configs the port
serves (B 4, context 4,232, bf16, cache_len the whole context).

    python3 scripts/time_decode.py build/parent . . build/parent
    python3 scripts/time_decode.py . .@2      # the plan of 2 blocks per SM

Each RUN is a checkout's root, optionally `@N`: its split plan then aims
at N blocks per SM instead of what the occupancy calculator reports (for
checkouts whose launcher has `resident_blocks`). Each run is a process of
its own with that checkout's `src` first on the path, so two versions of
the kernel are timed by the same code on the same card in one call.

Per run and shape, one JSON line: the plan the launcher recorded (where it
records one), the kernel's ms at cap 50 and cap 0 by `chip_smoke.py`'s
`time_ms` (all repetitions queued behind a device sleep, a read flush of
the L2 before each) and by `time_ms_synced` (the method of `chip_smoke.py`
before the decode kernel's redesign: a write flush and a host sync around
each repetition), and one SDPA call's ms at cap 0 by `time_ms`. The
kernel's output is first held against the plain version (bf16, one step).
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma2-9b", "yi-9b", "stablelm-3b")
BATCH, CONTEXT = 4, 4232


def time_ms_synced(fn, reps, flush):
    """Median ms between two CUDA events around `fn`, each repetition
    after a write of `flush` and followed by a host sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def child(tree: str, resident: int | None) -> None:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, decode_attn
    _build.build_all(("decode_attn",))
    if resident is not None:
        decode_attn.resident_blocks = lambda *_: resident
    dev = torch.device("cuda", 0)
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    for arch in ARCHS:
        cfg = get_config(arch)
        g = cfg.n_heads // cfg.n_kv
        q, kc, vc, clen = cs.decode_inputs(
            np.random.default_rng(3), dev, torch.bfloat16, BATCH, CONTEXT,
            cfg.n_kv, g, cfg.head_dim, [CONTEXT] * BATCH)
        rtol, atol = cs.DECODE_TOL["bfloat16"]
        torch.testing.assert_close(
            decode_attn.decode_attention_cuda(q, kc, vc, clen,
                                              logit_cap=50.0).float(),
            decode_attn.decode_attention_plain(q, kc, vc, clen,
                                               logit_cap=50.0).float(),
            rtol=rtol, atol=atol)
        row = dict(tree=tree, resident_override=resident, arch=arch,
                   q=list(q.shape), plan=dict(getattr(decode_attn,
                                                     "LAST_PLAN", {})))
        for cap in (50.0, 0.0):
            def fn():
                return decode_attn.decode_attention_cuda(q, kc, vc, clen,
                                                         logit_cap=cap)
            row[f"ms_cap{cap:g}"] = cs.time_ms(fn, cs.TIMING_REPS, flush)
            row[f"synced_ms_cap{cap:g}"] = time_ms_synced(
                fn, cs.TIMING_REPS, flush)
        qs = q.reshape(BATCH, cfg.n_kv * g, 1, cfg.head_dim)
        ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)
        mask = (torch.arange(CONTEXT, device=dev)[None] < clen[:, None])[
            :, None, None]
        row["sdpa_ms_cap0"] = cs.time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True),
            cs.TIMING_REPS, flush)
        nbytes, _ = cs.decode_bound(q, kc, clen)
        row["bound_ms"] = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(json.dumps(row), flush=True)
        del q, kc, vc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="*", default=["."],
                    help="checkout roots, each optionally @N")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--resident", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 2
    if args.child is not None:
        child(args.child, args.resident)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    for run in args.runs:
        tree, _, n = run.partition("@")
        src = os.path.join(os.path.abspath(tree), "src")
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree]
        if n:
            cmd += ["--resident", n]
        subprocess.run(cmd, check=True, env=dict(os.environ, PYTHONPATH=src))
    return 0


if __name__ == "__main__":
    sys.exit(main())

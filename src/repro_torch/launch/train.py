"""End-to-end training driver: config -> weights -> train loop with
checkpoints (the JAX package's `launch/train.py`, on one device).

    python -m repro_torch.launch.train --arch stablelm-3b [--smoke]
        [--steps 20] [--batch 8] [--seq 128] [--ckpt DIR] [--ckpt-every 10]
        [--accum 1] [--seed 0] [--device cpu]

Restores from LATEST when --ckpt holds a checkpoint (kill a run and run
the same command again: it resumes), checkpoints atomically every
--ckpt-every steps, flags straggling steps, and regenerates each step's
batch from (seed, step) (stateless data). The weights are random, drawn
from a `torch.Generator` on the device seeded with --seed; the frontend
stubs' embeddings are bf16, as the reference draws them. It runs on the
GPU unless --device cpu is given, and raises where CUDA is missing. The
one host sync a step is reading its loss. `train` is the same run as a
function that returns the losses, the metrics and the step seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs.base import ModelConfig, get_config, smoke_config
from repro_torch.data.synthetic import batch_for_config
from repro_torch.device import resolve_device
from repro_torch.ft.elastic import StepWatchdog
from repro_torch.models import model as MODEL
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainRun:
    """One training run: the steps it ran (from `start_step`), each one's
    loss, grad norm and host-clock seconds (ending in the loss's read),
    the model and optimizer state it ended with, and its step function."""
    start_step: int
    losses: list
    grad_norms: list
    step_s: list
    params: MODEL.Model
    opt_state: dict
    step_fn: object
    init_s: float


def device_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
                 seed: int, device) -> dict:
    """Step `step`'s batch (`data.synthetic.batch_for_config`) on
    `device`, the frontend stubs' embeddings in bf16."""
    out = {}
    for k, v in batch_for_config(cfg, step, batch, seq, seed).items():
        t = torch.from_numpy(v).to(device)
        out[k] = t.to(torch.bfloat16) if k in ("embeds", "enc_embeds") else t
    return out


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          device: torch.device, accum: int = 1, seed: int = 0,
          ckpt: str = "", ckpt_every: int = 10, log=print) -> TrainRun:
    """Train from `seed`'s weights (or the latest checkpoint under `ckpt`)
    up to step `steps`, printing a line a step through `log`."""
    ocfg = OptConfig(warmup_steps=5, decay_steps=max(steps, 10))
    t0 = time.perf_counter()
    params = MODEL.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    opt_state = init_opt_state(params, ocfg)
    init_s = time.perf_counter() - t0
    start_step = 0
    if ckpt and CKPT.latest_step(ckpt) is not None:
        (params, opt_state), start_step, _ = CKPT.restore(
            ckpt, (params, opt_state))
        log(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(cfg, ocfg, accum_steps=accum)
    watchdog = StepWatchdog()
    run = TrainRun(start_step, [], [], [], params, opt_state, step_fn, init_s)
    for step in range(start_step, steps):
        inputs = device_batch(cfg, step, batch, seq, seed, device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, inputs)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        gnorm = float(metrics["grad_norm"])
        watchdog.record(dt)
        flag = " STRAGGLER" if watchdog.is_straggler(dt) else ""
        run.losses.append(loss)
        run.grad_norms.append(gnorm)
        run.step_s.append(dt)
        log(f"[train] step={step} loss={loss:.4f} gnorm={gnorm:.3f} "
            f"{dt * 1e3:.0f}ms{flag}")
        if ckpt and (step + 1) % ckpt_every == 0:
            CKPT.save(ckpt, step + 1, (params, opt_state),
                      metadata={"arch": cfg.name, "loss": loss})
    run.params, run.opt_state = params, opt_state
    if len(run.losses) >= 2 and not np.isfinite(run.losses).all():
        raise FloatingPointError(f"training diverged: {run.losses}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                device=device, accum=args.accum, seed=args.seed,
                ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                log=lambda msg: print(msg, flush=True))
    return run.losses


if __name__ == "__main__":
    main()

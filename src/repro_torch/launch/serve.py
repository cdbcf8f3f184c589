"""Batched serving: prefill a prompt batch, decode N tokens.

    python -m repro_torch.launch.serve --arch gemma2-9b [--smoke]
        [--batch 4] [--prompt-len 32] [--gen 16] [--seed 0] [--device cpu]

Every architecture of `configs.base.ARCHS` (the dense, moe, ssm, hybrid
and encdec families) goes through the same prefill and greedy decode loop;
--arch takes the config module's name with `-` or `_`
(`qwen3-moe-235b-a22b`, `mamba2-2-7b`, `seamless-m4t-medium`). The
weights are random, drawn from --seed; so is the prompt (`prompt_inputs`):
token ids, internvl2's patch embeddings in their place (the vision stub),
or seamless's token ids and frame embeddings for its encoder (the audio
stub).
It runs on the GPU unless --device cpu is given (then the plain PyTorch
version of the decode kernel runs), and raises where CUDA is missing.
`serve` is the same run as a function that returns its timings.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as MODEL
from repro_torch.train.serve_step import decode_loop, make_prefill_step


@dataclasses.dataclass
class ServeRun:
    """One serve run: tokens int64 [B, gen] (numpy), the last logits
    [B, V], the weights and the cache it ended with, and host-clock
    seconds of each phase, each ending in a device sync."""
    tokens: np.ndarray
    logits: torch.Tensor
    params: MODEL.Model
    cache: dict
    init_s: float
    prefill_s: float
    decode_s: float
    steps: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_inputs(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                  device) -> dict:
    """The prompt, drawn as the JAX package's `launch/serve.py` draws it
    from `np.random.default_rng(seed)`, in its order: the token ids int32
    [B, S] first, always; with a frontend stub (not encdec) bf16
    `embeds` [B, S, D] in their place; under encdec bf16 `enc_embeds`
    [B, S, D] beside them. bf16 whatever the model's dtype (a product with
    fp32 weights computes in fp32)."""
    rng = np.random.default_rng(seed)
    shape = (batch, prompt_len)
    inputs = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, shape, dtype=np.int32)).to(device)}

    def embeds():
        return torch.from_numpy(rng.standard_normal(
            (*shape, cfg.d_model))).to(device=device, dtype=torch.bfloat16)
    if cfg.frontend != "none" and cfg.family != "encdec":
        inputs = {"embeds": embeds()}
    if cfg.family == "encdec":
        inputs["enc_embeds"] = embeds()
    return inputs


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
          seed: int, device: torch.device) -> ServeRun:
    """Random weights and prompt from `seed`, prefill, then `gen - 1`
    greedy decode steps."""
    t0 = time.perf_counter()
    params = MODEL.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    _sync(device)
    init_s = time.perf_counter() - t0
    s = prompt_len
    inputs = prompt_inputs(cfg, batch, s, seed, device)

    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg, s + gen)(params, inputs)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out, logits, cache = decode_loop(cfg, params, logits, cache, s, gen - 1)
    _sync(device)
    decode_s = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("serve: non-finite logits")
    return ServeRun(tokens=out.cpu().numpy(), logits=logits, params=params,
                    cache=cache, init_s=init_s, prefill_s=prefill_s,
                    decode_s=decode_s, steps=gen - 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    b, s = args.batch, args.prompt_len
    run = serve(cfg, batch=b, prompt_len=s, gen=args.gen, seed=args.seed,
                device=device)
    print(f"[serve] {cfg.name} on {device}: prefill {b}x{s}: "
          f"{run.prefill_s * 1e3:.0f}ms")
    print(f"[serve] decoded {run.steps} steps x {b} seqs in "
          f"{run.decode_s * 1e3:.0f}ms "
          f"({run.steps * b / max(run.decode_s, 1e-9):.1f} tok/s)")
    print("[serve] sample:", run.tokens[0, :12].tolist())
    return run.tokens


if __name__ == "__main__":
    main()

"""Serving steps: prefill and one-token decode, and greedy generation."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as D


def make_prefill_step(cfg: ModelConfig, ctx_len: int):
    def prefill_step(params, inputs):
        return D.prefill(cfg, params, inputs, ctx_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, cache, tokens [B,1], positions [B]) -> (logits [B,V], cache);
    the cache is updated in place."""
    def serve_step(params, cache, tokens, positions):
        return D.decode_step(cfg, params, cache, tokens, positions)
    return serve_step


def decode_loop(cfg: ModelConfig, params, logits, cache, start: int,
                steps: int):
    """Greedy decoding from prefill's last logits [B,V]: the token they
    pick, then `steps` decode steps from position `start`, each fed the
    token before. Returns (tokens int32 [B, steps + 1], the last logits,
    cache)."""
    step_fn = make_decode_step(cfg)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(steps):
        positions = torch.full((tok.shape[0],), start + i, dtype=torch.int32,
                               device=tok.device)
        logits, cache = step_fn(params, cache, tok, positions)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1), logits, cache


def greedy_generate(cfg: ModelConfig, params, prompt_tokens, steps: int,
                    ctx_len: int) -> torch.Tensor:
    """Prefill, then `steps - 1` greedy decode steps: tokens int32
    [B, steps] (the first from the prefill's logits)."""
    logits, cache = make_prefill_step(cfg, ctx_len)(
        params, {"tokens": prompt_tokens})
    return decode_loop(cfg, params, logits, cache, prompt_tokens.shape[1],
                       steps - 1)[0]

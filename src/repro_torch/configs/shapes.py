"""The four input-shape cells and their input stand-ins (the JAX package's
`configs/shapes.py`).

`decode_*` / `long_*` cells are one new token against a KV cache of
`seq_len` (the serving step), `train_4k` the train step, `prefill_32k` a
full prompt. `long_500k` applies only to sub-quadratic archs
(`cfg.sub_quadratic`). `input_specs` returns tensors on the `meta`
device, PyTorch's allocation-free stand-in for `jax.ShapeDtypeStruct`:
the keys, shapes and dtypes of every model input of a cell.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch x shape) is a defined cell, with the skip reason."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md)"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b, s):
    return _spec((b, s), torch.int32)


def input_specs(cfg: ModelConfig, shape: str,
                smoke: bool = False) -> dict[str, torch.Tensor]:
    """`meta`-device stand-ins for every model input of the cell.

    For `vision`/`audio` frontends the modality encoder is a stub:
    precomputed patch/frame embeddings (`embeds`, or encdec's
    `enc_embeds`) in the model's dtype are the input.
    """
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq_len
    if smoke:
        b, s = 2, min(s, 64)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    d = cfg.d_model

    if cell.kind == "train":
        if cfg.family == "encdec":
            return {"enc_embeds": _spec((b, s, d), dt),
                    "tokens": _tok(b, s), "labels": _tok(b, s)}
        if cfg.frontend != "none":
            return {"embeds": _spec((b, s, d), dt), "labels": _tok(b, s)}
        return {"tokens": _tok(b, s), "labels": _tok(b, s)}

    if cell.kind == "prefill":
        if cfg.family == "encdec":
            return {"enc_embeds": _spec((b, s, d), dt),
                    "tokens": _tok(b, s)}
        if cfg.frontend != "none":
            return {"embeds": _spec((b, s, d), dt)}
        return {"tokens": _tok(b, s)}

    # decode: one new token against a seq_len cache (the cache is passed
    # separately by the serving step; these are the per-step data inputs)
    return {"tokens": _tok(b, 1), "positions": _spec((b,), torch.int32)}

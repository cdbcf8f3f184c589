"""AdamW with a warmup + cosine schedule and global-norm clipping (the JAX
package's `train/optimizer.py`).

Written out in PyTorch rather than `torch.optim.AdamW`, which keeps its
moments in the parameter's dtype and orders the decay differently: here
every update is the reference's fp32 arithmetic in its order (clip scale,
bias corrections, `mhat / (sqrt(vhat) + eps) + wd * p`, cast back), and
the moments are kept in `moment_dtype` ("bfloat16" halves their memory).
The state is `{"m": {name: tensor}, "v": {name: tensor}, "step": int32}`
keyed by the model's `named_parameters()` names, all on the parameters'
device. `apply_updates` writes the parameters and the moments in place
(the counterpart of the reference's donated buffers) and returns its
metrics as device tensors: it never waits for the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then a cosine down to `min_lr_ratio` of
    it at `decay_steps`: an fp32 tensor (on `step`'s device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: nn.Module, cfg: OptConfig) -> dict:
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    named = list(params.named_parameters())
    device = named[0][1].device

    def zeros():     # like each parameter: a DTensor's moments shard alike
        return {n: torch.zeros_like(p, dtype=mdt) for n, p in named}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def apply_updates(params: nn.Module, grads: dict, state: dict,
                  cfg: OptConfig):
    """One AdamW step on `params` (in place) from `grads` ({name: tensor},
    any float dtype); returns (params, state, metrics {grad_norm (before
    clipping), lr}), the moments updated in place, `step` + 1."""
    step = state["step"] + 1
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for name, p in params.named_parameters():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

"""Training step: loss + gradients + AdamW, with gradient accumulation (the
JAX package's `train/train_step.py`).

`make_train_step(cfg, opt)` returns
`train_step(params, opt_state, batch) -> (params, opt_state, metrics)`.
It turns gradients on for the model it is given (its weights are built
frozen), takes the gradients with `torch.autograd.grad` (nothing is left
in `.grad`) and updates the parameters and the optimizer state in place.
The metrics (`loss`, `grad_norm`, `lr`) are device tensors: the step
never waits for the device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.train.optimizer import OptConfig, apply_updates


def _grads(loss: torch.Tensor, params) -> tuple:
    """d loss / d p for every parameter (zeros for one the loss does not
    reach, as `jax.grad` gives)."""
    return torch.autograd.grad(loss, params, allow_unused=True,
                               materialize_grads=True)


def make_train_step(cfg: ModelConfig, opt: OptConfig, accum_steps: int = 1):
    """The train step. With `accum_steps > 1` each batch tensor's leading
    axis is split into `accum_steps` micro-batches; their losses and
    gradients (fp32) are summed, then divided by `accum_steps`, as the
    reference's scan does. With 1, the gradients keep the parameters'
    dtype."""

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        names, plist = zip(*params.named_parameters())
        if accum_steps == 1:
            loss = loss_fn(cfg, params, batch)
            grads = dict(zip(names, _grads(loss, plist)))
            loss = loss.detach()
        else:
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                  *v.shape[1:]) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=plist[0].device)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in zip(names, plist)}
            for i in range(accum_steps):
                li = loss_fn(cfg, params, {k: v[i] for k, v in micro.items()})
                for n, g in zip(names, _grads(li, plist)):
                    grads[n].add_(g)
                loss = loss + li.detach()
            loss = loss / accum_steps
            for g in grads.values():
                g.div_(accum_steps)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step

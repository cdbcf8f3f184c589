"""Model assembly for the dense family: init and the full-sequence forward.

The JAX package's `models/model.py` for its dense branches: the plain
stack (`else`) and gemma2's local/global alternation (`alt_local_global`:
layer 2i attends within `sliding_window`, layer 2i+1 globally). The JAX
package stacks layer weights on a leading L axis for `lax.scan`; here the
layers are an `nn.ModuleList` run in a Python loop
(`interop.params_from_arrays` splits the L axis). Its sharding
constraints, remat and `models/flags.py` are compile-time concerns of XLA
with no counterpart here. The moe, ssm, hybrid and encdec families are not
ported (`ROADMAP.md` queue 1 item 12) and raise `NotImplementedError`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless the port runs `cfg`: the dense family, tied embeddings."""
    if cfg.family != "dense" or not cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (tie_embeddings="
            f"{cfg.tie_embeddings}) is not ported to repro_torch; the port "
            f"runs the dense family with tied embeddings (ROADMAP.md queue 1 "
            f"item 12)")


class DenseLayer(nn.Module):
    """Pre-norm block: ln1 -> attention -> residual, ln2 -> MLP -> residual."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt, d = L.dtype_of(cfg), cfg.d_model
        self.ln1 = L.zeros((d,), dt, device)
        self.attn = L.Attention(cfg, dt, device, generator)
        self.ln2 = L.zeros((d,), dt, device)
        self.mlp = L.MLP(d, cfg.d_ff, dt, device, generator)

    def forward(self, cfg: ModelConfig, x, positions, *, window: int):
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = self.attn(h, positions, cfg, window=window)
        x = x + a
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.mlp(h), kv


class Model(nn.Module):
    """Embedding, `cfg.n_layers` dense layers and the final norm. With no
    `generator` the weights are left uninitialized (to be copied in)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        check_ported(cfg)
        self.embed = L.Embedding(cfg, L.dtype_of(cfg), device, generator)
        self.final_norm = L.zeros((cfg.d_model,), L.dtype_of(cfg), device)
        self.layers = nn.ModuleList(DenseLayer(cfg, device, generator)
                                    for _ in range(cfg.n_layers))


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's attention window: `sliding_window` on the local layers
    (the even ones) of `alt_local_global`, else 0 (global)."""
    return cfg.sliding_window if cfg.alt_local_global and i % 2 == 0 else 0


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """Random weights with the JAX package's shapes and scales, drawn from
    `generator` (on `device`); norm scales zero."""
    return Model(cfg, device, generator)


def _stack(kvs):
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


def forward_hidden(cfg: ModelConfig, params: Model, inputs: dict):
    """Full-sequence forward up to the final norm (pre-unembed).

    Returns (hidden [B,S,D], caches). inputs: tokens [B,S] (the ported
    configs have no modality frontend). Caches as the JAX package's scan
    returns them with `collect_cache=True`: (k, v), each [L, B, S, K, h];
    with `alt_local_global` a pair of them, the local layers' and the
    global layers' ([L/2, ...] each).
    """
    check_ported(cfg)
    x = params.embed.embed(inputs["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    kvs = []
    for i, lp in enumerate(params.layers):
        x, kv = lp(cfg, x, positions, window=layer_window(cfg, i))
        kvs.append(kv)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.alt_local_global:
        return x, (_stack(kvs[0::2]), _stack(kvs[1::2]))
    return x, _stack(kvs)

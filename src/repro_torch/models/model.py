"""Model assembly: init and the full-sequence forward, for the dense, moe,
ssm and hybrid families.

The JAX package's `models/model.py` for those families:
  dense   the plain stack, and gemma2's local/global alternation
          (`alt_local_global`: layer 2i attends within `sliding_window`,
          layer 2i+1 globally);
  moe     every layer an MoE layer (qwen3-moe), or llama4's dense/MoE
          alternation (`alt_dense_moe`: layer 2i dense, 2i+1 MoE);
  ssm     mamba2: every layer a pre-norm SSD mixer, no attention, no MLP;
  hybrid  hymba: sliding-window attention and the SSD mixer side by side
          on the same normed input, `x + 0.5 * (a + y)`, then the MLP.
The JAX package stacks layer weights on a leading L axis for `lax.scan`
(under `alt_dense_moe` two stacks, `layers_dense` and `layers_moe`,
scanned in pairs); here the layers are one `nn.ModuleList` in the order
they run, in a Python loop (`interop.params_from_arrays` splits the L
axes and interleaves the two stacks). Its sharding constraints, remat and
`models/flags.py` are compile-time concerns of XLA with no counterpart
here. The encdec family, the modality frontends and untied embeddings are
not ported (`ROADMAP.md` queue 1 item 12) and raise `NotImplementedError`.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless the port runs `cfg`: a family of FAMILIES, token inputs
    (no frontend), tied embeddings."""
    if (cfg.family not in FAMILIES or cfg.frontend != "none"
            or not cfg.tie_embeddings):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (frontend {cfg.frontend!r}, "
            f"tie_embeddings={cfg.tie_embeddings}) is not ported to "
            f"repro_torch; the port runs the {', '.join(FAMILIES)} families "
            f"on token inputs with tied embeddings (ROADMAP.md queue 1 "
            f"item 12)")


def layer_kind(cfg: ModelConfig, i: int) -> str:
    """Layer i's block: "dense", "moe", "ssm" or "hybrid"."""
    if cfg.family == "moe" and cfg.alt_dense_moe:
        return "dense" if i % 2 == 0 else "moe"
    return cfg.family


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's attention window: `sliding_window` on every hybrid layer
    and on the local layers (the even ones) of `alt_local_global`, else 0
    (global)."""
    if cfg.family == "hybrid" or (cfg.alt_local_global and i % 2 == 0):
        return cfg.sliding_window
    return 0


class DenseLayer(nn.Module):
    """Pre-norm block: ln1 -> attention -> residual, ln2 -> FFN ->
    residual; the FFN is the SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt, d = L.dtype_of(cfg), cfg.d_model
        self.ln1 = L.zeros((d,), dt, device)
        self.attn = L.Attention(cfg, dt, device, generator)
        self.ln2 = L.zeros((d,), dt, device)
        self.init_ffn(cfg, dt, device, generator)

    def init_ffn(self, cfg: ModelConfig, dt, device, generator):
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, dt, device, generator)

    def ffn(self, h, cfg: ModelConfig):
        return self.mlp(h)

    def forward(self, cfg: ModelConfig, x, positions, *, window: int):
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = self.attn(h, positions, cfg, window=window)
        x = x + a
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.ffn(h, cfg), kv


class MoELayer(DenseLayer):
    """The same block with the MoE FFN (`moe`) in place of the MLP."""

    def init_ffn(self, cfg: ModelConfig, dt, device, generator):
        self.moe = MOE.init_moe(cfg, dt, device, generator)

    def ffn(self, h, cfg: ModelConfig):
        return MOE.moe_ffn(self.moe, h, cfg)


class SSMLayer(nn.Module):
    """Pre-norm SSD mixer with its residual: ln1 -> ssm -> residual."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt = L.dtype_of(cfg)
        self.ln1 = L.zeros((cfg.d_model,), dt, device)
        self.ssm = M.init_ssm(cfg, dt, device, generator)

    def forward(self, cfg: ModelConfig, x):
        """(x + y, (state [B,H,P,N], conv tail [B, W-1, ch]))."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        y, st = M.ssm_forward(self.ssm, h, cfg, return_final_state=True)
        return x + y, st


class HybridLayer(nn.Module):
    """ln1, then sliding-window attention and the SSD mixer on the same
    normed input, averaged into the residual; ln2 -> MLP -> residual."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt, d = L.dtype_of(cfg), cfg.d_model
        self.ln1 = L.zeros((d,), dt, device)
        self.attn = L.Attention(cfg, dt, device, generator)
        self.ln2 = L.zeros((d,), dt, device)
        self.ssm = M.init_ssm(cfg, dt, device, generator)
        self.mlp = L.MLP(d, cfg.d_ff, dt, device, generator)

    def forward(self, cfg: ModelConfig, x, positions):
        """(x, ((k, v), (state, conv tail)))."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = self.attn(h, positions, cfg, window=cfg.sliding_window)
        y, st = M.ssm_forward(self.ssm, h, cfg, return_final_state=True)
        x = x + 0.5 * (a + y)
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.mlp(h), (kv, st)


LAYERS = {"dense": DenseLayer, "moe": MoELayer, "ssm": SSMLayer,
          "hybrid": HybridLayer}


class Model(nn.Module):
    """Embedding, `cfg.n_layers` layers (`layer_kind` of each) and the
    final norm. With no `generator` the weights are left uninitialized (to
    be copied in)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        check_ported(cfg)
        self.embed = L.Embedding(cfg, L.dtype_of(cfg), device, generator)
        self.final_norm = L.zeros((cfg.d_model,), L.dtype_of(cfg), device)
        self.layers = nn.ModuleList(
            LAYERS[layer_kind(cfg, i)](cfg, device, generator)
            for i in range(cfg.n_layers))


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
    returns them with `collect_cache=True`, each stacked on a leading
    layer axis:
      dense, moe       (k, v), each [L, B, S, K, h];
      alt_local_global (local (k, v), global (k, v)), [L/2, ...] each;
      alt_dense_moe    (dense (k, v), moe (k, v)), [L/2, ...] each;
      ssm              (state [L, B, H, P, N] fp32, conv tail
                        [L, B, W-1, ch]);
      hybrid           ((k, v), (state, conv tail)).
    """
    check_ported(cfg)
    x = params.embed.embed(inputs["tokens"])
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=x.device)[None, :]
    kvs, states = [], []
    for i, lp in enumerate(params.layers):
        kind = layer_kind(cfg, i)
        if kind == "ssm":
            x, st = lp(cfg, x)
            states.append(st)
        elif kind == "hybrid":
            x, (kv, st) = lp(cfg, x, positions)
            kvs.append(kv)
            states.append(st)
        else:
            x, kv = lp(cfg, x, positions, window=layer_window(cfg, i))
            kvs.append(kv)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.family == "ssm":
        return x, _stack(states)
    if cfg.family == "hybrid":
        return x, (_stack(kvs), _stack(states))
    if cfg.alt_local_global or (cfg.family == "moe" and cfg.alt_dense_moe):
        return x, (_stack(kvs[0::2]), _stack(kvs[1::2]))
    return x, _stack(kvs)


def forward(cfg: ModelConfig, params: Model, inputs: dict):
    """Full logits [B, S, V] (fp32) and the caches (tests and small-scale
    use; the serving path unembeds only the last position)."""
    x, caches = forward_hidden(cfg, params, inputs)
    return params.embed.unembed(x, cfg), caches

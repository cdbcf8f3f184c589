"""Model assembly: init and the full-sequence forward, for every family.

The JAX package's `models/model.py`:
  dense   the plain stack, and gemma2's local/global alternation
          (`alt_local_global`: layer 2i attends within `sliding_window`,
          layer 2i+1 globally);
  moe     every layer an MoE layer (qwen3-moe), or llama4's dense/MoE
          alternation (`alt_dense_moe`: layer 2i dense, 2i+1 MoE);
  ssm     mamba2: every layer a pre-norm SSD mixer, no attention, no MLP;
  hybrid  hymba: sliding-window attention and the SSD mixer side by side
          on the same normed input, `x + 0.5 * (a + y)`, then the MLP;
  encdec  seamless-m4t: `n_enc_layers` dense blocks with non-causal
          attention over `enc_embeds` (`enc`, then `enc_norm`), then the
          decoder layers: causal self-attention, cross-attention to the
          encoder's memory (its keys and values not RoPE'd), the MLP.
The frontend stubs (internvl2's vision, seamless's audio) hand in
precomputed embeddings: `inputs["embeds"]` in place of the tokens, or
seamless's `inputs["enc_embeds"]` for the encoder.
The JAX package stacks layer weights on a leading L axis for `lax.scan`
(under `alt_dense_moe` two stacks, `layers_dense` and `layers_moe`,
scanned in pairs; encdec's `enc` and `dec`); here the layers are
`nn.ModuleList`s in the order they run, in a Python loop (the decoder's
in `layers`, so that the decode step keeps one loop;
`interop.params_from_arrays` splits the L axes and interleaves the two
MoE stacks). `remat=True` (the default, as in the reference) runs each
layer under `torch.utils.checkpoint.checkpoint` while gradients are on,
the counterpart of the reference's `jax.checkpoint` over the layer scan:
`flags.REMAT_POLICY` "full" keeps only a layer's input, "dots" its
unbatched matrix products too. Under `no_grad` (serving) there is nothing
to recompute, as with `jax.checkpoint` outside differentiation.

The activation constraints sit where the reference has them: the
embedding on the batch axes, the carry after each scan body (a layer, or
a pair under `alt_local_global` / `alt_dense_moe`) on batch and sequence,
each CE chunk's logits (`parallel/sharding.py`). They act only on DTensors
under an ambient mesh (`launch/dryrun.py`) and return their input itself
otherwise.

Weights are frozen (`requires_grad=False`) as built, so serving builds no
autograd graph; the train step turns gradients on for the model it
trains (`train/train_step.py`).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE
from repro_torch.parallel import sharding as SH

def layer_kind(cfg: ModelConfig, i: int) -> str:
    """Layer i's block (of `Model.layers`, the decoder's under encdec):
    "dense", "moe", "ssm", "hybrid" or "encdec"."""
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

    def forward(self, cfg: ModelConfig, x, positions, *, window: int,
                causal: bool = True):
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = self.attn(h, positions, cfg, causal=causal, window=window)
        x = x + a
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.ffn(h, cfg), kv


class MoELayer(DenseLayer):
    """The same block with the MoE FFN (`moe`) in place of the MLP."""

    def init_ffn(self, cfg: ModelConfig, dt, device, generator):
        self.moe = MOE.init_moe(cfg, dt, device, generator)

    def ffn(self, h, cfg: ModelConfig):
        return MOE.moe_ffn_a2a(self.moe, h, cfg)


class SSMLayer(nn.Module):
    """Pre-norm SSD mixer with its residual: ln1 -> ssm -> residual."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt = L.dtype_of(cfg)
        self.ln1 = L.zeros((cfg.d_model,), dt, device)
        self.ssm = M.init_ssm(cfg, dt, device, generator)

    def forward(self, cfg: ModelConfig, x, with_state: bool = False):
        """(x + y, (state [B,H,P,N], conv tail [B, W-1, ch]) or None
        without `with_state`)."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        if with_state:
            y, st = M.ssm_forward(self.ssm, h, cfg, return_final_state=True)
            return x + y, st
        return x + M.ssm_forward(self.ssm, h, cfg), None


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

    def forward(self, cfg: ModelConfig, x, positions,
                with_state: bool = False):
        """(x, ((k, v), (state, conv tail) or None without
        `with_state`))."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = self.attn(h, positions, cfg, window=cfg.sliding_window)
        if with_state:
            y, st = M.ssm_forward(self.ssm, h, cfg, return_final_state=True)
        else:
            y, st = M.ssm_forward(self.ssm, h, cfg), None
        x = x + 0.5 * (a + y)
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.mlp(h), (kv, st)


class DecoderLayer(nn.Module):
    """The encdec decoder's block: ln1 -> causal self-attention ->
    residual, lnx -> cross-attention to the encoder's memory -> residual,
    ln2 -> MLP -> residual."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt, d = L.dtype_of(cfg), cfg.d_model
        self.ln1 = L.zeros((d,), dt, device)
        self.attn = L.Attention(cfg, dt, device, generator)
        self.lnx = L.zeros((d,), dt, device)
        self.xattn = L.Attention(cfg, dt, device, generator)
        self.ln2 = L.zeros((d,), dt, device)
        self.mlp = L.MLP(d, cfg.d_ff, dt, device, generator)

    def forward(self, cfg: ModelConfig, x, positions, memory):
        """(x, ((k, v) self, (mk, mv) cross)): the cross keys and values
        are the memory's projections, not RoPE'd; the cross query is
        RoPE'd with `positions`, as in the JAX package's prefill."""
        h = L.rms_norm(x, self.ln1, cfg.norm_eps)
        a, kv = self.attn(h, positions, cfg)
        x = x + a
        h = L.rms_norm(x, self.lnx, cfg.norm_eps)
        mkv = self.xattn.kv(memory)
        c, _ = self.xattn(h, positions, cfg, causal=False, kv=mkv)
        x = x + c
        h = L.rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.mlp(h), (kv, mkv)


LAYERS = {"dense": DenseLayer, "moe": MoELayer, "ssm": SSMLayer,
          "hybrid": HybridLayer, "encdec": DecoderLayer}


class Model(nn.Module):
    """Embedding, `cfg.n_layers` layers (`layer_kind` of each) and the
    final norm; under encdec also the encoder's `n_enc_layers` dense
    blocks (`enc`) and its norm (`enc_norm`). With no `generator` the
    weights are left uninitialized (to be copied in)."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        super().__init__()
        dt = L.dtype_of(cfg)
        self.embed = L.Embedding(cfg, dt, device, generator)
        self.final_norm = L.zeros((cfg.d_model,), dt, device)
        if cfg.family == "encdec":
            self.enc = nn.ModuleList(
                DenseLayer(cfg, device, generator)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = L.zeros((cfg.d_model,), dt, device)
        self.layers = nn.ModuleList(
            LAYERS[layer_kind(cfg, i)](cfg, device, generator)
            for i in range(cfg.n_layers))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Model:
    """Random weights with the JAX package's shapes and scales, drawn from
    `generator` (on `device`); norm scales zero."""
    return Model(cfg, device, generator)


def param_shapes(cfg: ModelConfig) -> Model:
    """The model on the `meta` device: every parameter's name, shape and
    dtype, with no allocation (the reference's abstract init)."""
    return Model(cfg, device="meta")


def _stack(kvs):
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


def _positions(s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def _call(layer, remat: bool, *args, **kwargs):
    """`layer(*args, **kwargs)`, under activation checkpointing when
    `remat` and gradients are on: backward recomputes the layer from its
    input (and what `flags.REMAT_POLICY` saves)."""
    if remat and torch.is_grad_enabled():
        ctx = flags.remat_context_fn()
        extra = {} if ctx is None else {"context_fn": ctx}
        return checkpoint(layer, *args, use_reentrant=False, **extra,
                          **kwargs)
    return layer(*args, **kwargs)


def _per_body(cfg: ModelConfig) -> int:
    """Layers a scan body of the reference holds: 2 under
    `alt_local_global` / `alt_dense_moe`, else 1."""
    return 2 if cfg.alt_local_global or (cfg.family == "moe"
                                         and cfg.alt_dense_moe) else 1


def _carry(x):
    """The carry between scan bodies: batch on the batch axes, sequence on
    the sequence-parallel axis."""
    return SH.constrain_spec(x, "batch", "seq", None)


def encode(cfg: ModelConfig, params: Model, enc_x: torch.Tensor,
           remat: bool = True):
    """The encdec encoder: its dense blocks, non-causal and global, over
    `enc_x` [B, S_enc, D] with its own positions, then `enc_norm`."""
    positions = _positions(enc_x.shape[1], enc_x.device)
    for lp in params.enc:
        enc_x, _ = _call(lp, remat, cfg, enc_x, positions, window=0,
                         causal=False)
        enc_x = _carry(enc_x)
    return L.rms_norm(enc_x, params.enc_norm, cfg.norm_eps)


def forward_hidden(cfg: ModelConfig, params: Model, inputs: dict, *,
                   collect_cache: bool = False, remat: bool = True):
    """Full-sequence forward up to the final norm (pre-unembed).

    Returns (hidden [B,S,D], caches or None). inputs: tokens [B,S] int, or
    embeds [B,S,D] (the frontend stub; bf16 from the serving launcher
    whatever the model's dtype); encdec also takes enc_embeds
    [B,S_enc,D]. `remat` runs each layer (the encoder's too) under
    activation checkpointing while gradients are on. With `collect_cache`
    the caches, as the JAX package's scan returns them, each stacked on a
    leading layer axis:
      dense, moe       (k, v), each [L, B, S, K, h];
      alt_local_global (local (k, v), global (k, v)), [L/2, ...] each;
      alt_dense_moe    (dense (k, v), moe (k, v)), [L/2, ...] each;
      ssm              (state [L, B, H, P, N] fp32, conv tail
                        [L, B, W-1, ch]);
      hybrid           ((k, v), (state, conv tail));
      encdec           ((k, v) self, (mk, mv) cross [L, B, S_enc, K, h]).
    Without it no layer's cache outlives its layer.
    """
    if "embeds" in inputs:
        x = inputs["embeds"]
    else:
        x = params.embed.embed(inputs["tokens"])
    x = SH.constrain_batch(x)
    positions = _positions(x.shape[1], x.device)
    if cfg.family == "encdec":
        memory = encode(cfg, params, inputs["enc_embeds"], remat)
    kvs, states, cross = [], [], []
    per = _per_body(cfg)
    for i, lp in enumerate(params.layers):
        kind = layer_kind(cfg, i)
        kv = st = mkv = None
        if kind == "ssm":
            x, st = _call(lp, remat, cfg, x, with_state=collect_cache)
        elif kind == "hybrid":
            x, (kv, st) = _call(lp, remat, cfg, x, positions,
                                with_state=collect_cache)
        elif kind == "encdec":
            x, (kv, mkv) = _call(lp, remat, cfg, x, positions, memory)
        else:
            x, kv = _call(lp, remat, cfg, x, positions,
                          window=layer_window(cfg, i))
        if (i + 1) % per == 0:
            x = _carry(x)
        if collect_cache:
            for kept, c in ((kvs, kv), (states, st), (cross, mkv)):
                if c is not None:
                    kept.append(c)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if not collect_cache:
        return x, None
    if cfg.family == "ssm":
        return x, _stack(states)
    if cfg.family == "hybrid":
        return x, (_stack(kvs), _stack(states))
    if cfg.family == "encdec":
        return x, (_stack(kvs), _stack(cross))
    if cfg.alt_local_global or (cfg.family == "moe" and cfg.alt_dense_moe):
        return x, (_stack(kvs[0::2]), _stack(kvs[1::2]))
    return x, _stack(kvs)


def forward(cfg: ModelConfig, params: Model, inputs: dict, *,
            collect_cache: bool = False, remat: bool = True):
    """Full logits [B, S, V] (fp32) and the caches (tests and small-scale
    use; the serving path unembeds only the last position, the loss a
    chunk at a time)."""
    x, caches = forward_hidden(cfg, params, inputs,
                               collect_cache=collect_cache, remat=remat)
    return params.embed.logits(x, cfg), caches


def _chunk_nll(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Summed next-token cross-entropy of one chunk x [B, c, D] against
    labels [B, c], through its fp32 logits [B, c, V] (w: the unembedding
    [D, V])."""
    logits = SH.constrain_ce(L.unembed_logits(x, w, cfg))
    lse = torch.logsumexp(logits, dim=-1)
    return torch.sum(lse - _gold(logits, labels.long()))


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[b, c, labels[b, c]]."""
    return torch.gather(logits, -1, labels[..., None])[..., 0]


def nll_sum(w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, c: int) -> torch.Tensor:
    """The summed cross-entropy of x [B, S, D] against labels [B, S], in
    chunks of `c` positions (c divides S), each checkpointed: the peak is
    one chunk's [B, c, V] logits, in backward too."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, x.shape[1], c):
        total = total + checkpoint(_chunk_nll, w, x[:, c0:c0 + c],
                                   labels[:, c0:c0 + c], cfg,
                                   use_reentrant=False)
    return total


def loss_fn(cfg: ModelConfig, params: Model, batch: dict,
            loss_chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy (labels are pre-shifted), fp32.

    Every layer runs under activation checkpointing, as the reference's
    forward does. The unembedding and softmax-CE run in `loss_chunk`-long
    sequence chunks (`flags.LOSS_CHUNK` when set; `nll_sum`), each
    checkpointed too, so the [B, S, V] logits are never held. A chunk
    length that does not divide S becomes S (one chunk), as in the
    reference.
    """
    x, _ = forward_hidden(cfg, params, batch)
    b, s, _ = x.shape
    c = min(flags.LOSS_CHUNK or loss_chunk, s)
    if s % c:
        c = s
    return nll_sum(params.embed.out_weight(cfg), x, batch["labels"], cfg,
                   c) / (b * s)

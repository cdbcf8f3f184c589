"""Core transformer layers: norms, RoPE, chunked attention, SwiGLU MLP.

The JAX package's `models/layers.py` in PyTorch. Weights live in
`nn.Module`s (`Attention`, `MLP`, `Embedding`) with the reference's shapes
and scales; the functions keep its cast points, so that bf16 rounds where
it does there: `rms_norm` and `rope` compute in fp32 and cast back, the
attention scores and `p @ v` are fp32, and the unembedding is cast to fp32
before the final soft cap. A product of an activation and a weight of
another dtype (the frontend stubs' bf16 embeddings entering an fp32 model)
computes in the weight's dtype, as `jnp.einsum` promotes them. Prefill
attention is plain chunked PyTorch with running (max, sum, acc) over key
blocks (`F.scaled_dot_product_attention` has no soft cap); decode attention
is the hand-written kernel behind `kernels.ops.decode_attention`.

Shape glossary: B batch, S seq, D d_model, H q heads, K kv heads, h head dim,
F d_ff, V vocab.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import flags

NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, N, h]; positions: [B, S] or [S]."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq              # [B, S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------- attention --

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, q_chunk: int = 512,
                    k_chunk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Chunked attention with running softmax stats (no S x S buffer).

    q: [B, Sq, H, h]; k, v: [B, Sk, K, h] with H % K == 0 (GQA).
    `window` > 0 restricts to keys within `window` positions (local layers).
    Keys start at position 0 and queries at `q_offset` (a block of queries
    cut from a longer sequence: a rank's under sequence parallelism). A key
    block that no query of the chunk may see is skipped: its probabilities
    are 0 and it would leave (max, sum, acc) as they are.
    `flags.FLASH_CHUNK`, when set, is both block lengths.
    """
    if flags.FLASH_CHUNK:
        q_chunk = k_chunk = flags.FLASH_CHUNK
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, hk, g, hd)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        p0, p1 = q0 + q_offset, q1 + q_offset        # the chunk's positions
        q_pos = torch.arange(p0, p1, device=dev)
        m = torch.full((b, hk, g, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros((b, hk, g, q1 - q0), device=dev)
        acc = torch.zeros((b, hk, g, q1 - q0, hd), device=dev)
        for k0 in range(0, sk, k_chunk):
            k1 = min(k0 + k_chunk, sk)
            if causal and k0 > p1 - 1:
                break
            if window and k1 - 1 <= p0 - window:
                continue
            s = torch.einsum("bqkgh,bskh->bkgqs", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            s = softcap(s, logit_cap)
            k_pos = torch.arange(k0, k1, device=dev)
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p, vf[:, k0:k1])
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None]).permute(
            0, 3, 1, 2, 4))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     logit_cap: float = 0.0, return_lse: bool = False):
    """Single-token attention against a cache, through the kernel wrapper.

    q: [B, 1, H, h]; caches: [B, S, K, h]; cache_len: int32[B] valid lengths
    (ring-buffer local layers pass the full window). A row with
    cache_len 0 gives zeros (the kernel's semantics). With `return_lse`
    (out, lse [B, 1, H]), both fp32: the output not rounded and each
    head's log-sum-exp of its scores (-inf where cache_len is 0), for
    `combine_partials`.
    """
    b, _, hq, hd = q.shape
    hk = k_cache.shape[2]
    out = ops.decode_attention(q.reshape(b, hk, hq // hk, hd), k_cache,
                               v_cache, cache_len, logit_cap=logit_cap,
                               return_lse=return_lse)
    if not return_lse:
        return out.reshape(b, 1, hq, hd)
    out, lse = out
    return out.reshape(b, 1, hq, hd), lse.reshape(b, 1, hq)


def combine_partials(outs: torch.Tensor, lses: torch.Tensor,
                     dtype=None) -> torch.Tensor:
    """The attention over a cache cut into n sequence shards from each
    shard's: outs [n, ..., h] (each shard's softmax-weighted V, normalized
    over the shard, unrounded fp32 as `decode_attention(return_lse=True)`
    gives it) and lses [n, ...] (their log-sum-exps) -> [..., h] in
    `dtype` (outs' by default). Each shard weighs exp(lse_i - max lse),
    summed over the shards in fp32; a shard with no valid position (lse
    -inf) weighs 0, and with none anywhere the result is 0, as a row with
    cache_len 0 gives."""
    top = lses.amax(0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.exp(lses - top)                                   # [n, ...]
    acc = (w[..., None] * outs.float()).sum(0)
    out = acc / w.sum(0).clamp_min(1e-30)[..., None]
    return out.to(dtype or outs.dtype)


# ---------------------------------------------------------------- modules --

def weight(shape, std: float, dtype, device=None, generator=None):
    """A weight drawn N(0, std^2) in fp32 from `generator` and cast to
    `dtype` at once (so a full-width model never holds a full fp32 copy);
    uninitialized when `generator` is None (weights to be copied in).
    Built frozen (`requires_grad=False`): serving builds no autograd graph,
    and the train step turns gradients on for the model it trains."""
    if generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(std).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def stacked_weight(n: int, shape, std: float, dtype, device=None,
                   generator=None):
    """`n` weights of `shape` stacked on a leading axis ([n, *shape],
    the MoE expert stacks), each drawn as `weight` draws it, one at a time:
    the fp32 temporary is one entry, not the stack (llama4's [128, 5120,
    8192] stacks would need 21.5 GB of it). Frozen as `weight`'s."""
    t = torch.empty((n, *shape), dtype=dtype, device=device)
    if generator is not None:
        for i in range(n):
            t[i] = torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device).mul_(std)
    return nn.Parameter(t, requires_grad=False)


def zeros(shape, dtype, device=None):
    """A zero weight (the norm scales, applied as 1 + scale), frozen as
    `weight`'s."""
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, D] x [D, N, h] -> [B, S, N, h], in the weight's dtype."""
    return torch.einsum("bsd,dnh->bsnh", x.to(w.dtype), w)


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, N, h] x [N, h, D] -> [B, S, D], in the weight's dtype."""
    return torch.einsum("bsnh,nhd->bsd", o.to(wo.dtype), wo)


class Attention(nn.Module):
    """wq [D, H, h], wk/wv [D, K, h], wo [H, h, D]."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, generator=None):
        super().__init__()
        d, hq, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
        s = d ** -0.5
        self.wq = weight((d, hq, hd), s, dtype, device, generator)
        self.wk = weight((d, hk, hd), s, dtype, device, generator)
        self.wv = weight((d, hk, hd), s, dtype, device, generator)
        self.wo = weight((hq, hd, d), (hq * hd) ** -0.5, dtype, device,
                         generator)

    def kv(self, x: torch.Tensor):
        """[B, S, D] -> k and v [B, S, K, h] (no RoPE)."""
        return project(x, self.wk), project(x, self.wv)

    def qkv(self, x: torch.Tensor):
        """[B, S, D] -> q [B, S, H, h], k and v [B, S, K, h] (no RoPE)."""
        return (project(x, self.wq), *self.kv(x))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return _out(o, self.wo)

    def forward(self, x, positions, cfg: ModelConfig, *, causal: bool = True,
                window: int = 0, kv=None):
        """Full-sequence attention: (out [B, S, D], (k, v) for caching).
        `kv` overrides the keys and values (cross-attention to the
        encoder's memory): taken as given, with no RoPE; q is RoPE'd with
        `positions` either way."""
        if kv is None:
            q, k, v = self.qkv(x)
            k = rope(k, positions, cfg.rope_theta)
        else:
            q, (k, v) = project(x, self.wq), kv
        q = rope(q, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=causal, window=window,
                            logit_cap=cfg.attn_logit_softcap)
        return self.out(o), (k, v)


class MLP(nn.Module):
    """SwiGLU feed-forward: wg, wi [D, F], wo [F, D]."""

    def __init__(self, d: int, f: int, dtype, device=None, generator=None):
        super().__init__()
        self.wg = weight((d, f), d ** -0.5, dtype, device, generator)
        self.wi = weight((d, f), d ** -0.5, dtype, device, generator)
        self.wo = weight((f, d), f ** -0.5, dtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp(x, self.wg, self.wi, self.wo)


def _mlp(x, wg, wi, wo):
    """SwiGLU [..., D] -> [..., D], in the weights' dtype."""
    x = x.to(wg.dtype)
    gate = F.silu(x @ wg)
    return (gate * (x @ wi)) @ wo


class Embedding(nn.Module):
    """table [V, D] (std 0.02); the unembedding is its transpose when
    `cfg.tie_embeddings`, else its own weight `unembed` [D, V] (std
    D^-0.5)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, generator=None):
        super().__init__()
        self.table = weight((cfg.vocab, cfg.d_model), 0.02, dtype, device,
                            generator)
        if not cfg.tie_embeddings:
            self.unembed = weight((cfg.d_model, cfg.vocab),
                                  cfg.d_model ** -0.5, dtype, device,
                                  generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return lookup(self.table, tokens)

    def out_weight(self, cfg: ModelConfig) -> torch.Tensor:
        """The unembedding matrix [D, V]: the table's transpose when tied."""
        return self.table.t() if cfg.tie_embeddings else self.unembed

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The unembedding: [B, S, D] -> fp32 logits [B, S, V],
        soft-capped."""
        return unembed_logits(x, self.out_weight(cfg), cfg)


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of table [V, D] at tokens [B, S] -> [B, S, D]."""
    return table[tokens.long()]


def unembed_logits(x: torch.Tensor, w: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """x [..., D] times the unembedding w [D, V], as fp32 logits,
    soft-capped."""
    return softcap((x @ w).float(), cfg.final_logit_softcap)

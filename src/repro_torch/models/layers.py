"""Core transformer layers: norms, RoPE, chunked attention, SwiGLU MLP.

The JAX package's `models/layers.py` in PyTorch. Weights live in
`nn.Module`s (`Attention`, `MLP`, `Embedding`) with the reference's shapes
and scales; the functions keep its cast points, so that bf16 rounds where
it does there: `rms_norm` and `rope` compute in fp32 and cast back, the
attention scores and `p @ v` are fp32, and the unembedding is cast to fp32
before the final soft cap. Prefill attention is plain chunked PyTorch with
running (max, sum, acc) over key blocks (`F.scaled_dot_product_attention`
has no soft cap); decode attention is the hand-written kernel behind
`kernels.ops.decode_attention`.

Shape glossary: B batch, S seq, D d_model, H q heads, K kv heads, h head dim,
F d_ff, V vocab.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

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
                    k_chunk: int = 512) -> torch.Tensor:
    """Chunked attention with running softmax stats (no S x S buffer).

    q: [B, Sq, H, h]; k, v: [B, Sk, K, h] with H % K == 0 (GQA).
    `window` > 0 restricts to keys within `window` positions (local layers).
    Queries and keys start at position 0. A key block that no query of the
    chunk may see is skipped: its probabilities are 0 and it would leave
    (max, sum, acc) as they are.
    """
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = hq // hk
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(b, sq, hk, g, hd)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, sq, hk, g, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        q_pos = torch.arange(q0, q1, device=dev)
        m = torch.full((b, hk, g, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros((b, hk, g, q1 - q0), device=dev)
        acc = torch.zeros((b, hk, g, q1 - q0, hd), device=dev)
        for k0 in range(0, sk, k_chunk):
            k1 = min(k0 + k_chunk, sk)
            if causal and k0 > q1 - 1:
                break
            if window and k1 - 1 <= q0 - window:
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
        out[:, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).permute(
            0, 3, 1, 2, 4)
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     logit_cap: float = 0.0) -> torch.Tensor:
    """Single-token attention against a cache, through the kernel wrapper.

    q: [B, 1, H, h]; caches: [B, S, K, h]; cache_len: int32[B] valid lengths
    (ring-buffer local layers pass the full window). A row with
    cache_len 0 gives zeros (the kernel's semantics).
    """
    b, _, hq, hd = q.shape
    hk = k_cache.shape[2]
    out = ops.decode_attention(q.reshape(b, hk, hq // hk, hd), k_cache,
                               v_cache, cache_len, logit_cap=logit_cap)
    return out.reshape(b, 1, hq, hd)


# ---------------------------------------------------------------- modules --

def weight(shape, std: float, dtype, device=None, generator=None):
    """A frozen weight drawn N(0, std^2) in fp32 from `generator` and cast
    to `dtype` at once (so a full-width model never holds a full fp32
    copy); uninitialized when `generator` is None (weights to be copied
    in)."""
    if generator is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(std).to(dtype)
    return nn.Parameter(t, requires_grad=False)


def zeros(shape, dtype, device=None):
    """A frozen zero weight (the norm scales, applied as 1 + scale)."""
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


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

    def qkv(self, x: torch.Tensor):
        """[B, S, D] -> q [B, S, H, h], k and v [B, S, K, h] (no RoPE)."""
        return (torch.einsum("bsd,dnh->bsnh", x, self.wq),
                torch.einsum("bsd,dnh->bsnh", x, self.wk),
                torch.einsum("bsd,dnh->bsnh", x, self.wv))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bsnh,nhd->bsd", o, self.wo)

    def forward(self, x, positions, cfg: ModelConfig, *, window: int = 0):
        """Full-sequence causal attention: (out [B, S, D], (k, v) for
        caching)."""
        q, k, v = self.qkv(x)
        k = rope(k, positions, cfg.rope_theta)
        q = rope(q, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=True, window=window,
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
        gate = F.silu(x @ self.wg)
        return (gate * (x @ self.wi)) @ self.wo


class Embedding(nn.Module):
    """table [V, D] (std 0.02), tied: the unembedding is its transpose
    (every ported config ties them)."""

    def __init__(self, cfg: ModelConfig, dtype, device=None, generator=None):
        super().__init__()
        self.table = weight((cfg.vocab, cfg.d_model), 0.02, dtype, device,
                            generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens.long()]

    def unembed(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """[B, S, D] -> fp32 logits [B, S, V], soft-capped."""
        return softcap((x @ self.table.t()).float(), cfg.final_logit_softcap)

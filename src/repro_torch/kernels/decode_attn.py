"""Flash-decode attention: the CUDA kernel's launcher and its plain PyTorch
version.

Semantics (the JAX package's `decode_attention_pallas`): one query token
per head, q [B, K, g, h] with the g query heads of each kv head grouped,
against caches k, v [B, S, K, h]. Scores are fp32 dots scaled by h^-0.5
after the dot, soft-capped as `cap * tanh(s / cap)` when `logit_cap` is
set, then masked to the positions below `cache_len[b]`; the softmax and
the weighted sum of V are fp32, and the result is cast to q's dtype. A row
with `cache_len == 0` gives zeros, as the TPU kernel does (its softmax sum
is 0 and it divides by max(l, 1e-30)); the jnp decode attention of the JAX
package's `models/layers.py` returns the mean of V there instead. The model
path never passes 0 (`cache_len = min(pos + 1, wc) >= 1`).
`kernels.ops.decode_attention` picks between the two forms by the tensors'
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                          logit_cap: float = 0.0) -> torch.Tensor:
    """Launch `csrc/decode_attn.cu` on the current stream: out [B, K, g, h]
    in q's dtype (float32 or bfloat16, the caches' too), 1 <= h <= 256."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"decode_attention: q is {q.dtype}; the kernel "
                         f"takes {sorted(map(str, DTYPE_CODES))}")
    _build.require(q, q.dtype, 4, "decode_attention q")
    _build.require(k_cache, q.dtype, 4, "decode_attention k_cache")
    _build.require(v_cache, q.dtype, 4, "decode_attention v_cache")
    _build.require(cache_len, torch.int32, 1, "decode_attention cache_len")
    b, kk, g, h = q.shape
    s = k_cache.shape[1]
    if (tuple(k_cache.shape) != (b, s, kk, h) or v_cache.shape != k_cache.shape
            or cache_len.shape[0] != b or not 1 <= h <= MAX_HEAD_DIM
            or b > 65535):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, cache_len "
            f"{tuple(cache_len.shape)} do not fit (B <= 65535, "
            f"1 <= h <= {MAX_HEAD_DIM})")
    out = torch.empty_like(q)
    _build.launch("decode_attn", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
                  b, s, kk, g, h, h ** -0.5, float(logit_cap),
                  DTYPE_CODES[q.dtype], device=q.device.index,
                  stream=torch.cuda.current_stream(q.device).cuda_stream)
    return out


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                           logit_cap: float = 0.0) -> torch.Tensor:
    """The same function in PyTorch: q [B, K, g, h], caches [B, S, K, h],
    cache_len int32[B] -> [B, K, g, h] in q's dtype."""
    h = q.shape[-1]
    s = k_cache.shape[1]
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(),
                          k_cache.float()) * h ** -0.5
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    valid = (torch.arange(s, device=q.device)[None]
             < cache_len.to(q.device)[:, None])[:, None, None]   # [B,1,1,S]
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.where(valid, torch.exp(scores - scores.amax(-1, keepdim=True)),
                    0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.to(q.dtype)

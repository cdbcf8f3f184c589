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

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.contracts import KernelContractError

NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 16       # query heads per kv head in one block
# `kTile` and `kMaxSplits` in the source, which refuses a plan past either
TILE = 32            # positions per tile
MAX_SPLITS = 64
# `kThreads`, `kWarps` and `kMaxRowGroups` in the source; `stages_of`: the
# ring's stages by element type
THREADS = 256
WARPS = THREADS // 32
MAX_ROW_GROUPS = 16
STAGES = {"float32": 2, "bfloat16": 3}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}
GROUP_INSTANCES = (1, 2, 4, 8, 16)    # the template's GM >= g

# Per (device, stream): an int32 buffer of per-(b, kv head) counters that
# the kernel leaves at zero, so it is zeroed once, not on every call (a
# zeroing launch a call would add to a decode step that the host's launches
# already bound).
_counters: dict = {}
# Per (device, dtype, g, h): the kernel's blocks one SM holds at once.
_resident: dict = {}
# The plan of the last launch (nsplit, split_len, blocks, resident).
LAST_PLAN: dict = {}


def split_plan(b: int, kk: int, s: int, sms: int,
               resident: int) -> tuple[int, int]:
    """(nsplit, split_len): S cut into `nsplit` ranges of `split_len`
    positions, a multiple of TILE, so that the B * K * nsplit blocks come as
    close as they can to `resident` per SM (what one SM holds at once)
    without passing it: every block resident from the start, and no second
    round of blocks left to run on a few SMs at the end. From the shapes
    alone (not cache_len), so the launch shape is the same for every call
    at one shape."""
    tiles = max(1, -(-s // TILE))
    want = max(1, resident * sms // max(1, b * kk))
    per = -(-tiles // min(want, tiles, MAX_SPLITS))
    return -(-tiles // per), per * TILE


def group_instance(g: int) -> int:
    """The kernel instance's GM for g query heads (`dispatch` in the
    source): the smallest of GROUP_INSTANCES at least g."""
    for gm in GROUP_INSTANCES:
        if g <= gm:
            return gm
    raise ValueError(f"decode_attention: g = {g} > {MAX_GROUP}")


def shared_layout(dtype: str, g: int, h: int, nsplit: int) -> int:
    """Dynamic shared bytes a block asks for (the source's `Layout`): the
    ring of K/V stages (also holding the fold of the p.V subsets and the
    splits' combine), q, the warps' partial dots, p, and m/l/corr, each
    16-byte aligned. `dtype` "float32" or "bfloat16"."""
    esize = ELEMENT_BYTES[dtype]
    ce = 16 // esize
    ch = -(-h // ce)
    rb = (ch | 1) * 16
    npg = min(THREADS // ch, MAX_ROW_GROUPS)
    fold = npg * g * ch * ce * 4
    combine = (2 * nsplit + 1) * g * 4
    ring = max(2 * STAGES[dtype] * TILE * rb, fold)
    ring = ring if ring > combine else -(-combine // 16) * 16
    q = g * ch * ce * 4
    part = WARPS * g * TILE * 4
    p = g * TILE * 4
    stats = -(-(3 * g * 4) // 16) * 16
    return ring + q + part + p + stats


def resident_blocks(device: torch.device, dtype: torch.dtype, g: int,
                    h: int) -> int:
    """Blocks of the kernel one SM of `device` holds at once for this
    (dtype, g, h), from the CUDA occupancy calculator (registers and shared
    memory of the instance the launch picks); asked once per key."""
    key = (device.index, dtype, g, h)
    n = _resident.get(key)
    if n is None:
        out = ctypes.c_int(0)
        err = _build.function("decode_attn_resident", device.index)(
            g, h, DTYPE_CODES[dtype], ctypes.addressof(out), device.index)
        if err != 0 or out.value < 1:
            raise RuntimeError(f"repro_decode_attention_resident: cudaError_t "
                               f"{err}, {out.value} blocks per SM for "
                               f"g {g}, h {h}, {dtype}")
        n = _resident[key] = out.value
    return n


def _counter_buffer(device: torch.device, stream: int, n: int):
    buf = _counters.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[(device.index, stream)] = buf
    return buf


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                          logit_cap: float = 0.0, return_lse: bool = False):
    """Launch `csrc/decode_attn.cu` on the current stream: out [B, K, g, h]
    in q's dtype (float32 or bfloat16, the caches' too), 1 <= h <= 256,
    g <= 16; with `return_lse` (out, lse [B, K, g]), the scores'
    log-sum-exp (-inf where cache_len is 0) and the output both fp32, not
    rounded (to be combined with other shards'). S is split across blocks
    by `split_plan` (recorded in LAST_PLAN); the splits' fp32 partials go
    to scratch allocated here."""
    if q.dtype not in DTYPE_CODES:
        raise KernelContractError(
            f"decode_attention: q is {q.dtype}; the kernel takes "
            f"{sorted(map(str, DTYPE_CODES))}")
    _build.require(q, q.dtype, 4, "decode_attention q")
    _build.require(k_cache, q.dtype, 4, "decode_attention k_cache")
    _build.require(v_cache, q.dtype, 4, "decode_attention v_cache")
    _build.require(cache_len, torch.int32, 1, "decode_attention cache_len")
    b, kk, g, h = q.shape
    s = k_cache.shape[1]
    if (tuple(k_cache.shape) != (b, s, kk, h) or v_cache.shape != k_cache.shape
            or cache_len.shape[0] != b or not 1 <= h <= MAX_HEAD_DIM
            or not 1 <= g <= MAX_GROUP or b > 65535 or kk > 65535):
        raise KernelContractError(
            f"decode_attention: q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, cache_len "
            f"{tuple(cache_len.shape)} do not fit (B, K <= 65535, "
            f"1 <= g <= {MAX_GROUP}, 1 <= h <= {MAX_HEAD_DIM})")
    resident = resident_blocks(q.device, q.dtype, g, h)
    nsplit, split_len = split_plan(
        b, kk, s, torch.cuda.get_device_properties(q.device)
        .multi_processor_count, resident)
    LAST_PLAN.update(nsplit=nsplit, split_len=split_len,
                     blocks=b * kk * nsplit, resident=resident)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse
                      else q.dtype, device=q.device)
    lse = (torch.empty((b, kk, g), dtype=torch.float32, device=q.device)
           if return_lse else None)
    scratch = torch.empty(b * kk * nsplit * g * (h + 2), dtype=torch.float32,
                          device=q.device)
    counters = _counter_buffer(q.device, stream, b * kk)
    _build.launch("decode_attn", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  scratch.data_ptr(), counters.data_ptr(), b, s, kk, g, h,
                  nsplit, split_len, h ** -0.5, float(logit_cap),
                  DTYPE_CODES[q.dtype], device=q.device.index, stream=stream)
    return (out, lse) if return_lse else out


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                           logit_cap: float = 0.0, return_lse: bool = False):
    """The same function in PyTorch: q [B, K, g, h], caches [B, S, K, h],
    cache_len int32[B] -> [B, K, g, h] in q's dtype; with `return_lse`
    (out, lse [B, K, g]), both fp32, as the kernel gives them."""
    scores = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float())
    return attend(scores * q.shape[-1] ** -0.5, v_cache, cache_len,
                  logit_cap=logit_cap, return_lse=return_lse,
                  dtype=torch.float32 if return_lse else q.dtype)


def attend(scores: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor, *, logit_cap: float, dtype,
           return_lse: bool = False):
    """The plain form from its scaled fp32 scores [B, K, g, S] on: the soft
    cap, the mask of the positions from cache_len[b] on, the softmax and
    p.V -> [B, K, g, h] in `dtype` (and lse [B, K, g] = m + log l, -inf
    where no position is valid)."""
    s = scores.shape[-1]
    if logit_cap:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    valid = (torch.arange(s, device=scores.device)[None]
             < cache_len.to(scores.device)[:, None])[:, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    l = p.sum(-1, keepdim=True)
    p = p / l.clamp_min(1e-30)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float()).to(dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l))[..., 0]

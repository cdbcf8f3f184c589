"""Public wrappers for the kernels: empty tiles, V padding, dispatch.

Mirrors the JAX package's `kernels/ops.py`: the batched wrappers (a lane
axis, the ELL tile shared across lanes), the single-lane ones, and the
decode attention of the LLM serving path. An empty tile (R == 0 or
B == 0) returns empty outputs without a launch. The tensors' device
decides what runs: a CUDA tensor launches the hand-written kernel (or
raises), a CPU tensor runs the plain PyTorch version. There is no
fallback from one to the other. A single-lane kernel is a launch of its
batched kernel with B = 1, on views of the caller's tensors.

The JAX wrappers pad rows to the Pallas block (and hub tiles to 128
columns, V to whole blocks of flag words) and slice them back off; the
CUDA kernels take any shape, so nothing is padded here (the packing
kernel takes any V and any row start, the decode attention any cache
length S).

`LAUNCHES` counts kernel launches per wrapper; only a launch adds to it,
under a lock, so concurrent server workers lose no count.

The JAX wrappers also check that a lane's frontier fits the TPU's VMEM
(`check_frontier_residency`). That is a TPU limit with no counterpart here:
the CUDA kernels gather from device memory through L2. Their own limits
(shared memory, registers and threads a block, the grid) are the kernel
contracts' (`kernels/contracts.py`), which `GraphSession`'s gate checks
before a plan is built, and the launchers raise `KernelContractError`
subclasses on a shape they refuse.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import bottomup as _bu
from repro_torch.kernels import frontier_fused as _ff
from repro_torch.kernels import hub as _hub
from repro_torch.kernels import topdown as _td

LAUNCHES = {"bottomup_batch": 0, "topdown_batch": 0,
            "topdown_push_batch": 0, "frontier_fused_batch": 0,
            "hub_bottomup_batch": 0, "bottomup": 0, "topdown": 0,
            "topdown_push": 0, "frontier_fused": 0, "hub_bottomup": 0,
            "decode_attention": 0}


_launches_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    """One launch of wrapper `name`: `LAUNCHES[name] += 1` under the lock
    (the read-add-write is not atomic across threads)."""
    with _launches_lock:
        LAUNCHES[name] += 1


def _no_rows(b: int, device):
    return (torch.zeros((b, 0), dtype=torch.uint8, device=device),
            torch.zeros((b, 0), dtype=torch.int32, device=device))


# ----------------------------------------------------------- batched (lane) --


def bottomup_batch(deg, nbrs, frontier, *, slab: int = 32):
    """Batched bottom-up first-hit scan: (found uint8[B, R], parent int32[B, R]).

    `deg` int32[B, R] lane-masked degrees, `nbrs` int32[R, W] shared tile,
    `frontier` uint8[B, V] per lane. `slab` is kept for parity with the JAX
    wrapper: the first hit does not depend on it, and the kernel scans a
    row in chunks of its plan's group x 4 slots (`bottomup.pull_plan`).
    """
    del slab
    b, r = deg.shape
    if r == 0 or b == 0:
        return _no_rows(b, deg.device)
    if not deg.is_cuda:
        return _bu.bottomup_batch_plain(deg, nbrs, frontier)
    out = _bu.bottomup_batch_cuda(deg.contiguous(), nbrs, frontier)
    _count("bottomup_batch")
    return out


def hub_bottomup_batch(deg, nbrs, frontier):
    """Batched hub-side bottom-up: (found uint8[B, R], parent int32[B, R]).

    `deg` int32[B, R] per-lane cohort-masked degrees, `nbrs` int32[R, W]
    the shared (wide) hub tile, `frontier` uint8[B, V] per lane.
    """
    b, r = deg.shape
    if r == 0 or b == 0:
        return _no_rows(b, deg.device)
    if not deg.is_cuda:
        return _hub.hub_bottomup_batch_plain(deg, nbrs, frontier)
    out = _hub.hub_bottomup_batch_cuda(deg.contiguous(), nbrs, frontier)
    _count("hub_bottomup_batch")
    return out


def topdown_batch(deg, nbrs, visited):
    """Batched top-down visited-gather: fresh uint8[B, C, W].

    `deg` int32[B, C] cohort-masked, `nbrs` int32[C, W] shared, `visited`
    uint8[B, V] per lane. The TPU kernel's function; the BFS steps push
    through `topdown_push_batch`, which needs no [B, C, W] array.
    """
    b, c = deg.shape
    w = nbrs.shape[1]
    if c == 0 or b == 0:
        return torch.zeros((b, c, w), dtype=torch.uint8, device=deg.device)
    if not deg.is_cuda:
        return _td.topdown_batch_plain(deg, nbrs, visited)
    fresh = _td.topdown_batch_cuda(deg.contiguous(), nbrs, visited)
    _count("topdown_batch")
    return fresh


def topdown_push_batch(deg, nbrs, rows, visited, pcand, keep=None) -> None:
    """Batched push, in place: `pcand[lane, n] = min(pcand[lane, n],
    rows[row])` for every slot `col < deg[lane, row]` whose clipped
    neighbour `n` is unvisited in that lane (and `keep[n] != 0` if `keep`
    is given).

    `deg` int32[B, R] cohort-masked, `nbrs` int32[R, W] shared, `rows`
    int32[R] the tile's vertex ids, `visited` uint8[B, V] and `pcand`
    int32[B, V] per lane, `keep` uint8[V] or None. The result equals the
    JAX package's `topdown_batch` followed by its scatter-min, bit for bit.
    """
    b, r = deg.shape
    if r == 0 or b == 0:
        return
    if not deg.is_cuda:
        _td.topdown_push_batch_plain(deg, nbrs, rows, visited, pcand, keep)
        return
    _td.topdown_push_cuda(deg.contiguous(), nbrs, rows, visited, pcand, keep)
    _count("topdown_push_batch")


def frontier_fused_batch(flags, deg, *, packed=True):
    """Batched fused pack + count + edge mass:
    (packed uint32[B, ceil(V/32)], nf int32[B], mf int32[B]) for `flags`
    uint8[B, V] (rows contiguous, any V, any start) and `deg` int32[V].
    `packed=False` skips the bitmap and returns None in its place."""
    b, v = flags.shape
    if v == 0 or b == 0:
        return ((torch.zeros((b, 0), dtype=torch.uint32, device=flags.device)
                 if packed else None),
                torch.zeros(b, dtype=torch.int32, device=flags.device),
                torch.zeros(b, dtype=torch.int32, device=flags.device))
    if not flags.is_cuda:
        return _ff.frontier_fused_batch_plain(flags, deg, packed=packed)
    out = _ff.frontier_fused_batch_cuda(flags, deg, packed=packed)
    _count("frontier_fused_batch")
    return out


# --------------------------------------------------------------- one lane --


def bottomup(deg, nbrs, frontier, *, slab: int = 32):
    """Bottom-up first-hit scan of one lane: (found uint8[R], parent
    int32[R]) for `deg` int32[R] and `frontier` uint8[V]; `slab` as in
    `bottomup_batch`."""
    del slab
    if deg.shape[0] == 0:
        return tuple(t[0] for t in _no_rows(1, deg.device))
    if not deg.is_cuda:
        return _bu.bottomup_plain(deg, nbrs, frontier)
    found, parent = _bu.bottomup_batch_cuda(deg.contiguous()[None], nbrs,
                                            frontier[None])
    _count("bottomup")
    return found[0], parent[0]


def hub_bottomup(deg, nbrs, frontier):
    """Hub-side bottom-up of one lane: (found uint8[R], parent int32[R])."""
    if deg.shape[0] == 0:
        return tuple(t[0] for t in _no_rows(1, deg.device))
    if not deg.is_cuda:
        return _hub.hub_bottomup_plain(deg, nbrs, frontier)
    found, parent = _hub.hub_bottomup_batch_cuda(deg.contiguous()[None], nbrs,
                                                 frontier[None])
    _count("hub_bottomup")
    return found[0], parent[0]


def topdown(deg, nbrs, visited):
    """Top-down check of one lane: (fresh uint8[C, W], dst int32[C, W]) for
    `deg` int32[C] and `visited` uint8[V]; `dst = clip(nbrs, 0, V-1)`. The
    TPU kernel's function; the stepper pushes through `topdown_push`."""
    c, w = nbrs.shape
    if c == 0:
        return (torch.zeros((0, w), dtype=torch.uint8, device=deg.device),
                torch.zeros((0, w), dtype=torch.int32, device=deg.device))
    if not deg.is_cuda:
        return _td.topdown_plain(deg, nbrs, visited)
    out = _td.topdown_cuda(deg.contiguous(), nbrs, visited)
    _count("topdown")
    return out


def topdown_push(deg, nbrs, rows, visited, pcand, keep=None) -> None:
    """Push of one lane, in place: `deg` int32[R], `visited` uint8[V],
    `pcand` int32[V]; otherwise as `topdown_push_batch`."""
    if deg.shape[0] == 0:
        return
    if not deg.is_cuda:
        _td.topdown_push_plain(deg, nbrs, rows, visited, pcand, keep)
        return
    _td.topdown_push_cuda(deg.contiguous()[None], nbrs, rows, visited[None],
                          pcand[None], keep)
    _count("topdown_push")


def frontier_fused(flags, deg, *, packed=True):
    """Fused pack + count + edge mass of one lane: (packed
    uint32[ceil(V/32)], nf int32, mf int32), the counts 0-dim; the bitmap
    None with `packed=False`."""
    v = flags.shape[0]
    if v == 0:
        z = torch.zeros((), dtype=torch.int32, device=flags.device)
        return ((torch.zeros(0, dtype=torch.uint32, device=flags.device)
                 if packed else None), z, z)
    if not flags.is_cuda:
        return _ff.frontier_fused_plain(flags, deg, packed=packed)
    bitmap, nf, mf = _ff.frontier_fused_batch_cuda(flags[None], deg,
                                                   packed=packed)
    _count("frontier_fused")
    return (None if bitmap is None else bitmap[0]), nf[0], mf[0]


# ------------------------------------------------------------ LLM serving --


def decode_attention(q, k_cache, v_cache, cache_len, *, logit_cap=0.0,
                     return_lse=False):
    """Flash-decode attention: q [B, K, g, h] against caches [B, S, K, h]
    with valid lengths `cache_len` int32[B] -> [B, K, g, h] in q's dtype;
    with `return_lse` (out, lse [B, K, g]), both fp32: the output not
    rounded and the log-sum-exp of each head's scores (-inf where
    cache_len is 0), which combine the outputs of a cache cut into
    sequence shards (`models.layers.combine_partials`).

    An empty batch or cache returns zeros (and lse -inf) without a launch
    (the kernel would write zeros for S = 0 too).
    """
    # Lazy: the serving path's kernel stays out of the BFS path's imports,
    # as the JAX package's quarantine (DC001) keeps it.
    from repro_torch.kernels import decode_attn as _da

    if q.shape[0] == 0 or k_cache.shape[1] == 0:
        if not return_lse:
            return torch.zeros_like(q)
        return (torch.zeros(q.shape, device=q.device),
                torch.full(q.shape[:3], float("-inf"), device=q.device))
    if not q.is_cuda:
        return _da.decode_attention_plain(q, k_cache, v_cache, cache_len,
                                          logit_cap=logit_cap,
                                          return_lse=return_lse)
    out = _da.decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                    logit_cap=logit_cap,
                                    return_lse=return_lse)
    _count("decode_attention")
    return out

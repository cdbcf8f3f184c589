"""Bottom-up (pull) first-hit scan: the CUDA kernel's launcher and its
plain PyTorch version.

Semantics (the JAX package's `bottomup_batch_pallas`): for each lane and
ELL row, `found` iff some slot `< deg[lane, row]` holds a frontier vertex of
that lane; `parent` is the clipped neighbour id at the lowest such slot,
INT_MAX otherwise. `deg` int32[B, R] is lane-masked, `nbrs` int32[R, W] is
shared across lanes, `frontier` uint8[B, V] is per lane. Degrees never
exceed W (an ELL guarantee). `kernels.ops.bottomup_batch` picks between the
two by the tensors' device. One lane (the JAX package's `bottomup_pallas`)
is the same launch with B = 1 (`kernels.ops.bottomup`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

INT_MAX = 2**31 - 1


def bottomup_batch_cuda(deg: torch.Tensor, nbrs: torch.Tensor,
                        frontier: torch.Tensor):
    """Launch `csrc/bottomup.cu` on the current stream: (found uint8[B, R],
    parent int32[B, R]) for `deg` int32[B, R] and `nbrs` int32[R, W]."""
    _build.require(deg, torch.int32, 2, "bottomup deg")
    _build.require(nbrs, torch.int32, 2, "bottomup nbrs")
    _build.require(frontier, torch.uint8, 2, "bottomup frontier")
    b, r = deg.shape
    w = nbrs.shape[1]
    v = frontier.shape[1]
    if frontier.shape[0] != b or nbrs.shape[0] != r or v == 0:
        raise ValueError(f"bottomup: deg {tuple(deg.shape)}, nbrs "
                         f"{tuple(nbrs.shape)}, frontier "
                         f"{tuple(frontier.shape)} do not fit")
    found = torch.empty((b, r), dtype=torch.uint8, device=deg.device)
    parent = torch.empty((b, r), dtype=torch.int32, device=deg.device)
    _build.launch("bottomup", deg.data_ptr(), nbrs.data_ptr(),
                  frontier.data_ptr(), found.data_ptr(), parent.data_ptr(),
                  b, r, w, v, device=deg.device.index,
                  stream=torch.cuda.current_stream(deg.device).cuda_stream)
    return found, parent


def bottomup_batch_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                         frontier: torch.Tensor):
    """Full scan with no early exit (the JAX package's `bottomup_ref`,
    batched). Returns (found uint8[B, R], parent int32[B, R])."""
    b, r = deg.shape
    w = nbrs.shape[1]
    v = frontier.shape[1]
    if w == 0:
        return (torch.zeros((b, r), dtype=torch.uint8, device=deg.device),
                torch.full((b, r), INT_MAX, dtype=torch.int32,
                           device=deg.device))
    cols = torch.arange(w, dtype=torch.int32, device=deg.device)
    valid = cols[None, None, :] < deg[:, :, None]               # [B, R, W]
    safe = nbrs.clamp(0, v - 1)                                 # [R, W]
    lanes = torch.arange(b, device=deg.device)[:, None, None]
    hit = valid & (frontier[lanes, safe[None]] != 0)
    found = hit.any(dim=2)
    # argmax over uint8 returns the FIRST maximal index: the first hit.
    first = hit.to(torch.uint8).argmax(dim=2)
    parent = safe[None].expand(b, r, w).gather(2, first[:, :, None])[:, :, 0]
    parent = torch.where(found, parent, INT_MAX)
    return found.to(torch.uint8), parent


def bottomup_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                   frontier: torch.Tensor):
    """One lane (the JAX package's `bottomup_ref`): `deg` int32[R],
    `frontier` uint8[V] -> (found uint8[R], parent int32[R])."""
    found, parent = bottomup_batch_plain(deg[None], nbrs, frontier[None])
    return found[0], parent[0]

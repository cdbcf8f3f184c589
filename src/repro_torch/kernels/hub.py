"""Hub-side bottom-up (pull) first-hit scan: its launcher (the pull kernel
of `kernels.bottomup`, which takes every width) and its plain PyTorch
version.

Semantics (the JAX package's `hub_bottomup_batch_pallas`, and
`hub_bottomup_pallas` for one lane): those of `kernels.bottomup`. For each
lane and hub ELL row, `found` iff some slot `< deg[lane, row]` holds a
frontier vertex of that lane; `parent` is the clipped neighbour id at the
lowest such slot, INT_MAX otherwise. The hub split (`BFSConfig.hub_split`)
sends its hub buckets here: few rows, each up to the widest ELL bucket.
`kernels.ops.hub_bottomup_batch` and `kernels.ops.hub_bottomup` pick
between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bottomup as _bu

# Slots the plain version expands at once: B * rows * W, rows chunked.
PLAIN_CHUNK_SLOTS = 1 << 26


def hub_bottomup_batch_cuda(deg: torch.Tensor, nbrs: torch.Tensor,
                            frontier: torch.Tensor):
    """Launch the pull kernel (`csrc/bottomup.cu`, which takes every width)
    on the current stream: (found uint8[B, R], parent int32[B, R]) for
    `deg` int32[B, R] and the hub tile `nbrs` int32[R, W]."""
    return _bu.pull_cuda(deg, nbrs, frontier, "hub_bottomup")


def hub_bottomup_batch_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                             frontier: torch.Tensor):
    """Full scan plus first hit (the JAX package's dense hub pass), as
    `bottomup.bottomup_batch_plain` over chunks of rows, so that the
    [B, rows, W] temporaries stay near `PLAIN_CHUNK_SLOTS` at hub widths."""
    b, r = deg.shape
    rows = max(1, PLAIN_CHUNK_SLOTS // max(1, b * nbrs.shape[1]))
    if rows >= r:
        return _bu.bottomup_batch_plain(deg, nbrs, frontier)
    parts = [_bu.bottomup_batch_plain(deg[:, i:i + rows], nbrs[i:i + rows],
                                      frontier)
             for i in range(0, r, rows)]
    return (torch.cat([f for f, _ in parts], dim=1),
            torch.cat([p for _, p in parts], dim=1))


def hub_bottomup_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                       frontier: torch.Tensor):
    """One lane (the JAX package's `hub_bottomup_pallas`): `deg` int32[R],
    `frontier` uint8[V] -> (found uint8[R], parent int32[R])."""
    found, parent = hub_bottomup_batch_plain(deg[None], nbrs, frontier[None])
    return found[0], parent[0]

"""Top-down (push) visited-gather: the CUDA kernel's launcher and its plain
PyTorch version.

Semantics (the JAX package's `topdown_batch_pallas`):
`fresh[lane, row, col] = col < deg[lane, row] & visited[lane, clip(nbr)] == 0`
with `deg` int32[B, C] lane-masked, `nbrs` int32[C, W] shared and `visited`
uint8[B, V] per lane. The batched caller keeps `dst = clip(nbrs)` and the
scatters. One lane (the JAX package's `topdown_pallas`) also returns
`dst int32[C, W]`, which the kernel writes beside `fresh`.
`kernels.ops.topdown_batch` and `kernels.ops.topdown` pick between the two
by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _launch(deg, nbrs, visited, dst):
    """`csrc/topdown.cu` for `deg` int32[B, C] and `visited` uint8[B, V]:
    fresh uint8[B, C, W]; the kernel also fills `dst` (int32[C, W]) unless
    it is None."""
    _build.require(deg, torch.int32, 2, "topdown deg")
    _build.require(nbrs, torch.int32, 2, "topdown nbrs")
    _build.require(visited, torch.uint8, 2, "topdown visited")
    b, c = deg.shape
    w = nbrs.shape[1]
    v = visited.shape[1]
    if visited.shape[0] != b or nbrs.shape[0] != c or v == 0:
        raise ValueError(f"topdown: deg {tuple(deg.shape)}, nbrs "
                         f"{tuple(nbrs.shape)}, visited "
                         f"{tuple(visited.shape)} do not fit")
    fresh = torch.empty((b, c, w), dtype=torch.uint8, device=deg.device)
    vec = int(w % 16 == 0 and fresh.data_ptr() % 16 == 0)
    _build.launch("topdown", deg.data_ptr(), nbrs.data_ptr(),
                  visited.data_ptr(), fresh.data_ptr(),
                  None if dst is None else dst.data_ptr(), b, c, w, v, vec,
                  device=deg.device.index,
                  stream=torch.cuda.current_stream(deg.device).cuda_stream)
    return fresh


def topdown_batch_cuda(deg: torch.Tensor, nbrs: torch.Tensor,
                       visited: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/topdown.cu` on the current stream: fresh uint8[B, C, W]
    for `deg` int32[B, C] and `nbrs` int32[C, W]."""
    return _launch(deg, nbrs, visited, None)


def topdown_cuda(deg: torch.Tensor, nbrs: torch.Tensor,
                 visited: torch.Tensor):
    """One lane, B = 1 on the current stream: (fresh uint8[C, W], dst
    int32[C, W]) for `deg` int32[C] and `visited` uint8[V]."""
    dst = torch.empty(tuple(nbrs.shape), dtype=torch.int32,
                      device=nbrs.device)
    fresh = _launch(deg[None], nbrs, visited[None], dst)
    return fresh[0], dst


def topdown_batch_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                        visited: torch.Tensor) -> torch.Tensor:
    """The JAX package's `topdown_ref`, batched: fresh uint8[B, C, W]."""
    b = deg.shape[0]
    w = nbrs.shape[1]
    v = visited.shape[1]
    cols = torch.arange(w, dtype=torch.int32, device=deg.device)
    valid = cols[None, None, :] < deg[:, :, None]               # [B, C, W]
    safe = nbrs.clamp(0, v - 1)
    lanes = torch.arange(b, device=deg.device)[:, None, None]
    return (valid & (visited[lanes, safe[None]] == 0)).to(torch.uint8)


def topdown_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                  visited: torch.Tensor):
    """One lane (the JAX package's `topdown_ref`): (fresh uint8[C, W], dst
    int32[C, W] = clip(nbrs, 0, V-1))."""
    fresh = topdown_batch_plain(deg[None], nbrs, visited[None])
    return fresh[0], nbrs.clamp(0, visited.shape[0] - 1)

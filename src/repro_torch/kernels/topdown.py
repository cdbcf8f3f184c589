"""Top-down (push): the CUDA kernels' launchers and their plain PyTorch
versions, for the two entry points of `csrc/topdown.cu`.

The fresh entry (the JAX package's `topdown_batch_pallas`):
`fresh[lane, row, col] = col < deg[lane, row] & visited[lane, clip(nbr)] == 0`
with `deg` int32[B, C] lane-masked, `nbrs` int32[C, W] shared and `visited`
uint8[B, V] per lane. One lane (the JAX package's `topdown_pallas`) also
returns `dst int32[C, W]`, which the kernel writes beside `fresh`.

The push entry, what the BFS steps launch: the fresh test and the
reference caller's scatter-min in one pass, in place on `pcand` int32[B, V]:
`pcand[lane, n] = min(pcand[lane, n], rows[row])` for every fresh slot
(`n = clip(nbr)`), where `keep` uint8[V], if given, also holds at `n`.

`kernels.ops` picks between a kernel and its plain version by the tensors'
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

INT_MAX = 2**31 - 1


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


def topdown_push_cuda(deg: torch.Tensor, nbrs: torch.Tensor,
                      rows: torch.Tensor, visited: torch.Tensor,
                      pcand: torch.Tensor, keep=None) -> None:
    """Launch the push of `csrc/topdown.cu` on the current stream: `pcand`
    int32[B, V] takes the min of itself and the row id of every fresh slot,
    for `deg` int32[B, R], `nbrs` int32[R, W], `rows` int32[R], `visited`
    uint8[B, V] and `keep` uint8[V] or None."""
    _build.require(deg, torch.int32, 2, "topdown_push deg")
    _build.require(nbrs, torch.int32, 2, "topdown_push nbrs")
    _build.require(rows, torch.int32, 1, "topdown_push rows")
    _build.require(visited, torch.uint8, 2, "topdown_push visited")
    _build.require(pcand, torch.int32, 2, "topdown_push pcand")
    if keep is not None:
        _build.require(keep, torch.uint8, 1, "topdown_push keep")
    b, r = deg.shape
    w = nbrs.shape[1]
    v = visited.shape[1]
    if (nbrs.shape[0] != r or rows.shape[0] != r or visited.shape[0] != b
            or pcand.shape != visited.shape or v == 0
            or (keep is not None and keep.shape[0] != v)):
        raise ValueError(
            f"topdown_push: deg {tuple(deg.shape)}, nbrs {tuple(nbrs.shape)}, "
            f"rows {tuple(rows.shape)}, visited {tuple(visited.shape)}, "
            f"pcand {tuple(pcand.shape)}, keep "
            f"{None if keep is None else tuple(keep.shape)} do not fit")
    _build.launch("topdown_push", deg.data_ptr(), nbrs.data_ptr(),
                  rows.data_ptr(), visited.data_ptr(), pcand.data_ptr(),
                  None if keep is None else keep.data_ptr(), b, r, w, v,
                  device=deg.device.index,
                  stream=torch.cuda.current_stream(deg.device).cuda_stream)


def topdown_push_batch_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                             rows: torch.Tensor, visited: torch.Tensor,
                             pcand: torch.Tensor, keep=None) -> None:
    """The JAX package's composite: `topdown_batch`, the `keep` mask of the
    destinations, then `pcand.at[:, dst].min(where(fresh, rows, INT_MAX))`,
    here an int32 `scatter_reduce_("amin")` in place on `pcand`."""
    b, v = visited.shape
    fresh = topdown_batch_plain(deg, nbrs, visited)              # [B, R, W]
    dst = nbrs.clamp(0, v - 1).reshape(-1).to(torch.int64)    # for every lane
    if keep is not None:
        fresh = fresh & keep[dst].reshape(nbrs.shape)[None]
    src = torch.where(fresh != 0, rows[None, :, None], INT_MAX)
    pcand.scatter_reduce_(1, dst[None].expand(b, -1), src.reshape(b, -1),
                          "amin", include_self=True)


def topdown_push_plain(deg: torch.Tensor, nbrs: torch.Tensor,
                       rows: torch.Tensor, visited: torch.Tensor,
                       pcand: torch.Tensor, keep=None) -> None:
    """One lane: `deg` int32[R], `visited` uint8[V], `pcand` int32[V]."""
    topdown_push_batch_plain(deg[None], nbrs, rows, visited[None],
                             pcand[None], keep)

"""Bitmap frontier representation and helpers.

Compute runs on byte flags (uint8[V], 0/1); the packed uint32 bitmap
(little-bit-endian: bit i of word w is flag 32w+i) is the compact wire
format. `torch.uint32` supports few operations, so words are built and
taken apart in int64 and only stored as uint32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

def num_words(num_vertices: int) -> int:
    return (num_vertices + 31) // 32


def pack(flags: torch.Tensor) -> torch.Tensor:
    """uint8[..., V] 0/1 -> uint32[..., ceil(V/32)] little-bit-endian bitmap
    (packs along the last axis)."""
    pad = (-flags.shape[-1]) % 32
    f = F.pad((flags != 0).to(torch.int64), (0, pad))
    f = f.view(*flags.shape[:-1], -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    return (f << shifts).sum(dim=-1).to(torch.uint32)


def unpack(bitmap: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """uint32[W] -> uint8[V] 0/1."""
    words = bitmap.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bitmap.device)
    bits = (words[:, None] >> shifts) & 1
    return bits.reshape(-1)[:num_vertices].to(torch.uint8)


def popcount(bitmap: torch.Tensor) -> torch.Tensor:
    """Total set bits of a uint32 bitmap, as an int32 scalar."""
    return unpack(bitmap, bitmap.shape[0] * 32).sum().to(torch.int32)


def count(flags: torch.Tensor) -> torch.Tensor:
    """Number of set flags, int32 (torch's integer sum widens to int64)."""
    return (flags != 0).sum().to(torch.int32)


def edge_count(flags: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Number of edges incident to flagged vertices (frontier edge mass)."""
    return torch.where(flags != 0, degrees.to(torch.int64), 0).sum().to(
        torch.int32)


def compact(flags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact flagged vertex ids into a fixed-capacity queue.

    Returns (queue int32[V] with valid entries first and V-fill after, n).
    Static shapes: a cumsum and a scatter into a [V+1] buffer whose last
    slot absorbs the unflagged ids, so no host sync is needed.
    """
    v = flags.shape[0]
    on = flags != 0
    pos = torch.cumsum(on.to(torch.int64), dim=0) - 1
    n = (pos[-1] + 1 if v else torch.zeros((), dtype=torch.int64,
                                             device=flags.device))
    queue = torch.full((v + 1,), v, dtype=torch.int32, device=flags.device)
    idx = torch.where(on, pos, v)
    queue.scatter_(0, idx, torch.arange(v, dtype=torch.int32,
                                        device=flags.device))
    queue[v] = v
    return queue[:v], n.to(torch.int32)

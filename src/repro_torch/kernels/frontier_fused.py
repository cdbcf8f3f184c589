"""Fused frontier pack + statistics: the CUDA kernel's launcher and its
plain PyTorch version.

Semantics (the JAX package's `frontier_fused_batch_pallas`): per lane, the
0/1 flags packed into little-bit-endian uint32 words, `nf` = the number of
set flags and `mf` = the sum of `deg` over them, both int32 (wrapping like
the reference's int32 sums). `flags` uint8[B, V] per lane, `deg` int32[V]
shared. `kernels.ops.frontier_fused_batch` pads V for the kernel and picks
between the two by the tensors' device. One lane (the JAX package's
`frontier_fused_pallas`, with 0-dim `nf`/`mf`) is the same launch with
B = 1 (`kernels.ops.frontier_fused`).
"""
from __future__ import annotations

import torch

from repro_torch.core import frontier as fr
from repro_torch.kernels import _build


def frontier_fused_batch_cuda(flags: torch.Tensor, deg: torch.Tensor):
    """Launch `csrc/frontier_fused.cu` on the current stream.

    V must be a multiple of 32 with 16-byte aligned rows (the wrapper pads).
    Returns (packed uint32[B, V/32], nf int32[B], mf int32[B]).
    """
    _build.require(flags, torch.uint8, 2, "frontier_fused flags")
    _build.require(deg, torch.int32, 1, "frontier_fused deg")
    b, v = flags.shape
    if v % 32 or deg.shape[0] != v or flags.data_ptr() % 16 \
            or deg.data_ptr() % 16:
        raise ValueError(f"frontier_fused: flags {tuple(flags.shape)} and deg "
                         f"{tuple(deg.shape)} need V % 32 == 0 and 16-byte "
                         f"aligned storage")
    packed = torch.empty((b, v // 32), dtype=torch.uint32, device=flags.device)
    nf = torch.zeros(b, dtype=torch.int32, device=flags.device)
    mf = torch.zeros(b, dtype=torch.int32, device=flags.device)
    _build.launch("frontier_fused", flags.data_ptr(), deg.data_ptr(),
                  packed.data_ptr(), nf.data_ptr(), mf.data_ptr(), b, v,
                  device=flags.device.index,
                  stream=torch.cuda.current_stream(flags.device).cuda_stream)
    return packed, nf, mf


def frontier_fused_batch_plain(flags: torch.Tensor, deg: torch.Tensor):
    """Pack + count + edge mass per lane, as three plain passes (the JAX
    package's `frontier_fused_ref`, batched)."""
    packed = fr.pack(flags)
    on = flags != 0
    nf = on.sum(dim=1).to(torch.int32)
    mf = torch.where(on, deg.to(torch.int64)[None, :], 0).sum(dim=1).to(
        torch.int32)
    return packed, nf, mf


def frontier_fused_plain(flags: torch.Tensor, deg: torch.Tensor):
    """One lane: `flags` uint8[V] -> (packed uint32[ceil(V/32)], nf int32,
    mf int32), the counts 0-dim."""
    packed, nf, mf = frontier_fused_batch_plain(flags[None], deg)
    return packed[0], nf[0], mf[0]

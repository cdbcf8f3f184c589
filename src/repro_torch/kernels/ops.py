"""Public wrappers for the batched kernels: empty tiles, V padding, dispatch.

Mirrors the JAX package's `kernels/ops.py` batch wrappers. An empty tile
(R == 0 or B == 0) returns empty outputs without a launch. The tensors'
device decides what runs: a CUDA tensor launches the hand-written kernel
(or raises), a CPU tensor runs the plain PyTorch version. There is no
fallback from one to the other.

The JAX wrappers pad rows to the Pallas block and slice them back off; the
CUDA kernels take any row count, so rows are not padded here. Only the
packing kernel pads V, to whole 32-flag words.

`LAUNCHES` counts kernel launches per kernel; only a launch adds to it.

The JAX wrappers also check that a lane's frontier fits the TPU's VMEM
(`check_frontier_residency`). That is a TPU limit with no counterpart here:
the CUDA kernels gather from device memory through L2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import bottomup as _bu
from repro_torch.kernels import frontier_fused as _ff
from repro_torch.kernels import topdown as _td

LAUNCHES = {"bottomup_batch": 0, "topdown_batch": 0,
            "frontier_fused_batch": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pad_words(x: torch.Tensor) -> torch.Tensor:
    """`x` padded with zeros along its last axis to a multiple of 32, as a
    contiguous tensor (the packing kernel's input layout)."""
    pad = (-x.shape[-1]) % 32
    return (F.pad(x, (0, pad)) if pad else x).contiguous()


def bottomup_batch(deg, nbrs, frontier, *, slab: int = 32):
    """Batched bottom-up first-hit scan: (found uint8[B, R], parent int32[B, R]).

    `deg` int32[B, R] lane-masked degrees, `nbrs` int32[R, W] shared tile,
    `frontier` uint8[B, V] per lane. `slab` is kept for parity with the JAX
    wrapper: the first hit does not depend on it, and the kernel scans 32
    slots per warp step.
    """
    del slab
    b, r = deg.shape
    if r == 0 or b == 0:
        return (torch.zeros((b, 0), dtype=torch.uint8, device=deg.device),
                torch.zeros((b, 0), dtype=torch.int32, device=deg.device))
    if not deg.is_cuda:
        return _bu.bottomup_batch_plain(deg, nbrs, frontier)
    out = _bu.bottomup_batch_cuda(deg.contiguous(), nbrs, frontier)
    LAUNCHES["bottomup_batch"] += 1
    return out


def topdown_batch(deg, nbrs, visited):
    """Batched top-down visited-gather: fresh uint8[B, C, W].

    `deg` int32[B, C] cohort-masked, `nbrs` int32[C, W] shared, `visited`
    uint8[B, V] per lane. The lane-invariant `clip(nbrs, 0, V-1)` is the
    caller's to compute once.
    """
    b, c = deg.shape
    w = nbrs.shape[1]
    if c == 0 or b == 0:
        return torch.zeros((b, c, w), dtype=torch.uint8, device=deg.device)
    if not deg.is_cuda:
        return _td.topdown_batch_plain(deg, nbrs, visited)
    fresh = _td.topdown_batch_cuda(deg.contiguous(), nbrs, visited)
    LAUNCHES["topdown_batch"] += 1
    return fresh


def frontier_fused_batch(flags, deg):
    """Batched fused pack + count + edge mass:
    (packed uint32[B, ceil(V/32)], nf int32[B], mf int32[B])."""
    b, v = flags.shape
    if v == 0 or b == 0:
        return (torch.zeros((b, 0), dtype=torch.uint32, device=flags.device),
                torch.zeros(b, dtype=torch.int32, device=flags.device),
                torch.zeros(b, dtype=torch.int32, device=flags.device))
    if not flags.is_cuda:
        return _ff.frontier_fused_batch_plain(flags, deg)
    out = _ff.frontier_fused_batch_cuda(pad_words(flags), pad_words(deg))
    LAUNCHES["frontier_fused_batch"] += 1
    return out

"""Fused frontier pack + statistics: the CUDA kernel's launch plan and
launcher, and its plain PyTorch version.

Semantics (the JAX package's `frontier_fused_batch_pallas`): per lane, the
0/1 flags packed into little-bit-endian uint32 words, `nf` = the number of
set flags and `mf` = the sum of `deg` over them, both int32 (wrapping like
the reference's int32 sums). `flags` uint8[B, V] per lane, `deg` int32[V]
shared. `packed=False` leaves the bitmap out (None in its place), which
the BFS paths ask for: they read only `nf` and `mf`.
`kernels.ops.frontier_fused_batch` picks between the two by the tensors'
device. One lane (the JAX package's `frontier_fused_pallas`, with 0-dim
`nf`/`mf`) is the same launch with B = 1 (`kernels.ops.frontier_fused`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import frontier as fr
from repro_torch.kernels import _build

# `kThreads` and `kMaxBlocks` in the source: threads per block (one word
# each a tile), blocks a lane group at most
THREADS = 256
MAX_BLOCKS = 4096
MAX_GROUPS = 65535        # lane groups along grid y

# Per (device, lanes_block, packed): blocks of the kernel one SM holds.
_resident: dict = {}
# Per (device, stream): the 64-bit accumulators, two a lane, zero between
# launches (the kernel leaves them zero), so they are zeroed once, when
# they are made.
_accumulators: dict = {}
# The plan of the last launch.
LAST_PLAN: dict = {}


def lane_block(b: int) -> int:
    """The source's instance for B lanes: lanes a block packs (`kLanes`)."""
    return 1 if b == 1 else (2 if b == 2 else (4 if b <= 4 else 8))


def fused_plan(b: int, v: int, sms: int, resident: int) -> dict:
    """The launch shape for B lanes of V flags on `sms` SMs that each hold
    `resident` blocks: `groups` lane groups of `lanes_block` lanes along
    grid y; `tiles` of `tile_words` words (THREADS words in all) a group;
    along x `blocks` blocks a group, as many as the SMs hold (shared among
    the groups), as there are tiles, or MAX_BLOCKS, whichever is fewest."""
    lb = lane_block(b)
    groups = -(-b // lb)
    tile_words = THREADS // lb
    tiles = -(-fr.num_words(v) // tile_words)
    blocks = max(1, min(tiles, -(-(sms * resident) // groups), MAX_BLOCKS))
    return dict(lanes_block=lb, groups=groups, tile_words=tile_words,
                tiles=tiles, blocks=blocks)


def resident_blocks(device: torch.device, lanes_block: int,
                    packed: bool) -> int:
    """Blocks of the (lanes_block, packed) instance one SM of `device`
    holds at once, from the CUDA occupancy calculator; asked once per
    key."""
    key = (device.index, lanes_block, packed)
    n = _resident.get(key)
    if n is None:
        out = ctypes.c_int(0)
        err = _build.function("frontier_fused_resident")(
            lanes_block, int(packed), ctypes.addressof(out), device.index)
        if err != 0 or out.value < 1:
            raise RuntimeError(f"repro_frontier_fused_resident: cudaError_t "
                               f"{err}, {out.value} blocks per SM")
        n = _resident[key] = out.value
    return n


def _accumulator_buffer(device: torch.device, stream: int,
                        n: int) -> torch.Tensor:
    buf = _accumulators.get((device.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int64, device=device)
        _accumulators[(device.index, stream)] = buf
    return buf


def frontier_fused_batch_cuda(flags: torch.Tensor, deg: torch.Tensor, *,
                              packed: bool = True):
    """Launch `csrc/frontier_fused.cu` on the current stream, in the shape
    `fused_plan` gives (recorded in LAST_PLAN): (packed uint32[B,
    ceil(V/32)] or None, nf int32[B], mf int32[B]). `flags` uint8[B, V]
    may start anywhere and have any row stride, as long as each row is
    contiguous; `deg` int32[V] contiguous. The outputs come from
    `torch.empty`: the one launch writes them whole."""
    if (not flags.is_cuda or flags.dtype != torch.uint8 or flags.dim() != 2
            or (flags.shape[1] > 1 and flags.stride(1) != 1)):
        raise ValueError(
            f"frontier_fused flags: want a CUDA uint8 tensor [B, V] with "
            f"contiguous rows, got {flags.dtype} {tuple(flags.shape)} "
            f"stride {flags.stride()} on {flags.device}")
    _build.require(deg, torch.int32, 1, "frontier_fused deg")
    b, v = flags.shape
    dev = flags.device
    if deg.shape[0] != v or deg.device != dev or b < 1 or v < 1:
        raise ValueError(f"frontier_fused: flags {tuple(flags.shape)} on "
                         f"{dev} and deg {tuple(deg.shape)} on {deg.device} "
                         f"do not fit")
    lb = lane_block(b)
    if -(-b // lb) > MAX_GROUPS:
        raise ValueError(f"frontier_fused: {b} lanes, more than "
                         f"{MAX_GROUPS} groups of {lb}")
    plan = fused_plan(
        b, v, torch.cuda.get_device_properties(dev).multi_processor_count,
        resident_blocks(dev, lb, packed))
    LAST_PLAN.clear()
    LAST_PLAN.update(plan)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bitmap = (torch.empty((b, fr.num_words(v)), dtype=torch.uint32,
                          device=dev) if packed else None)
    nf = torch.empty(b, dtype=torch.int32, device=dev)
    mf = torch.empty(b, dtype=torch.int32, device=dev)
    acc = _accumulator_buffer(dev, stream, plan["groups"] * 2 * lb)
    _build.launch("frontier_fused", flags.data_ptr(), deg.data_ptr(),
                  None if bitmap is None else bitmap.data_ptr(),
                  nf.data_ptr(), mf.data_ptr(), acc.data_ptr(), b, v,
                  flags.stride(0), lb, plan["blocks"], device=dev.index,
                  stream=stream)
    return bitmap, nf, mf


def frontier_fused_batch_plain(flags: torch.Tensor, deg: torch.Tensor, *,
                               packed: bool = True):
    """Pack + count + edge mass per lane, as three plain passes (the JAX
    package's `frontier_fused_ref`, batched); the bitmap None unless
    `packed`."""
    on = flags != 0
    nf = on.sum(dim=1).to(torch.int32)
    mf = torch.where(on, deg.to(torch.int64)[None, :], 0).sum(dim=1).to(
        torch.int32)
    return (fr.pack(flags) if packed else None), nf, mf


def frontier_fused_plain(flags: torch.Tensor, deg: torch.Tensor, *,
                         packed: bool = True):
    """One lane: `flags` uint8[V] -> (packed uint32[ceil(V/32)] or None,
    nf int32, mf int32), the counts 0-dim."""
    bitmap, nf, mf = frontier_fused_batch_plain(flags[None], deg,
                                                packed=packed)
    return (None if bitmap is None else bitmap[0]), nf[0], mf[0]

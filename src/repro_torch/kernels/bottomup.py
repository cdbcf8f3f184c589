"""Bottom-up (pull) first-hit scan: the CUDA kernel's launch plan and
launcher, and its plain PyTorch version.

Semantics (the JAX package's `bottomup_batch_pallas`): for each lane and
ELL row, `found` iff some slot `< deg[lane, row]` holds a frontier vertex of
that lane; `parent` is the clipped neighbour id at the lowest such slot,
INT_MAX otherwise. `deg` int32[B, R] is lane-masked, `nbrs` int32[R, W] is
shared across lanes, `frontier` uint8[B, V] is per lane. Degrees never
exceed W (an ELL guarantee). `kernels.ops.bottomup_batch` picks between the
two by the tensors' device. One lane (the JAX package's `bottomup_pallas`)
is the same launch with B = 1 (`kernels.ops.bottomup`). The hub wrappers
(`kernels.hub`) launch the same kernel: it takes every width.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

INT_MAX = 2**31 - 1
# `kThreads`, `kFirst` and `kChunk` in the source: threads per block (a
# tile's rows at most), tier 1's slots, tiers 3 and 4's slots a warp step;
# `kDeep` by lanes_block: tier 2's slots a step
THREADS = 256
FIRST = 4
CHUNK = 128
DEEP = {1: 8, 8: 16, 16: 16}
# Tier 2 ends at THREAD_SLOTS, a whole number of its steps past tier 1, so
# that a row of the ladder's narrowest bucket (32 slots) ends in it; tier 3
# ends two warp steps later, so that a 256-slot hub row ends in it.
THREAD_SLOTS = FIRST + 32
WARP_SLOTS = THREAD_SLOTS + 2 * CHUNK
# Pack the frontier's lanes into words when R * PACK_RATIO >= V: packing
# reads the [B, V] frontier once, and then every gather serves a whole
# lane block instead of one lane.
PACK_RATIO = 16

# Per (device, lanes_block): blocks of the kernel one SM holds at once.
_resident: dict = {}
# The plan of the last launch.
LAST_PLAN: dict = {}


def lane_block(b: int) -> int:
    """The source's instance for B lanes: lanes a thread reads at once."""
    return 1 if b == 1 else (8 if b <= 8 else 16)


def pull_plan(b: int, r: int, v: int, sms: int, resident: int) -> dict:
    """The launch shape for B lanes of R rows over V vertices on `sms` SMs
    that each hold `resident` blocks: tiles of `rows` rows (one a thread in
    tier 1) x `lanes` lanes, THREADS x `lanes_block` unless the tiles would
    be fewer than the blocks the SMs hold, in which case rows and then
    lanes halve until they are not (or both are 1), so that a few wide rows
    still spread over the card and a row's lanes stay in one tile unless
    the rows are fewer than the blocks; the tiers' ends; `packed`, whether
    the frontier's lanes are packed into words first (more than one lane,
    whole lane blocks in a tile, and rows enough to pay for the packing);
    and `blocks`: as many as the SMs hold, fewer when there are fewer
    tiles. From the shapes alone (any W), so the launch shape is the same
    for every call at one shape."""
    lanes_block = lane_block(b)
    want = sms * resident
    rows, lanes = THREADS, lanes_block

    def tiles():
        return -(-r // rows) * -(-b // lanes)
    while tiles() < want and rows > 1:
        rows //= 2
    while tiles() < want and lanes > 1:
        lanes //= 2
    packed = b > 1 and lanes == lanes_block and r * PACK_RATIO >= v
    return dict(rows=rows, lanes=lanes, lanes_block=lanes_block,
                thread_slots=THREAD_SLOTS, warp_slots=WARP_SLOTS,
                packed=packed, blocks=max(1, min(tiles(), want)))


def resident_blocks(device: torch.device, lanes_block: int) -> int:
    """Blocks of the kernel's `lanes_block` instance one SM of `device`
    holds at once, from the CUDA occupancy calculator; asked once per
    key."""
    key = (device.index, lanes_block)
    n = _resident.get(key)
    if n is None:
        out = ctypes.c_int(0)
        err = _build.function("bottomup_resident")(
            lanes_block, ctypes.addressof(out), device.index)
        if err != 0 or out.value < 1:
            raise RuntimeError(f"repro_bottomup_resident: cudaError_t {err}, "
                               f"{out.value} blocks per SM for "
                               f"{lanes_block} lanes")
        n = _resident[key] = out.value
    return n


def pull_cuda(deg: torch.Tensor, nbrs: torch.Tensor, frontier: torch.Tensor,
              what: str):
    """Launch `csrc/bottomup.cu` on the current stream: (found uint8[B, R],
    parent int32[B, R]) for `deg` int32[B, R] and `nbrs` int32[R, W], in
    the shape `pull_plan` gives (recorded in LAST_PLAN); the lane words of
    a packed plan go to scratch allocated here. `what` names the wrapper in
    errors."""
    _build.require(deg, torch.int32, 2, f"{what} deg")
    _build.require(nbrs, torch.int32, 2, f"{what} nbrs")
    _build.require(frontier, torch.uint8, 2, f"{what} frontier")
    b, r = deg.shape
    w = nbrs.shape[1]
    v = frontier.shape[1]
    if frontier.shape[0] != b or nbrs.shape[0] != r or v == 0:
        raise ValueError(f"{what}: deg {tuple(deg.shape)}, nbrs "
                         f"{tuple(nbrs.shape)}, frontier "
                         f"{tuple(frontier.shape)} do not fit")
    dev = deg.device
    plan = pull_plan(
        b, r, v, torch.cuda.get_device_properties(dev).multi_processor_count,
        resident_blocks(dev, lane_block(b)))
    LAST_PLAN.clear()
    LAST_PLAN.update(plan)
    found = torch.empty((b, r), dtype=torch.uint8, device=dev)
    parent = torch.empty((b, r), dtype=torch.int32, device=dev)
    lb = plan["lanes_block"]
    packed = (torch.empty((-(-b // lb), v),
                          dtype=torch.uint8 if lb == 8 else torch.int16,
                          device=dev) if plan["packed"] else None)
    _build.launch("bottomup", deg.data_ptr(), nbrs.data_ptr(),
                  frontier.data_ptr(),
                  None if packed is None else packed.data_ptr(),
                  found.data_ptr(), parent.data_ptr(), b, r, w, v,
                  plan["rows"], plan["lanes"], lb, plan["thread_slots"],
                  plan["warp_slots"], plan["blocks"], device=dev.index,
                  stream=torch.cuda.current_stream(dev).cuda_stream)
    return found, parent


def bottomup_batch_cuda(deg: torch.Tensor, nbrs: torch.Tensor,
                        frontier: torch.Tensor):
    """`pull_cuda` for the bottom-up wrappers."""
    return pull_cuda(deg, nbrs, frontier, "bottomup")


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

"""The least bytes and operations each BFS kernel call needs, and the
card's peaks: the roofline arithmetic of the benchmark.

A frozen copy of `chip_smoke.py`'s bounds (`bound`, `push_bound`,
`frontier_bound`, `touched_bytes`, `as_batch`): each input byte a call
must read counted once, each output byte written once, data-dependent
reads counted for the call's own inputs (a pull's slots up to the first
hit, a push's live slots, a packing kernel's degree sectors). The count
is the same whatever kernel implements the call. Plain PyTorch; nothing
of the port.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12          # float32 outside the tensor cores

# The `kernels.ops` wrappers of the BFS path, and the push ones (in place).
BFS_WRAPPERS = ("bottomup_batch", "topdown_batch", "topdown_push_batch",
                "frontier_fused_batch", "hub_bottomup_batch", "bottomup",
                "topdown", "topdown_push", "frontier_fused", "hub_bottomup")
PUSH = ("topdown_push_batch", "topdown_push")

# The port's BFS kernels in a device trace: a part of each kernel's name.
KERNEL_SYMBOLS = ("pull_kernel", "pack_kernel", "push_kernel", "fused_kernel",
                  "topdown_batch_kernel")


def is_bfs_kernel(name: str) -> bool:
    return any(s in name for s in KERNEL_SYMBOLS)


def seconds(nbytes: int, nops: int) -> float:
    """The least time a call can take: bytes over the HBM bandwidth or
    operations over the CUDA cores' rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S)


def touched_bytes(table, lanes_idx):
    """Distinct (lane, vertex) bytes a gather reads from a [B, V] table."""
    b, v = table.shape
    seen = torch.zeros(b * v, dtype=torch.bool, device=table.device)
    seen[lanes_idx] = True
    return int(seen.sum())


def as_batch(name, args):
    """A single-lane call's inputs with a lane axis of 1 (views)."""
    if name in ("bottomup", "hub_bottomup", "topdown"):
        deg, nbrs, table = args
        return deg[None], nbrs, table[None]
    if name == "topdown_push":
        deg, nbrs, rows, table, pcand, keep = args
        return deg[None], nbrs, rows, table[None], pcand[None], keep
    if name == "frontier_fused":
        flags, deg = args
        return flags[None], deg
    return args


def push_bound(args):
    """(bytes, ops) a push call (batch form) needs: the [B, R] degrees; the
    ids of each row up to its largest live degree and the ids of the live
    rows; one byte of `keep` per vertex those slots name; one visited byte
    per distinct (lane, vertex) of the live slots that `keep` lets
    through; a read and a write of pcand per distinct fresh (lane,
    vertex). The ops are the live (lane, slot) tests."""
    deg, nbrs, rows, table, pcand, keep = args
    b, r = deg.shape
    w = nbrs.shape[1]
    v = table.shape[1]
    live = deg.clamp(0, w).to(torch.int64)                   # [B, R]
    need = live.max(dim=0).values                            # [R]
    cols = torch.arange(w, device=deg.device)
    safe = nbrs.clamp(0, v - 1).to(torch.int64)
    head = 4 * b * r + 4 * int(need.sum()) + 4 * int((need > 0).sum())
    kept = None
    if keep is not None:
        named = safe[cols[None] < need[:, None]]
        head += touched_bytes(keep[None], named)
        kept = keep[safe] != 0
    gathers, fresh = [], []
    for lane in range(b):
        m = cols[None] < live[lane][:, None]                 # [R, W]
        if kept is not None:
            m &= kept
        gathers.append(lane * v + safe[m])
        fresh.append(lane * v + safe[m & (table[lane][safe] == 0)])
    gathers, fresh = torch.cat(gathers), torch.cat(fresh)
    nbytes = (head + touched_bytes(table, gathers)
              + 8 * touched_bytes(pcand, fresh))
    return nbytes, int(live.sum())


def frontier_bound(flags, deg, packed=False):
    """(bytes, ops) a packing call needs: every flag byte; of the degrees,
    each 32-byte sector (at its place in memory) that holds the degree of
    a flag set in some lane; the bitmap if `packed`; nf and mf. One test a
    flag."""
    b, v = flags.shape
    first = deg.data_ptr() % 32 // 4               # deg[0]'s slot in a sector
    on = torch.cat([torch.zeros(first, dtype=torch.bool, device=deg.device),
                    (flags != 0).any(dim=0)])
    on = torch.cat([on, on.new_zeros((-on.numel()) % 8)])
    sectors = int(on.view(-1, 8).any(dim=1).sum())
    out = b * ((v + 31) // 32) * 4 if packed else 0
    return b * v + 32 * sectors + out + 8 * b, b * v


def bound(name, args, packed=False):
    """(bytes, ops) this call needs: each input byte it must read once,
    each output byte written once; data-dependent reads counted for these
    inputs (slots up to the first hit, live slots only; for a packing
    kernel the degree sectors its flags name, and the bitmap with
    `packed`)."""
    args = as_batch(name, args)
    if name in PUSH:
        return push_bound(args)
    if name.startswith("frontier_fused"):
        return frontier_bound(*args, packed=packed)
    deg, nbrs, table = args
    b, r = deg.shape
    w = nbrs.shape[1]
    v = table.shape[1]
    live = deg.clamp(max=w).to(torch.int64)                  # [B, R]
    cols = torch.arange(w, device=deg.device)
    if name.removesuffix("_batch") in ("bottomup", "hub_bottomup"):
        # Needed slots stop at the first hit.
        need = torch.zeros_like(live)
        safe = nbrs.clamp(0, v - 1).to(torch.int64)
        for lane in range(b):
            hit = (cols[None] < live[lane][:, None]) & (table[lane][safe] != 0)
            first = hit.to(torch.uint8).argmax(dim=1)
            need[lane] = torch.where(hit.any(dim=1), first + 1, live[lane])
        out_bytes = b * r * 5
    else:
        need = live
        out_bytes = b * r * w
    nbr_bytes = 4 * int(need.max(dim=0).values.sum())
    if name == "topdown":
        # dst = clip(nbrs) for every slot: the whole tile in, int32 out.
        nbr_bytes = 4 * r * w
        out_bytes += 4 * r * w
    idx = []
    for lane in range(b):
        m = cols[None] < need[lane][:, None]
        idx.append(lane * v + nbrs.clamp(0, v - 1).to(torch.int64)[m])
    table_bytes = touched_bytes(table, torch.cat(idx))
    return 4 * b * r + nbr_bytes + table_bytes + out_bytes, int(need.sum())


def call_args(name, args, kw):
    """A wrapper call's inputs as `bound` takes them, and its `packed`."""
    if name in PUSH and len(args) == 5:
        args = args + (kw.get("keep"),)
    packed = bool(kw.get("packed", True)) if name.startswith(
        "frontier_fused") else False
    return args, packed

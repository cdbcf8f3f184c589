"""Collectives of the partitioned BFS, on a `torch.distributed` group.

* `or_allreduce_flags`: the BSP push/pull as an int32 sum of 0/1 flags,
  then `> 0` (the JAX package's `psum` exchange);
* `or_allreduce_bitmap`: bitwise OR of packed frontier words (the `bitmap`
  exchange, V/8 bytes on the wire);
* `min_allreduce`: the deferred parent and level aggregation.

Each returns a new tensor and leaves its input as it was. torch's
collectives take no `uint32`, so the words travel as their int32 view (sign
bits included). Gloo ORs them in one `all_reduce` with `ReduceOp.BOR`,
which equals the JAX package's all-gather then OR-fold bit for bit; NCCL
has no bitwise reductions, so on an NCCL group the words are all-gathered
and OR-folded, as in the JAX package.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist


def or_allreduce_flags(flags: torch.Tensor, group=None) -> torch.Tensor:
    """uint8 0/1 flags -> their OR across `group` (int32 sum, then > 0)."""
    summed = flags.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    return (summed > 0).to(torch.uint8)


def or_allreduce_bitmap(words: torch.Tensor, group=None) -> torch.Tensor:
    """uint32 bitmap words -> their bitwise OR across `group`."""
    buf = words.view(torch.int32).clone()
    if dist.get_backend(group) == dist.Backend.NCCL:
        gathered = buf.new_empty((dist.get_world_size(group),) + buf.shape)
        dist.all_gather_into_tensor(gathered, buf, group=group)
        buf = functools.reduce(torch.bitwise_or, gathered.unbind(0))
    else:
        dist.all_reduce(buf, op=dist.ReduceOp.BOR, group=group)
    return buf.view(torch.uint32)


def min_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise minimum of `x` across `group`."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out

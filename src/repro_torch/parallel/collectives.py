"""Collectives of the partitioned BFS, and the sequence collectives of the
model's sequence parallelism, on a `torch.distributed` group.

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

The sequence collectives (Megatron-style sequence parallelism: the
activations between layers keep their sequence cut over the `model` axis)
are functional collectives with autograd, each the other's backward:
  * `gather_seq`: the blocks of a dim all-gathered in rank order
    (backward: a reduce-scatter);
  * `reduce_scatter_seq`: partial sums summed, each rank keeping its block
    of a dim (backward: an all-gather);
  * `split_seq`: each rank's block of a dim that is whole on every rank, no
    communication (backward: an all-gather);
  * `all_reduce_sum`: a sum over the group (backward: the same sum);
    `all_reduce_max` a maximum, with no gradient.
gloo's functional all-gather crashes its rank on a CUDA tensor (torch 2.11
on the H100; its all-to-all and all-reduce run), so on a gloo group a CUDA
tensor goes through the host (`staged`) and comes back to its device; the
copies are differentiable.
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


# ---------------------------------------------------- sequence collectives --

def staged(t: torch.Tensor, group) -> torch.Tensor:
    """`t` where a collective on `group` can take it: a host copy of a CUDA
    tensor on a gloo group, else `t` itself."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as fc
    out = fc.wait_tensor(fc.all_gather_tensor(staged(t.contiguous(), group),
                                              dim, group))
    return out.to(t.device)


def _reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed._functional_collectives as fc
    out = fc.wait_tensor(fc.reduce_scatter_tensor(
        staged(t.contiguous(), group), "sum", dim, group))
    return out.to(t.device)


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    import torch.distributed._functional_collectives as fc
    out = fc.wait_tensor(fc.all_reduce(staged(t.contiguous(), group), op,
                                       group))
    return out.to(t.device)


def _block(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    return t.chunk(n, dim)[dist.get_rank(group)].contiguous()


# Each collective is one autograd node on its tensor's device, its host
# copies inside it: the autograd engine runs a CUDA graph's backward on
# one device thread, so every rank issues a group's collectives in the
# same order (host copies tracked by autograd would run theirs on the
# host's thread, interleaved with the device thread's in no fixed order).

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def gather_seq(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of `t` along `dim`, concatenated in rank order."""
    return _Gather.apply(t, dim, group)


def reduce_scatter_seq(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of `t` over the group, cut along `dim` into one block a rank:
    this rank's."""
    return _ReduceScatter.apply(t, dim, group)


def split_seq(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along `dim` of `t`, which every rank holds whole;
    its gradient comes back whole by an all-gather."""
    return _Split.apply(t, dim, group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over the group, on every rank."""
    return _Sum.apply(t, group)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of `t` over the group, on every rank; no
    gradient flows through it."""
    return _all_reduce(t.detach(), group, "max")

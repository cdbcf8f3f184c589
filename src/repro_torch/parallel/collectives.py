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

int8 gradient compression (the JAX package's optional data-parallel
gradient sync) takes the mean of a gradient tree over the group with
stochastic rounding, unbiased (E[deq(q(x))] = x):
  * `quantize_int8` / `dequantize_int8`: one tensor's codes and its scale;
  * `compressed_psum`: per leaf, a shared scale (an fp32 `MAX` all-reduce
    of one element), the leaf's int8 codes widened to int32 and summed
    exactly (an int32 `SUM` all-reduce), then the codes' sum times the
    scale over the group size, in the leaf's dtype.
The sum of n int8 codes needs more than 8 bits, so the payload on the
wire is int32: 4 bytes an element, the bytes of an fp32 all-reduce, plus
4 bytes a leaf for the scale. The JAX function widens to int32 before its
`psum` too; this computes the same sums, in its fp32 order. Each leaf
rounds with its own stream, a `torch.Generator` on the leaf's device
seeded from (seed, leaf index, rank), as the JAX function folds its key
with the leaf index and then the axis index. `stochastic_round_int8` takes
the uniform draws as an argument, so a test can feed the JAX function's
draws. A CUDA tensor on a gloo group goes through gloo's all-reduce,
which takes it.
"""
from __future__ import annotations

import functools

import numpy as np
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


# ---------------------------------------------------- gradient compression --

def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """The fp32 grid step (0-d) that puts max |x| at code 127."""
    amax = x.abs().max().to(torch.float32)
    return torch.maximum(amax, amax.new_tensor(1e-30)) / 127.0


def stochastic_round_int8(x: torch.Tensor, scale: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
    """int8 codes of `x` on the grid of `scale`: floor(x / scale), one up
    where the uniform draw `u` (fp32 in [0, 1), x's shape) is below the
    remainder, clipped to [-127, 127]."""
    y = x.to(torch.float32) / scale
    lo = torch.floor(y)
    up = (u < y - lo).to(torch.float32)
    return torch.clamp(lo + up, -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor, generator: torch.Generator = None):
    """Stochastic-rounding int8 quantization with draws from `generator`
    (one on x's device; None: the device's default). Returns (q, scale)."""
    scale = int8_scale(x)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return stochastic_round_int8(x, scale, u), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _leaf_generator(seed: int, leaf: int, rank: int,
                    device) -> torch.Generator:
    """The rounding stream of leaf number `leaf` on `rank`: a generator on
    `device` seeded from (seed, leaf, rank)."""
    state = np.random.SeedSequence([seed, leaf, rank]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2**63 - 1))


def compressed_psum(tree, group=None, seed: int = 0, *, draws=None):
    """The mean over `group` of a gradient tree, sent as int8 codes.

    `tree` is a dict of tensors (its leaves numbered in sorted key order,
    as JAX flattens a dict) or a list of them; every rank passes the same
    structure and shapes, and gets the same structure back. Each leaf
    takes the group's largest scale (every rank encodes on one grid) and
    rounds with draws from a generator seeded from (seed, i, rank), i its
    leaf number, or with `draws(i, leaf)` when given (uniform fp32 draws
    of the leaf's shape); its codes' exact int32 sum comes back as
    sum * scale / n in the leaf's dtype.
    """
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    out = {}
    for i, k in enumerate(keys):
        leaf = tree[k]
        scale = int8_scale(leaf)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        if draws is None:
            gen = _leaf_generator(seed, i, rank, leaf.device)
            u = torch.rand(leaf.shape, generator=gen, device=leaf.device)
        else:
            u = draws(i, leaf)
        s = stochastic_round_int8(leaf, scale, u).to(torch.int32)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        out[k] = (s.to(torch.float32) * scale / n).to(leaf.dtype)
    if isinstance(tree, dict):
        return {k: out[k] for k in tree}
    return [out[i] for i in keys]

"""Kernel contracts: what each `_build.launch` site of `repro_torch.kernels`
asks of the card, at one concrete shape.

The port's counterpart of the JAX package's `kernels/contracts.py`. A TPU
contract rebuilt a `pallas_call`'s grid and BlockSpecs; a CUDA launch's
request is different, and each contract here rebuilds it for one call:

* the kernel instances the call launches (`smem.KernelInstance`: threads
  a block, the `__shared__` declarations of the source, dynamic shared
  bytes, the register cap of its `__launch_bounds__`), which KC001 holds
  against the per-CTA budget and `chip_smoke.py` against the compiler;
* each launch's grid, and the ranges its plan must cover exactly once
  (a grid-stride loop's tiles over rows and lanes, the decode splits over
  S, the packing kernel's words over V), which KC002 proves;
* the gathers the kernel performs, with the interval the ids take and the
  clip it applies (`clip` in `csrc/bottomup.cu`), which KC004 bounds.

Each builder takes its launch shape from the launcher's own plan function
(`bottomup.pull_plan`, `topdown.push_plan`/`fresh_plan`,
`frontier_fused.fused_plan`, `decode_attn.split_plan` and
`decode_attn.shared_layout`), never from a copy of their arithmetic, so a
contract cannot drift from its launch. The launchers are imported inside
the builders: importing this module costs no torch, and the decode
launcher stays out of the BFS path (the DC001 quarantine).

The checker is :mod:`repro_torch.analysis.kernel_contracts`; the typed
errors below are also raised by the launchers themselves on a shape they
refuse, so an infeasible call fails with an actionable message.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.analysis.smem import KernelInstance, SharedArray

# -------------------------------------------------------------- exceptions --


class KernelContractError(ValueError):
    """A kernel instantiation violates its declared contract."""


class GridCoverageError(KernelContractError):
    """A launch plan would not cover its range, or its grid passes a
    hardware limit."""


class KernelBudgetError(KernelContractError):
    """An instance's per-CTA shared memory, threads or registers exceed
    the budget."""


class KernelContractWarning(UserWarning):
    """A plan's kernels exceed the budget (non-strict session gate)."""


# The card the static checks assume when no device is asked (the CLI, the
# session gate): the H100 SXM's SMs. The proofs hold for any SM count and
# any resident count >= 1; chip_smoke.py rebuilds the contracts from the
# card's own.
H100_SMS = 132


# ------------------------------------------------------- kernel instances --


def pull_instance(lanes_block: int) -> KernelInstance:
    """`pull_kernel<kLanes>` of `csrc/bottomup.cu`: its `__shared__`
    declarations (the results staged with more than one lane; with one
    they are written directly and the compiler drops the two unused
    one-element arrays; the tier-3 and tier-4 queues, their counts, the
    block's minimum slot) and `__launch_bounds__(kThreads, kLanes == 1 ?
    4 : 3)`."""
    from repro_torch.kernels import bottomup as bu
    t = bu.THREADS
    staged = ((SharedArray("found", "uint8", lanes_block * t),
               SharedArray("parent", "int32", lanes_block * t))
              if lanes_block > 1 else ())
    return KernelInstance(
        symbol=f"pull_kernel<{lanes_block}>", library="bottomup",
        selectors=(0, lanes_block), threads=t,
        shared=staged + (SharedArray("queue3", "uint16", t * lanes_block),
                         SharedArray("queue4", "uint16", t * lanes_block),
                         SharedArray("n3", "int32", 1),
                         SharedArray("n4", "int32", 1),
                         SharedArray("best", "int32", 1)),
        min_blocks=bu.MIN_BLOCKS[lanes_block])


def pack_instance(lanes_block: int) -> KernelInstance:
    """`pack_kernel<kLanes>` of `csrc/bottomup.cu`, which a packed pull
    plan launches first: no shared memory, no launch bounds."""
    from repro_torch.kernels import bottomup as bu
    return KernelInstance(symbol=f"pack_kernel<{lanes_block}>",
                          library="bottomup", selectors=(1, lanes_block),
                          threads=bu.THREADS)


def fresh_instance() -> KernelInstance:
    """`topdown_batch_kernel` of `csrc/topdown.cu` (the fresh entry)."""
    from repro_torch.kernels import topdown as td
    return KernelInstance(symbol="topdown_batch_kernel", library="topdown",
                          selectors=(0, 1), threads=td.THREADS)


def push_instance(lanes_block: int) -> KernelInstance:
    """`push_kernel<kLanes>` of `csrc/topdown.cu`: a warp's items' degrees
    for the block's lanes, `__launch_bounds__(kThreads)`."""
    from repro_torch.kernels import topdown as td
    return KernelInstance(
        symbol=f"push_kernel<{lanes_block}>", library="topdown",
        selectors=(1, lanes_block), threads=td.THREADS,
        shared=(SharedArray("sdeg", "int32",
                            td.PUSH_WARPS * lanes_block * 32),),
        min_blocks=0)


def fused_instance(lanes_block: int, packed: bool) -> KernelInstance:
    """`fused_kernel<kLanes, kPacked>` of `csrc/frontier_fused.cu`: two
    tiles of words in turn (with more than one lane; one lane's warps
    share their words by shuffles, and the compiler drops the array) and
    the warps' counts."""
    from repro_torch.kernels import frontier_fused as ff
    warps = ff.THREADS // 32
    words = ((SharedArray("words", "uint32",
                          2 * lanes_block * (32 * warps // lanes_block)),)
             if lanes_block > 1 else ())
    return KernelInstance(
        symbol=f"fused_kernel<{lanes_block}, {str(bool(packed)).lower()}>",
        library="frontier_fused", selectors=(lanes_block, int(packed)),
        threads=ff.THREADS,
        shared=words + (SharedArray("red", "uint32", warps * 2 * lanes_block),))


def decode_instance(dtype: str, g: int, h: int,
                    nsplit: int) -> KernelInstance:
    """`decode_attn_kernel<T, GM>` of `csrc/decode_attn.cu` at (dtype, g,
    h) with `nsplit` splits: one static int (the last block's flag), which
    ends on the 16-byte alignment of the dynamic array after it, and the
    dynamic `Layout`."""
    from repro_torch.kernels import decode_attn as da
    return KernelInstance(
        symbol=f"decode_attn_kernel<{dtype}, {da.group_instance(g)}>",
        library="decode_attn",
        selectors=(g, h, 0 if dtype == "float32" else 1, nsplit),
        threads=da.THREADS, shared=(SharedArray("last", "int32", 1),),
        dynamic_bytes=da.shared_layout(dtype, g, h, nsplit),
        dynamic_align=16)


# ---------------------------------------------------------------- contracts --


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a call: its instance and grid (x, y, z)."""
    instance: KernelInstance
    grid: Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class Coverage:
    """A range the plan must cover exactly once: `extent` elements in
    `steps` steps of `step` (the last step may run past the end, no step
    lies wholly past it)."""
    what: str
    extent: int
    step: int
    steps: int


@dataclasses.dataclass(frozen=True)
class Limit:
    """A plan value the kernel takes only up to `most` (and from `least`)."""
    what: str
    value: int
    most: int
    least: int = 1


@dataclasses.dataclass(frozen=True)
class GatherSpec:
    """A dynamic gather the kernel performs, ``source[clip(index)]``.

    ``raw_interval`` is the closed interval the index values can take
    before the clip (for ELL tiles: [0, v]: padded slots hold 0 and the
    partitioned path's pad rows target the out-of-range id v). ``clip`` is
    the closed interval the kernel clips to before gathering (None: it
    gathers raw, which KC004 flags); ``extent`` the source's length.
    """
    index: str
    source: str
    raw_interval: Tuple[int, int]
    clip: Optional[Tuple[int, int]]
    extent: int


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """One wrapper call at one concrete shape."""
    kernel: str                        # the wrapper (`kernels.ops` name)
    module: str                        # kernels submodule of its launcher
    launches: Tuple[Launch, ...]
    coverage: Tuple[Coverage, ...] = ()
    limits: Tuple[Limit, ...] = ()
    gathers: Tuple[GatherSpec, ...] = ()
    plan: Tuple[Tuple[str, int], ...] = ()   # the plan function's output
    shape: Tuple[Tuple[str, int], ...] = ()  # the call's sizes (b, r, w, v)


def _ell_gather(v: int, source: str) -> GatherSpec:
    return GatherSpec("nbrs", source, (0, v), (0, v - 1), v)


def _resident_pull(lanes_block: int, resident: Optional[int]) -> int:
    from repro_torch.kernels import bottomup as bu
    return bu.MIN_BLOCKS[lanes_block] if resident is None else resident


def pull_contract(b: int, r: int, w: int, v: int, *,
                  kernel: str = "bottomup_batch", sms: int = H100_SMS,
                  resident: Optional[int] = None) -> KernelContract:
    """A pull call (`bottomup.pull_cuda`, behind every bottom-up and hub
    wrapper) of B lanes, R rows of width W over V vertices, in the shape
    `bottomup.pull_plan` gives; `resident` blocks an SM (None: the launch
    bounds' minimum, what the occupancy calculator reports on the H100)."""
    from repro_torch.kernels import bottomup as bu
    lb = bu.lane_block(b)
    plan = bu.pull_plan(b, r, v, sms, _resident_pull(lb, resident))
    launches = []
    if plan["packed"]:
        work = -(-b // lb) * v
        launches.append(Launch(pack_instance(lb),
                               (max(1, min(-(-work // bu.THREADS), 65536)),
                                1, 1)))
    launches.append(Launch(pull_instance(lb), (plan["blocks"], 1, 1)))
    return KernelContract(
        kernel=kernel, module="bottomup", launches=tuple(launches),
        coverage=(Coverage("rows", r, plan["rows"], -(-r // plan["rows"])),
                  Coverage("lanes", b, plan["lanes"],
                           -(-b // plan["lanes"]))),
        limits=(Limit("rows a tile", plan["rows"], bu.THREADS),
                Limit("lanes a tile", plan["lanes"], lb),
                Limit("tier-2 end past tier 1, in steps",
                      (plan["thread_slots"] - bu.FIRST) % bu.DEEP[lb], 0, 0),
                Limit("tier-3 end past tier 2, in warp steps",
                      (plan["warp_slots"] - plan["thread_slots"]) % bu.CHUNK,
                      0, 0)),
        gathers=(_ell_gather(v, "frontier"),),
        plan=tuple(sorted((k, int(x)) for k, x in plan.items())),
        shape=(("b", b), ("r", r), ("w", w), ("v", v)))


def push_contract(b: int, r: int, w: int, v: int, *,
                  kernel: str = "topdown_push_batch", sms: int = H100_SMS,
                  resident: int = 1) -> KernelContract:
    """A push call (`topdown.topdown_push_cuda`) of B lanes over R rows of
    width W into V vertices, in the shape `topdown.push_plan` gives."""
    from repro_torch.kernels import topdown as td
    plan = td.push_plan(b, r, w, sms, resident)
    lb = plan["lanes_block"]
    return KernelContract(
        kernel=kernel, module="topdown",
        launches=(Launch(push_instance(lb),
                         (plan["blocks"], plan["groups"], 1)),),
        coverage=(Coverage("lanes", b, lb, plan["groups"]),
                  Coverage("slots of a row", w, td.PUSH_CHUNK,
                           plan["chunks"]),
                  Coverage("work items", r * plan["chunks"], 32,
                           plan["tiles"])),
        gathers=(_ell_gather(v, "visited"),),
        plan=tuple(sorted((k, int(x)) for k, x in plan.items())),
        shape=(("b", b), ("r", r), ("w", w), ("v", v)))


def fresh_contract(b: int, c: int, w: int, v: int, *,
                   kernel: str = "topdown_batch") -> KernelContract:
    """A fresh-entry call (`topdown._launch`) of B lanes over C rows of
    width W, in the shape `topdown.fresh_plan` gives."""
    from repro_torch.kernels import topdown as td
    plan = td.fresh_plan(b, c, w)
    return KernelContract(
        kernel=kernel, module="topdown",
        launches=(Launch(fresh_instance(), (plan["blocks"], b, 1)),),
        coverage=(Coverage("slots of a row", w, td.FRESH_SLOTS,
                           plan["chunks"]),
                  Coverage("(row, chunk) threads", c * plan["chunks"],
                           td.THREADS, plan["blocks"])),
        gathers=(_ell_gather(v, "visited"),),
        plan=tuple(sorted((k, int(x)) for k, x in plan.items())),
        shape=(("b", b), ("c", c), ("w", w), ("v", v)))


def fused_contract(b: int, v: int, *, packed: bool = False,
                   kernel: str = "frontier_fused_batch", sms: int = H100_SMS,
                   resident: int = 1) -> KernelContract:
    """A packing call (`frontier_fused.frontier_fused_batch_cuda`) of B
    lanes of V flags, in the shape `frontier_fused.fused_plan` gives."""
    from repro_torch.core import frontier as fr
    from repro_torch.kernels import frontier_fused as ff
    plan = ff.fused_plan(b, v, sms, resident)
    lb = plan["lanes_block"]
    return KernelContract(
        kernel=kernel, module="frontier_fused",
        launches=(Launch(fused_instance(lb, packed),
                         (plan["blocks"], plan["groups"], 1)),),
        coverage=(Coverage("lanes", b, lb, plan["groups"]),
                  Coverage("flags", v, 32, fr.num_words(v)),
                  Coverage("words", fr.num_words(v), plan["tile_words"],
                           plan["tiles"])),
        limits=(Limit("lane groups", plan["groups"], ff.MAX_GROUPS),
                Limit("blocks a group", plan["blocks"], ff.MAX_BLOCKS)),
        plan=tuple(sorted((k, int(x)) for k, x in plan.items())),
        shape=(("b", b), ("v", v)))


def decode_contract(b: int, s: int, kk: int, g: int, h: int, *,
                    dtype: str = "bfloat16", sms: int = H100_SMS,
                    resident: int = 1,
                    kernel: str = "decode_attention") -> KernelContract:
    """A decode attention call (`decode_attn.decode_attention_cuda`): q [B,
    K, g, h] against caches of S positions, split by
    `decode_attn.split_plan`. The optional lse pointer (`return_lse=True`)
    changes no launch, instance or plan."""
    from repro_torch.kernels import decode_attn as da
    nsplit, split_len = da.split_plan(b, kk, s, sms, resident)
    return KernelContract(
        kernel=kernel, module="decode_attn",
        launches=(Launch(decode_instance(dtype, g, h, nsplit),
                         (nsplit, kk, b)),),
        coverage=(Coverage("positions", s, split_len, nsplit),),
        limits=(Limit("splits", nsplit, da.MAX_SPLITS),
                Limit("split length mod TILE", split_len % da.TILE, 0, 0),
                Limit("query heads a kv head", g, da.MAX_GROUP),
                Limit("head dim", h, da.MAX_HEAD_DIM)),
        plan=(("nsplit", nsplit), ("split_len", split_len)),
        shape=(("b", b), ("s", s), ("kk", kk), ("g", g), ("h", h)))


# ----------------------------------------------------------------- registry --


@dataclasses.dataclass(frozen=True)
class KernelContractSpec:
    """Registry row: a `_build.launch` site (its launcher function in its
    module) -> contract builder + reference shapes.

    ``reference`` is a scale-16-class instantiation the CLI gate (KC001,
    KC002, KC004 over the tree) evaluates: the tree must be clean at it.
    """
    name: str                          # "<module>.<launcher function>"
    module: str
    build: Callable[..., KernelContract]
    reference: Dict[str, object]

    def reference_contract(self) -> KernelContract:
        return self.build(**self.reference)


REGISTRY: Dict[str, KernelContractSpec] = {
    spec.name: spec for spec in (
        KernelContractSpec("bottomup.pull_cuda", "bottomup", pull_contract,
                           dict(b=8, r=4096, w=2048, v=65536)),
        KernelContractSpec("topdown._launch", "topdown", fresh_contract,
                           dict(b=8, c=4096, w=2048, v=65536)),
        KernelContractSpec("topdown.topdown_push_cuda", "topdown",
                           push_contract, dict(b=8, r=4096, w=2048,
                                               v=65536)),
        KernelContractSpec("frontier_fused.frontier_fused_batch_cuda",
                           "frontier_fused", fused_contract,
                           dict(b=8, v=65536)),
        KernelContractSpec("decode_attn.decode_attention_cuda",
                           "decode_attn", decode_contract,
                           dict(b=4, s=4232, kk=8, g=2, h=256)),
    )
}


def registered_kernels() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


def require_grid(kernel: str, what: str, n: int, most: int, *,
                 hint: str) -> None:
    """Raise `GridCoverageError` when a launch would need `n` > `most`
    along a grid dimension (the launchers' check, with the fix)."""
    if n > most:
        raise GridCoverageError(
            f"{kernel}: {n} {what}, more than the {most} the grid takes "
            f"along its dimension. {hint}")

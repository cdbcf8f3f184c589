"""Static per-CTA budget model for the port's CUDA kernels on Hopper.

The port's counterpart of the JAX package's `analysis/vmem.py`. A TPU
kernel's limit is the VMEM its BlockSpecs' buffers fill; a CUDA kernel's
are per block (CTA), and only the compiler knows their exact values:

* shared memory: static (`__shared__` declarations, at most 48 KiB a
  block) plus dynamic (the launch's third argument), together at most the
  227 KiB a block may opt in to on the H100 (`DEFAULT_SMEM_BUDGET`;
  `RuntimeConfig.smem_budget_bytes` / ``REPRO_SMEM_BUDGET`` overrides it);
* registers: the cap a `__launch_bounds__(threads, min_blocks)` implies,
  65,536 a SM shared by `min_blocks` blocks, allocated per warp in units
  of 256, at most 255 a thread;
* threads a block, at most 1,024; grid y and z at most 65,535 (x
  2^31 - 1).

Pure Python on purpose: the analysis CLI and the session's contract gate
run it without a device, and it never imports torch. A kernel instance is
described by its threads a block, the `__shared__` declarations the
compiler keeps (each placed at the next multiple of its element size, in
declaration order; before an `extern __shared__` array the static part
ends on that array's alignment), its dynamic shared bytes and the
`min_blocks` of its launch bounds;
`chip_smoke.py` holds the static bytes against `cudaFuncGetAttributes`
and the compiled register counts against the cap, for every instance the
paths launch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# H100 SXM, per block and per SM (NVIDIA's data sheet and CUDA's
# programming guide for compute capability 9.0).
DEFAULT_SMEM_BUDGET = 232_448          # 227 KiB a block may opt in to
STATIC_SMEM_LIMIT = 48 * 1024          # static __shared__ bytes a block
REGISTERS_PER_SM = 65_536
MAX_REGISTERS_PER_THREAD = 255
REGISTER_UNIT = 256                    # registers allocated a warp at a time
MAX_THREADS_PER_BLOCK = 1_024
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65_535

DTYPE_BYTES = {
    "int64": 8, "uint64": 8, "float64": 8,
    "int32": 4, "uint32": 4, "float32": 4,
    "int16": 2, "uint16": 2, "bfloat16": 2, "float16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}


class SmemModelError(ValueError):
    """A declaration or launch the budget model cannot reason about."""


def dtype_bytes(dtype: str) -> int:
    try:
        return DTYPE_BYTES[dtype]
    except KeyError:
        raise SmemModelError(f"unknown dtype {dtype!r}; the budget model "
                             f"knows {sorted(DTYPE_BYTES)}") from None


@dataclasses.dataclass(frozen=True)
class SharedArray:
    """One `__shared__` declaration: `count` elements of `dtype`."""
    name: str
    dtype: str
    count: int

    @property
    def nbytes(self) -> int:
        if self.count < 0:
            raise SmemModelError(f"__shared__ {self.name}: negative count "
                                 f"{self.count}")
        return self.count * dtype_bytes(self.dtype)


def static_shared_bytes(decls: Sequence[SharedArray]) -> int:
    """Bytes of a block's `__shared__` declarations, each at the next
    multiple of its element size, in declaration order."""
    off = 0
    for d in decls:
        size = dtype_bytes(d.dtype)
        off = -(-off // size) * size + d.nbytes
    return off


def register_cap(threads: int, min_blocks: int = 0) -> int:
    """Registers a thread may use under `__launch_bounds__(threads,
    min_blocks)`: `min_blocks` blocks share the SM's registers, a warp's
    allocated in units of REGISTER_UNIT (0: no minimum; the hardware's
    cap)."""
    if threads < 1:
        raise SmemModelError(f"threads must be >= 1, got {threads}")
    if min_blocks <= 0:
        return MAX_REGISTERS_PER_THREAD
    warps = min_blocks * -(-threads // 32)
    per_warp = REGISTERS_PER_SM // warps // REGISTER_UNIT * REGISTER_UNIT
    return min(MAX_REGISTERS_PER_THREAD, per_warp // 32)


@dataclasses.dataclass(frozen=True)
class KernelInstance:
    """One compiled kernel instance as a launch runs it: `symbol` names it
    in its library (`csrc/<library>.cu`); `selectors` are the arguments of
    the library's `repro_<lib>_attributes` entry point that pick it."""
    symbol: str
    library: str
    selectors: Tuple[int, ...]
    threads: int
    shared: Tuple[SharedArray, ...] = ()
    dynamic_bytes: int = 0
    min_blocks: int = 0
    # alignment of an `extern __shared__` array (0: none): the static
    # part of the block's shared memory ends on it
    dynamic_align: int = 0

    @property
    def static_bytes(self) -> int:
        n = static_shared_bytes(self.shared)
        if self.dynamic_align:
            n = -(-n // self.dynamic_align) * self.dynamic_align
        return n

    @property
    def register_cap(self) -> int:
        return register_cap(self.threads, self.min_blocks)


@dataclasses.dataclass(frozen=True)
class SmemReport:
    """Per-instance budget report: what a block of the instance needs
    against the per-CTA limits."""
    kernel: str
    threads: int
    static_bytes: int
    dynamic_bytes: int
    register_cap: int
    budget_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.static_bytes + self.dynamic_bytes

    @property
    def problems(self) -> Tuple[str, ...]:
        out = []
        if self.threads > MAX_THREADS_PER_BLOCK:
            out.append(f"{self.threads} threads a block, above the "
                       f"{MAX_THREADS_PER_BLOCK} a block may have")
        if self.static_bytes > STATIC_SMEM_LIMIT:
            out.append(f"{self.static_bytes} B of static __shared__, above "
                       f"the {STATIC_SMEM_LIMIT} B a block may declare")
        if self.total_bytes > self.budget_bytes:
            out.append(f"{self.total_bytes} B of shared memory a block "
                       f"({self.static_bytes} static + "
                       f"{self.dynamic_bytes} dynamic), above the "
                       f"{self.budget_bytes} B budget")
        if self.register_cap * self.threads > REGISTERS_PER_SM:
            out.append(f"{self.register_cap} registers x {self.threads} "
                       f"threads exceed the SM's {REGISTERS_PER_SM}")
        return tuple(out)

    @property
    def fits(self) -> bool:
        return not self.problems

    @property
    def utilization(self) -> float:
        return self.total_bytes / self.budget_bytes if self.budget_bytes \
            else 0.0

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "threads": self.threads,
            "static_bytes": self.static_bytes,
            "dynamic_bytes": self.dynamic_bytes,
            "total_bytes": self.total_bytes,
            "register_cap": self.register_cap,
            "budget_bytes": self.budget_bytes,
            "fits": self.fits,
            "utilization": round(self.utilization, 4),
        }


def smem_report(instance: KernelInstance,
                budget_bytes: Optional[int] = None) -> SmemReport:
    budget = DEFAULT_SMEM_BUDGET if budget_bytes is None else int(budget_bytes)
    return SmemReport(kernel=instance.symbol, threads=instance.threads,
                      static_bytes=instance.static_bytes,
                      dynamic_bytes=int(instance.dynamic_bytes),
                      register_cap=instance.register_cap,
                      budget_bytes=budget)

"""`RuntimeConfig`: the port's process-wide runtime configuration.

The port's counterpart of the JAX package's `runtime/config.py`, with the
fields this package reads, under the same strict precedence:

    explicit argument  >  environment variable  >  built-in default

Environment variables (all optional):

=====================  =====================================================
REPRO_CACHE_DIR        persistent artifact-cache directory ('' = disabled):
                       built kernel libraries and plan records
                       (`repro_torch.runtime.artifact_cache`)
REPRO_CACHE_MAX_BYTES  cache eviction cap; int bytes or '512MB'/'2GB'
                       (default 1 GiB)
REPRO_PREWARM          '1'/'0': background pre-warm on `GraphSession` attach
REPRO_PREWARM_LIMIT    max plan records one pre-warm pass rebuilds (64)
REPRO_SHARE_PLANS      '1'/'0': in-process cross-session plan sharing (on)
REPRO_KERNELS          'auto' | 'off': the BFS formulation when
                       `BFSConfig.backend_kernels` is None. 'auto' runs the
                       ELL-tile kernels ("tiles") on every device, 'off'
                       the CSR gather formulation ("gather"); see
                       `repro_torch.core.bfs.kernels_enabled`. The JAX
                       package's 'on' (its kernels off the TPU too) is
                       what 'auto' already does here, so it is refused
REPRO_FAULTS           fault-injection schedule (see
                       `repro_torch.runtime.faults`; '' = disabled). Chaos
                       testing only
REPRO_FAULTS_SEED      int seed for probabilistic fault selectors
REPRO_SANITIZE         '1'/'0': concurrency sanitizer (instrumented lock and
                       timer wrappers, `repro_torch.analysis.concurrency`).
                       Testing only
REPRO_SMEM_BUDGET      per-CTA shared-memory budget of the kernel contracts
                       (`repro_torch.analysis.smem`); int bytes or '227KB'
                       (default 232,448 B, the H100's opt-in maximum), > 0
REPRO_STRICT_CONTRACTS '1'/'0': a plan whose kernels fail their contract
                       raises `KernelBudgetError` at `GraphSession`'s gate
                       instead of warning (`KernelContractWarning`)
=====================  =====================================================

`smem_budget_bytes` and `strict_contracts` are the counterparts of the JAX
package's `vmem_budget_bytes` and `strict_contracts`, named for what they
bound on this card. The JAX package's other two fields configure nothing
here: Pallas interpret mode (a CUDA kernel has none) and the fake host
device count (the dry-run's fake process group takes each production
mesh's size itself). Parsing reads no device: resolving a config never
initializes CUDA.

`launch_env()` is the launch hygiene of the JAX package's config as code:
the environment a launcher shell exports before the python process starts
(tcmalloc must be `LD_PRELOAD`ed before the process allocates, so a
running process cannot apply it to itself; hence a helper that returns
the variables rather than sets them). It holds
`TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD` (tcmalloc's large-allocation
reports off for graph-sized host buffers), `LD_PRELOAD` (only when
`tcmalloc_path` exists on this machine) and `REPRO_CACHE_DIR` (when the
cache is on). The JAX package's `TF_CPP_MIN_LOG_LEVEL` and `XLA_FLAGS`
are left out: only XLA reads them.

The module keeps one process-wide singleton (`get_runtime_config`), replaced
by `configure(...)` and scoped by the `runtime_scope(...)` context manager
(tests).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Optional

from repro_torch.analysis.smem import DEFAULT_SMEM_BUDGET

_KERNELS = ("auto", "off")
# the conventional tcmalloc path on x86-64 Debian/Ubuntu images
DEFAULT_TCMALLOC = "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4"
DEFAULT_CACHE_MAX_BYTES = 1 << 30            # 1 GiB
DEFAULT_PREWARM_LIMIT = 64

_SIZE_SUFFIXES = {"KB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
                  "K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "B": 1}


def _parse_size(text: str, *, name: str) -> int:
    """'1048576' | '512MB' | '2gb' -> bytes (int)."""
    s = str(text).strip().upper().replace(" ", "")
    for suffix in sorted(_SIZE_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            body = s[:-len(suffix)]
            try:
                return int(float(body) * _SIZE_SUFFIXES[suffix])
            except ValueError:
                break
    try:
        return int(s)
    except ValueError:
        raise ValueError(
            f"{name}: cannot parse size {text!r}; want an integer byte "
            f"count or a number with a KB/MB/GB suffix") from None


def _parse_bool(text: str, *, name: str) -> bool:
    s = str(text).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off", ""):
        return False
    raise ValueError(f"{name}: cannot parse boolean {text!r}")


def _parse_kernels(text: str, *, name: str) -> str:
    s = str(text).strip().lower()
    if s in ("0", "false", "no"):
        return "off"
    if s not in _KERNELS:
        raise ValueError(f"{name}: want one of {_KERNELS} ('auto' already "
                         f"runs the kernels on every device), got {text!r}")
    return s


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Validated, immutable runtime configuration (see module docstring).

    Build with `RuntimeConfig.resolve(...)` so env overrides apply; the bare
    constructor takes the values as final (the "explicit argument" tier).
    """

    # -- persistent artifact cache -------------------------------------------
    cache_dir: Optional[str] = None          # None = persistence disabled
    cache_max_bytes: int = DEFAULT_CACHE_MAX_BYTES
    prewarm: bool = True                     # background pre-warm on attach
    prewarm_limit: int = DEFAULT_PREWARM_LIMIT
    # -- in-process plan sharing ---------------------------------------------
    share_plans: bool = True                 # content-hash cross-session cache
    # -- formulation, chaos testing, sanitizer -------------------------------
    kernel_backend: str = "auto"             # BFSConfig.backend_kernels=None
    faults: Optional[str] = None             # fault schedule ('' / None = off)
    faults_seed: int = 0
    sanitize: bool = False                   # instrumented locks/timers
    # -- kernel contracts (the session's gate) -------------------------------
    smem_budget_bytes: int = DEFAULT_SMEM_BUDGET   # per-CTA shared memory
    strict_contracts: bool = False           # failing plan: raise vs warn
    # -- launch hygiene (launch_env) -----------------------------------------
    tcmalloc_path: str = DEFAULT_TCMALLOC

    def __post_init__(self):
        if self.kernel_backend not in _KERNELS:
            raise ValueError(f"kernel_backend: want one of {_KERNELS} "
                             f"('auto' already runs the kernels on every "
                             f"device), got {self.kernel_backend!r}")
        if self.cache_max_bytes <= 0:
            raise ValueError(
                f"cache_max_bytes must be > 0, got {self.cache_max_bytes}")
        if self.smem_budget_bytes <= 0:
            raise ValueError(
                f"smem_budget_bytes must be > 0, got {self.smem_budget_bytes}")
        if self.prewarm_limit < 0:
            raise ValueError(
                f"prewarm_limit must be >= 0, got {self.prewarm_limit}")
        if self.cache_dir is not None and not str(self.cache_dir):
            object.__setattr__(self, "cache_dir", None)
        if self.faults is not None and not str(self.faults).strip():
            object.__setattr__(self, "faults", None)
        if self.faults is not None:
            # Validate the schedule grammar eagerly: a typo'd REPRO_FAULTS
            # must fail loudly at config time, not silently inject nothing.
            from repro_torch.runtime.faults import parse_schedule
            parse_schedule(self.faults)

    @classmethod
    def resolve(cls, env: Optional[dict] = None, **explicit) -> "RuntimeConfig":
        """Defaults <- env <- explicit kwargs (later tiers win).

        Explicit kwargs set to None mean "not given" and fall through to
        the env/default tiers; pass `cache_dir=""` to explicitly disable a
        cache the env enables (it normalizes to a disabled cache).
        """
        env = os.environ if env is None else env
        values: dict = {}
        if "REPRO_CACHE_DIR" in env:
            values["cache_dir"] = env["REPRO_CACHE_DIR"] or None
        if "REPRO_CACHE_MAX_BYTES" in env:
            values["cache_max_bytes"] = _parse_size(
                env["REPRO_CACHE_MAX_BYTES"], name="REPRO_CACHE_MAX_BYTES")
        if "REPRO_PREWARM" in env:
            values["prewarm"] = _parse_bool(env["REPRO_PREWARM"],
                                            name="REPRO_PREWARM")
        if "REPRO_PREWARM_LIMIT" in env:
            values["prewarm_limit"] = int(env["REPRO_PREWARM_LIMIT"])
        if "REPRO_SHARE_PLANS" in env:
            values["share_plans"] = _parse_bool(env["REPRO_SHARE_PLANS"],
                                                name="REPRO_SHARE_PLANS")
        if "REPRO_KERNELS" in env:
            values["kernel_backend"] = _parse_kernels(env["REPRO_KERNELS"],
                                                      name="REPRO_KERNELS")
        if "REPRO_FAULTS" in env:
            values["faults"] = env["REPRO_FAULTS"] or None
        if "REPRO_FAULTS_SEED" in env:
            values["faults_seed"] = int(env["REPRO_FAULTS_SEED"])
        if "REPRO_SANITIZE" in env:
            values["sanitize"] = _parse_bool(env["REPRO_SANITIZE"],
                                             name="REPRO_SANITIZE")
        if "REPRO_SMEM_BUDGET" in env:
            values["smem_budget_bytes"] = _parse_size(
                env["REPRO_SMEM_BUDGET"], name="REPRO_SMEM_BUDGET")
        if "REPRO_STRICT_CONTRACTS" in env:
            values["strict_contracts"] = _parse_bool(
                env["REPRO_STRICT_CONTRACTS"], name="REPRO_STRICT_CONTRACTS")
        for key, val in explicit.items():
            if val is None:
                continue
            values[key] = val
        return cls(**values)

    def replace(self, **changes) -> "RuntimeConfig":
        return dataclasses.replace(self, **changes)

    @property
    def cache_enabled(self) -> bool:
        return self.cache_dir is not None

    def launch_env(self) -> dict:
        """The environment a launcher exports before starting python (see
        the module docstring)."""
        env = {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}
        if self.tcmalloc_path and os.path.exists(self.tcmalloc_path):
            env["LD_PRELOAD"] = self.tcmalloc_path
        if self.cache_dir is not None:
            env["REPRO_CACHE_DIR"] = self.cache_dir
        return env


# ------------------------------------------------------- process singleton --

_lock = threading.Lock()
_current: Optional[RuntimeConfig] = None


def get_runtime_config() -> RuntimeConfig:
    """The process-wide `RuntimeConfig` (env-resolved on first use)."""
    global _current
    if _current is None:
        with _lock:
            if _current is None:
                _current = RuntimeConfig.resolve()
    return _current


def configure(**explicit) -> RuntimeConfig:
    """Replace the process config: explicit args > env > defaults."""
    global _current
    with _lock:
        _current = RuntimeConfig.resolve(**explicit)
        return _current


def reset_runtime_config() -> None:
    """Drop the singleton; the next `get_runtime_config` re-reads the env."""
    global _current
    with _lock:
        _current = None


@contextlib.contextmanager
def runtime_scope(**explicit):
    """Temporarily install a config (tests); restores the previous one."""
    global _current
    with _lock:
        prev = _current
        _current = RuntimeConfig.resolve(**explicit)
        cfg = _current
    try:
        yield cfg
    finally:
        with _lock:
            _current = prev


def launch_env(**explicit) -> dict:
    """`RuntimeConfig.resolve(**explicit).launch_env()`: launcher shorthand."""
    return RuntimeConfig.resolve(**explicit).launch_env()

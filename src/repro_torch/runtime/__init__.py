"""Process runtime of the port: one config, a persistent artifact store,
fingerprints, the cross-session plan registry and fault injection.

The layer under everything that builds (the port's counterpart of the JAX
package's `runtime/`):

* `config` — `RuntimeConfig` (the cache dir and its cap, pre-warm and its
  limit, plan sharing, the kernel formulation switch, the fault schedule
  and its seed, the concurrency sanitizer, the kernel contracts' budget,
  the tcmalloc path) with explicit-arg > env > default precedence, plus
  the `launch_env()` launch hygiene.
* `fingerprint` — content fingerprints: the graph's CSR hash, the
  torch/CUDA/card environment, a plan record's fingerprint and a kernel
  library's (source, flags, toolkit, card).
* `artifact_cache` — the disk store for built kernel libraries and plan
  records: atomic write-rename, size-capped LRU eviction, corruption-
  tolerant loads, hit/miss/load-time counters.
* `plan_registry` — the in-process cross-session plan cache, keyed by
  (graph content hash, device, plan key) instead of session identity, so
  two sessions over the same graph share plans and tiles.
* `faults` — the deterministic fault-injection switchboard (`fault_point`
  sites through the session, cache, engine, level driver and server; the
  seeded schedule grammar of `REPRO_FAULTS`), zero overhead when disabled.

`GraphSession` wires them together: a plan comes from the session's
pre-warm pool, then the registry, and only then is built (and its record
written); a session with a cache dir pre-warms its recorded plans on
attach (background thread, observable progress).
"""
from repro_torch.runtime.artifact_cache import (ArtifactCache,
                                                artifact_cache_for)
from repro_torch.runtime.config import (RuntimeConfig, configure,
                                        get_runtime_config, launch_env,
                                        reset_runtime_config, runtime_scope)
from repro_torch.runtime.faults import (DevicePressure, FaultInjected,
                                        FaultInjector, FaultSpec,
                                        fault_point, fault_scope,
                                        install_faults, parse_fault_schedule,
                                        uninstall_faults)
from repro_torch.runtime.fingerprint import (environment_fingerprint,
                                             graph_fingerprint,
                                             kernel_fingerprint,
                                             plan_fingerprint)
from repro_torch.runtime.plan_registry import (registry_reset, registry_size,
                                               registry_stats,
                                               reset_process_caches)

__all__ = [
    "RuntimeConfig", "configure", "get_runtime_config", "launch_env",
    "reset_runtime_config", "runtime_scope",
    "ArtifactCache", "artifact_cache_for",
    "DevicePressure", "FaultInjected", "FaultInjector", "FaultSpec",
    "fault_point", "fault_scope", "install_faults", "parse_fault_schedule",
    "uninstall_faults",
    "environment_fingerprint", "graph_fingerprint", "kernel_fingerprint",
    "plan_fingerprint",
    "registry_reset", "registry_size", "registry_stats",
    "reset_process_caches",
]

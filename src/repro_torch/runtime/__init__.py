"""Process runtime of the port: the runtime config and fault injection.

* `config` — `RuntimeConfig` (the kernel formulation switch, the fault
  schedule and its seed, the concurrency sanitizer) with explicit-arg >
  env > default precedence.
* `faults` — the deterministic fault-injection switchboard (`fault_point`
  sites through the session, engine, level driver and server; the seeded
  schedule grammar of `REPRO_FAULTS`), zero overhead when disabled.

The JAX package's artifact cache, fingerprints and plan registry are not
ported yet (ROADMAP.md queue 1 item 9).
"""
from repro_torch.runtime.config import (RuntimeConfig, configure,
                                        get_runtime_config,
                                        reset_runtime_config, runtime_scope)
from repro_torch.runtime.faults import (DevicePressure, FaultInjected,
                                        FaultInjector, FaultSpec,
                                        fault_point, fault_scope,
                                        install_faults, parse_fault_schedule,
                                        uninstall_faults)

__all__ = [
    "RuntimeConfig", "configure", "get_runtime_config",
    "reset_runtime_config", "runtime_scope",
    "DevicePressure", "FaultInjected", "FaultInjector", "FaultSpec",
    "fault_point", "fault_scope", "install_faults", "parse_fault_schedule",
    "uninstall_faults",
]

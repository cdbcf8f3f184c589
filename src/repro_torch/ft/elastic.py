"""Fault tolerance: elastic re-mesh plans and stragglers (the JAX package's
`ft/elastic.py`; plain Python).

* `plan_remesh`: given the surviving chip count, the largest valid
  degraded mesh (shrink `data`, keep `model` intact: tensor-parallel
  shards hold model state that must stay co-resident; data-parallel
  replicas re-shard freely, since a restore loads the checkpoint onto
  whatever layout the restarted run has, see `checkpoint.py`).
* The restart loop: `launch/train.py` restores the latest checkpoint and
  continues; `tests/test_torch_checkpoint.py` kills and resumes a run.
* Stragglers: the data is stateless (`batch_at(step)`), so a backup
  worker can recompute a straggler's shard without coordination;
  `straggler_budget` is the step timeout after which a shard is
  reassigned, `StepWatchdog` flags steps past it.

Failure detection (heartbeats) and a shared checkpoint store are policy of
the cluster the run is on; both slot behind these interfaces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    shape: tuple
    axes: tuple
    dropped_chips: int
    note: str


def plan_remesh(available_chips: int, model_parallel: int = 16,
                pods: int = 1) -> RemeshPlan:
    """Largest (pod, data, model) mesh using <= available_chips.

    `model` is pinned (the tensor-parallel group size is a property of the
    program and the weight layout); `data` shrinks to the largest fit;
    whole pods drop only when a pod retains < one data row.
    """
    if available_chips < model_parallel:
        raise ValueError(
            f"cannot keep model-parallel group of {model_parallel} with "
            f"{available_chips} chips")
    per_pod = available_chips // pods
    data = per_pod // model_parallel
    while pods > 1 and data == 0:
        pods -= 1
        per_pod = available_chips // pods
        data = per_pod // model_parallel
    used = pods * data * model_parallel
    shape = (pods, data, model_parallel) if pods > 1 else (data, model_parallel)
    axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return RemeshPlan(shape, axes, available_chips - used,
                      f"kept TP={model_parallel}, data {data}/pod, "
                      f"{available_chips - used} chips idle until next resize")


def straggler_budget(median_step_s: float, factor: float = 2.0,
                     floor_s: float = 5.0) -> float:
    """Timeout after which a worker's shard is recomputed by a backup."""
    return max(median_step_s * factor, floor_s)


@dataclasses.dataclass
class StepWatchdog:
    """Tracks step durations; flags stragglers (on the host)."""
    factor: float = 2.0
    _durations: list = dataclasses.field(default_factory=list)

    def record(self, seconds: float):
        self._durations.append(seconds)

    @property
    def median(self) -> Optional[float]:
        if not self._durations:
            return None
        s = sorted(self._durations)
        return s[len(s) // 2]

    def is_straggler(self, seconds: float) -> bool:
        m = self.median
        return m is not None and seconds > straggler_budget(m, self.factor)

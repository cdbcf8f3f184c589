"""The per-level BFS loop: one driver for every host-synced search.

The port of the JAX package's `engine/level_loop.py`: `CohortBatchBackend`
(the batched cohort path), `SingleStepBackend` (one root, the stepper) and
`BSPStepBackend` (one rank of the partitioned BSP search). The level driver
owns the loop, the stats-row schema, the `on_level` streaming hook, the
termination bound (checked before stepping: no level can exceed the vertex
count minus one), cooperative cancellation, and the one host sync per
level.

That sync is one device-to-host copy: a backend's `scalars(state)` is a
dict of device tensors (loop condition, direction decisions, cohort
occupancy, per-lane vectors); `host_sync` stacks them into one int64
tensor, calls `.cpu()` once, and unpacks on the host. Each level's work is
timed up to a fence, `torch.cuda.synchronize(device)` on a GPU and nothing
on the CPU.

A backend, duck-typed:

    depth_bound: int                 # vertex count - 1
    device: torch.device
    def init(root) -> state
    def scalars(state) -> dict       # device tensors with nf, mf, cur
    def step(state, sync) -> state   # sync: the host dict of the last sync
    def row(pre, post, seconds) -> dict   # row fields beyond the driver's
    def finalize(state) -> (parent, level)  # host numpy

A backend whose level is a compute phase and an exchange phase (the BSP
backend) has `compute(state, sync) -> work` and `exchange(state, work) ->
state` in place of `step`; the driver fences after each and reports their
seconds as the row's `compute_s` and `exchange_s` (the paper's Fig. 3
breakdown). For the other backends `compute_s` is the level's seconds and
`exchange_s` is 0.0.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import bfs as B
from repro_torch.core.hybrid_bfs import finalize_hybrid


# ------------------------------------------------------------ cancellation --


class QueryCancelled(RuntimeError):
    """Query aborted by `QueryControl.cancel()` (between two BFS levels).

    `per_level_stats` holds the stats rows completed before the abort.
    """

    def __init__(self, msg: str = "query cancelled", per_level_stats=None):
        super().__init__(msg)
        self.per_level_stats = per_level_stats if per_level_stats is not None \
            else []


class QueryDeadlineExceeded(RuntimeError):
    """Query aborted because its `QueryControl.deadline` passed.

    Carries `per_level_stats` exactly like `QueryCancelled`.
    """

    def __init__(self, msg: str = "query deadline exceeded",
                 per_level_stats=None):
        super().__init__(msg)
        self.per_level_stats = per_level_stats if per_level_stats is not None \
            else []


class QueryControl:
    """Cancel event + absolute deadline for one query (thread-safe).

    `LevelDriver` calls `check()` once per level. `deadline` is an absolute
    `time.monotonic()` timestamp (`with_timeout` converts relative seconds);
    `cancel()` may be called from any thread.
    """

    def __init__(self, deadline: Optional[float] = None):
        self.deadline = deadline
        self._cancelled = threading.Event()

    @classmethod
    def with_timeout(cls, seconds: Optional[float]) -> "QueryControl":
        """Control whose deadline is `seconds` from now (None = no deadline)."""
        return cls(None if seconds is None else time.monotonic() + seconds)

    def cancel(self) -> None:
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() >= self.deadline

    def poll(self) -> Optional[RuntimeError]:
        """The pending abort, if any (None = keep running). Never raises."""
        if self._cancelled.is_set():
            return QueryCancelled()
        if self.expired:
            return QueryDeadlineExceeded(
                f"deadline passed {time.monotonic() - self.deadline:.3f}s ago")
        return None

    def check(self) -> None:
        """Raise the typed abort error if cancelled or past the deadline."""
        err = self.poll()
        if err is not None:
            raise err


def fence(device: torch.device) -> None:
    """Wait for the device's queued work (a timing fence); no-op on CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------- backend --


class CohortBatchBackend:
    """Batched cohort backend: SoA `[B, ...]` state, per-level cohort dispatch.

    Each level the host reads the next step's cohort occupancy from the one
    sync and dispatches exactly ONE step function: "td" or "bu" when the
    whole batch agrees, "mixed" when both cohorts are non-empty.
    `dispatched` counts dispatches per variant.

    `init((roots, active))` takes int32[B] roots (pad lanes repeat a valid
    id) and the bool[B] mask that keeps pad lanes out of every cohort from
    level 0.
    """

    def __init__(self, init_fn: Callable, step_fns: dict,
                 num_vertices: int, bucket: int, device: torch.device):
        self._init = init_fn
        self._steps = dict(step_fns)        # reachable variants only
        self.depth_bound = max(num_vertices - 1, 0)
        self.bucket = bucket
        self.device = torch.device(device)
        self.dispatched = {v: 0 for v in self._steps}

    def init(self, root):
        roots, active = root
        return self._init(roots, active)

    @staticmethod
    def scalars(state) -> dict:
        return B.batch_scalars(state)

    @staticmethod
    def finalize(state):
        return B.finalize(state)

    @staticmethod
    def variant_for(td_next: int, bu_next: int) -> str:
        if td_next and bu_next:
            return "mixed"
        return "bu" if bu_next else "td"

    def step(self, state, sync):
        """One level: the step function the last sync's cohorts call for."""
        variant = self.variant_for(int(sync["td_next"]), int(sync["bu_next"]))
        self.dispatched[variant] += 1
        return self._steps[variant](state)

    def warm(self, root) -> None:
        """Run init, the sync and each step variant once on the init state
        (the results are dropped), then wait for the device. A query timed
        after this pays no kernel library load, first launch, occupancy
        query or first allocator growth at this batch bucket; the first
        level that flips the batch into a new variant would otherwise pay
        them inside its seconds."""
        state = self.init(root)
        host_sync(self.scalars(state))
        for step in self._steps.values():
            step(state)
        fence(self.device)

    def row(self, pre, post, seconds) -> dict:
        """The level's stats-row fields beyond the driver's own."""
        # td/bu_lanes count active lanes with ANY side in that direction;
        # with the hub/tail split off the hub counters are zero and the hub
        # lane direction mirrors the tail's, as in the reference's rows.
        used_td = int(pre["td_next"])
        used_bu = int(pre["bu_next"])
        nf_hub = int(pre["nf_hub"])
        return dict(
            direction=("mixed" if used_td and used_bu
                       else ("bu" if used_bu else "td")),
            td_lanes=used_td,
            bu_lanes=used_bu,
            hub_td_lanes=int(post["used_td_hub"]),
            hub_bu_lanes=int(post["used_bu_hub"]),
            frontier_hub=nf_hub,
            frontier_tail=int(pre["nf"]) - nf_hub,
            active_lanes=int(pre["active_n"]),
            batch=self.bucket,
            lane_frontier=[int(x) for x in pre["nf_lanes"]],
            lane_edges=[int(x) for x in pre["mf_lanes"]],
            lane_direction=["bu" if x else "td" for x in pre["bu_lanes"]],
            lane_hub_direction=["bu" if x else "td"
                                for x in pre["hub_bu_lanes"]],
            lane_hub_frontier=[int(x) for x in pre["nf_hub_lanes"]],
            lane_active=[bool(x) for x in pre["active_lanes"]],
        )


class SingleStepBackend:
    """One root: one `(state, bu) -> state` step per level.

    Wraps `repro_torch.core.bfs`'s `init_state`, `make_level_step` and
    `state_scalars`. The step's direction comes from the last sync
    (`bu_next`), so the host branches without a second device read.
    """

    def __init__(self, init_fn: Callable, step_fn: Callable,
                 scalars_fn: Callable, num_vertices: int,
                 device: torch.device):
        self._init = init_fn
        self._step = step_fn
        self.scalars = scalars_fn
        self.depth_bound = max(num_vertices - 1, 0)
        self.device = torch.device(device)

    def init(self, root):
        return self._init(int(root))

    def step(self, state, sync):
        return self._step(state, sync["bu_next"])

    @staticmethod
    def row(pre, post, seconds) -> dict:
        return dict(direction="bu" if post["bu"] else "td")

    @staticmethod
    def finalize(state):
        return B.finalize(state)


class BSPStepBackend:
    """One rank of the partitioned BSP search, over `make_hybrid_stepper`'s
    pieces: `compute` runs the rank's local step (no communication),
    `exchange` the OR exchange and the state update; the driver times them
    apart. `init` takes an original vertex id; `finalize` runs the min
    all-reduce and maps the padded new-id results back to original ids
    through the partition plan. Every rank of the group drives the same
    root, level by level."""

    def __init__(self, pieces, plan, device: torch.device):
        self._pieces = pieces
        self._plan = plan
        self.scalars = pieces.scalars
        self.depth_bound = max(plan.v_orig - 1, 0)
        self.device = torch.device(device)

    def init(self, root):
        return self._pieces.init(self._pieces.root_mapper(int(root)))

    def compute(self, state, sync):
        return self._pieces.compute(state, sync["bu_next"])

    def exchange(self, state, work):
        return self._pieces.exchange(state, *work)

    @staticmethod
    def row(pre, post, seconds) -> dict:
        return dict(direction="bu" if post["bu"] else "td")

    def finalize(self, state):
        parent_new, level_new = self._pieces.finalize(state)
        return finalize_hybrid(self._plan, parent_new, level_new)


# ------------------------------------------------------------------ driver --


def host_sync(payload: dict) -> dict:
    """THE per-level host sync: one device-to-host copy of a dict of tensors.

    Every value (int or bool, scalar or vector) is flattened into one int64
    tensor, copied to the host with a single `.cpu()`, and unpacked: scalars
    become Python ints/bools, vectors numpy int32/bool arrays.
    """
    keys = list(payload)
    flat = [payload[k].reshape(-1).to(torch.int64) for k in keys]
    host = torch.cat(flat).cpu().numpy()
    out, off = {}, 0
    for k, t in zip(keys, flat):
        n = t.numel()
        part = host[off:off + n]
        off += n
        is_bool = payload[k].dtype == torch.bool
        if payload[k].dim() == 0:
            out[k] = bool(part[0]) if is_bool else int(part[0])
        else:
            out[k] = part.astype(bool if is_bool else np.int32)
    return out


class LevelDriver:
    """Run a whole search as host-synced per-level steps over a backend."""

    def __init__(self, backend):
        self.backend = backend

    def run(self, root, on_level: Optional[Callable] = None,
            control: Optional[QueryControl] = None):
        """One search -> (parent, level, per_level_stats, timings).

        `root` is what the backend's `init` takes. `on_level(row)` fires the
        moment each level's stats land on the host. `control` is checked
        once per level before stepping; on abort the typed error carries the
        rows completed so far. `timings` holds the out-of-loop phases
        (init_s, agg_s) and `driver_overhead_s`, the wall time the host loop
        spent outside the timed steps.
        """
        b = self.backend
        split = hasattr(b, "exchange")
        t_run = time.perf_counter()
        state = b.init(root)
        fence(b.device)
        init_s = time.perf_counter() - t_run
        stats: list = []
        pre = host_sync(b.scalars(state))
        while pre["nf"] > 0 and pre["cur"] < b.depth_bound:
            if control is not None:
                try:
                    control.check()
                except (QueryCancelled, QueryDeadlineExceeded) as e:
                    e.per_level_stats = stats
                    raise
            t0 = time.perf_counter()
            if split:
                work = b.compute(state, pre)
                fence(b.device)
                t1 = time.perf_counter()
                state = b.exchange(state, work)
            else:
                state = b.step(state, pre)
            fence(b.device)
            t2 = time.perf_counter()
            if not split:
                t1 = t2           # one step: compute_s == seconds
            post = host_sync(b.scalars(state))
            row = dict(level=post["cur"], seconds=t2 - t0, compute_s=t1 - t0,
                       exchange_s=t2 - t1, frontier_size=pre["nf"],
                       frontier_edges=pre["mf"])
            row.update(b.row(pre, post, t2 - t0))
            stats.append(row)
            if on_level:
                on_level(row)
            pre = post
        t0 = time.perf_counter()
        parent, level = b.finalize(state)
        agg_s = time.perf_counter() - t0
        overhead = (time.perf_counter() - t_run) - init_s - agg_s \
            - sum(r["seconds"] for r in stats)
        return parent, level, stats, dict(init_s=init_s, agg_s=agg_s,
                                          driver_overhead_s=max(overhead, 0.0))

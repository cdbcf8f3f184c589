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

The driver's clock reads are those of its spans (`runtime.trace`): a
search is `driver.run`; `init_s` is `driver.init`; a row's `seconds` is
its `level.issue` (the host issuing the step) plus its `level.wait` (the
fence), one pair for each phase of a split level; each `host_sync` is a
`level.sync`; `agg_s` is `finalize`, the backend's finalize: the result's
copy to the host, and under it `finalize.map`, the issue of the mapping to
Graph500 conventions that `core.bfs.finalize` runs on the device before
the copy. The driver keeps the whole search's seconds,
`driver.run`'s, as `run_s`.

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

Before each level's step the driver passes one check point
(`check_point`): the control's check, then two fault sites
(`runtime.faults`): `straggler` (a scheduled delay) and `dispatch` (a
scheduled raise, before the step runs, so the state is never
half-advanced), each with the level and the backend's `fault_ctx` (the
engine's description of the dispatch: mode and formulation).

A partitioned query served through a front (`engine.partition_front`)
runs on every rank of its group, and every rank must leave it at the same
point: its control is an `AgreedControl`, which makes each check point one
agreement of the group. The front alone polls the query's control and
runs the point's fault sites, then broadcasts the outcome; each rank acts
on it there (the front re-raises its own exception, a follower raises
`AgreedAbort`). Any other control keeps the single-rank code path.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bfs as B
from repro_torch.core.hybrid_bfs import finalize_hybrid
from repro_torch.runtime import trace
from repro_torch.runtime.faults import fault_point


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


class AgreedAbort(RuntimeError):
    """A follower's end of a partitioned query that the front aborted at a
    check point; `kind` is the front's outcome ("cancelled", "deadline" or
    "fault"). The follower's search stops there, with the front's."""

    def __init__(self, kind: str):
        self.kind = kind
        super().__init__(f"the front aborted the query at a check point "
                         f"({kind})")


# An agreement's outcome, broadcast as its index (0: go on).
_OUTCOMES = ("go", "cancelled", "deadline", "fault")


def _outcome(err: Optional[BaseException]) -> int:
    if err is None:
        return 0
    if isinstance(err, QueryCancelled):
        return 1
    return 2 if isinstance(err, QueryDeadlineExceeded) else 3


class AgreedControl(QueryControl):
    """The control of one partitioned query on one rank of its group.

    Each `check(*sites)` is one agreement over `channel` (a gloo group of
    the same ranks): on the front (`is_front`, rank 0) it polls `inner`
    (the query's own control; None: never aborts) and runs the fault sites,
    each a (site, ctx) pair, then broadcasts the outcome; every rank waits
    for it. The front re-raises its own exception (and keeps it in
    `abort`), a follower raises `AgreedAbort`. `on_agree(seconds, aborted)`
    (front only) receives each broadcast's seconds. Cancel and poll go to
    `inner`.
    """

    def __init__(self, inner: Optional[QueryControl], channel, is_front: bool,
                 on_agree: Optional[Callable] = None):
        super().__init__(None)
        self.inner = inner
        self.channel = channel
        self.is_front = is_front
        self.abort: Optional[BaseException] = None
        self._src = dist.get_global_rank(channel, 0)
        self._on_agree = on_agree

    def cancel(self) -> None:
        if self.inner is not None:
            self.inner.cancel()

    @property
    def cancelled(self) -> bool:
        return self.inner is not None and self.inner.cancelled

    @property
    def expired(self) -> bool:
        return self.inner is not None and self.inner.expired

    def poll(self) -> Optional[RuntimeError]:
        return None if self.inner is None else self.inner.poll()

    def check(self, *sites, control: bool = True) -> None:
        """One agreement: `inner`'s check (unless `control` is False) and
        the fault `sites` on the front, the outcome on every rank."""
        err = None
        if self.is_front:
            try:
                if control and self.inner is not None:
                    self.inner.check()
                for site, ctx in sites:
                    fault_point(site, **ctx)
            except Exception as e:  # noqa: BLE001 — every rank must learn it
                err = e
        flag = torch.tensor([_outcome(err)], dtype=torch.int64)
        t0 = time.perf_counter()
        dist.broadcast(flag, src=self._src, group=self.channel)
        if self.is_front:
            if self._on_agree is not None:
                self._on_agree(time.perf_counter() - t0, err is not None)
            if err is not None:
                self.abort = err
                raise err
        elif int(flag[0]):  # repro-ok: TH002 a CPU tensor (gloo channel)
            raise AgreedAbort(_OUTCOMES[int(flag[0])])  # repro-ok: TH002 same


def check_point(control: Optional[QueryControl], *sites,
                check: bool = True) -> None:
    """One check point of a query: the control's check (unless `check` is
    False), then the fault `sites`, each a (site, ctx) pair, in order. With
    an `AgreedControl` it is one agreement of the query's group; otherwise
    it runs here, on this rank alone."""
    if isinstance(control, AgreedControl):
        control.check(*sites, control=check)
        return
    if check and control is not None:
        control.check()
    for site, ctx in sites:
        fault_point(site, **ctx)


def fence(device: torch.device) -> None:
    """Wait for the device's queued work (a timing fence); no-op on CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # repro-ok: TH001 the timing fence


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
    with trace.span("level.sync"):
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
        self.run_s = None     # the last run's seconds (its `driver.run`)

    def run(self, root, on_level: Optional[Callable] = None,
            control: Optional[QueryControl] = None):
        """One search -> (parent, level, per_level_stats, timings).

        `root` is what the backend's `init` takes. `on_level(row)` fires the
        moment each level's stats land on the host. `control` is checked
        once per level before stepping (`check_point`, with the level's
        fault sites); on abort the typed error carries the rows completed
        so far. `timings` holds the out-of-loop phases
        (init_s, agg_s) and `driver_overhead_s`, the wall time the host loop
        spent outside the timed steps.
        """
        b = self.backend
        split = hasattr(b, "exchange")
        with trace.span("driver.run") as run:
            t_run = run.start
            init = trace.span("driver.init", t=t_run)
            state = b.init(root)
            fence(b.device)
            init_s = init.close() - t_run
            stats: list = []
            pre = host_sync(b.scalars(state))
            while pre["nf"] > 0 and pre["cur"] < b.depth_bound:
                fctx = dict(level=pre["cur"],
                            **(getattr(b, "fault_ctx", None) or {}))
                try:
                    check_point(control, ("straggler", fctx),
                                ("dispatch", fctx))
                except (QueryCancelled, QueryDeadlineExceeded) as e:
                    e.per_level_stats = stats
                    raise
                step = trace.span("level.issue", level=pre["cur"])
                t0 = step.start
                if split:
                    work = b.compute(state, pre)
                    step.split("level.wait")
                    fence(b.device)
                    t1 = step.split("level.issue")
                    state = b.exchange(state, work)
                else:
                    state = b.step(state, pre)
                step.split("level.wait")
                fence(b.device)
                t2 = step.close()
                if not split:
                    t1 = t2           # one step: compute_s == seconds
                post = host_sync(b.scalars(state))
                row = dict(level=post["cur"], seconds=t2 - t0,
                           compute_s=t1 - t0, exchange_s=t2 - t1,
                           frontier_size=pre["nf"], frontier_edges=pre["mf"])
                row.update(b.row(pre, post, t2 - t0))
                stats.append(row)
                if on_level:
                    on_level(row)
                pre = post
            fin = trace.span("finalize")
            parent, level = b.finalize(state)
            t_end = run.close(fin.close())
        self.run_s = t_end - t_run
        agg_s = t_end - fin.start
        overhead = (t_end - t_run) - init_s - agg_s \
            - sum(r["seconds"] for r in stats)
        return parent, level, stats, dict(init_s=init_s, agg_s=agg_s,
                                          driver_overhead_s=max(overhead, 0.0))

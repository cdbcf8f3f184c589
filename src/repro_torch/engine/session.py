"""Graph sessions: preprocessing ownership and step-function caching.

A `GraphSession` holds one graph's device-side products, each built at
most once: the CSR tensors (`device_graph`), the degree-bucketed ELL tiles
(`ell_tiles`), every partitioning requested (`partitioned`, keyed by
(n_parts, strategy, hub_edge_fraction)) with this rank's tiles of it
(`hybrid_ell`), the cohort step functions keyed by (config, batch bucket,
variant), the single-root step per config and the partitioned searches
and steppers. PyTorch runs eagerly, so a "step function" is a bound Python
function, not a compiled executable; caching it keeps the session the one
owner of what a query runs. `warm` records which warm-up searches already
ran.

A partitioned query runs on a `torch.distributed` group with one rank per
partition (`group_for`): the session's own group, else the default group.
Each rank holds its own session over the same graph.

On a CUDA device the session also builds the kernels (`kernels._build`)
before its first query on the tile formulation, so the build never lands
inside a timed search. `runtime_stats()` counts what the session built
(by kind), the warm-ups it ran and the kernel build's seconds.

A build in `cached` passes the `compile` fault site (`runtime.faults`),
the port's counterpart of the JAX package's trace; a build that raises is
not cached, so the next query builds again. Construction installs the
concurrency sanitizer and the fault schedule from the runtime config
(`REPRO_SANITIZE`, `REPRO_FAULTS`) if none is installed.

Sessions are thread-safe: every cache is guarded by one re-entrant lock
with double-checked builds.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch.distributed as dist

from repro_torch.analysis.concurrency import ensure_installed as _ensure_sanitizer
from repro_torch.analysis.concurrency import make_lock, make_rlock

from repro_torch.core import ell as ELL
from repro_torch.core import partition as PT
from repro_torch.core.bfs import DeviceGraph
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device
from repro_torch.runtime.faults import ensure_installed as _ensure_faults
from repro_torch.runtime.faults import fault_point


class GraphSession:
    """Owns one graph's device tensors, ELL tiles and step functions.

    `group` is the `torch.distributed` group of partitioned queries (None:
    the default group, if one is initialized); `default_strategy` and
    `default_hub_edge_fraction` are their partitioning defaults.

    The JAX package's session also keeps a persistent artifact cache, a
    background pre-warm, graph fingerprints and a kernel contract gate;
    none of those is ported yet (ROADMAP.md queue 1, items 9-10).
    """

    def __init__(self, graph: Graph, device=None, *, group=None,
                 default_strategy: str = "specialized",
                 default_hub_edge_fraction: float = 0.5):
        if default_strategy not in PT.STRATEGIES:
            raise ValueError(f"unknown strategy {default_strategy!r}; "
                             f"want one of {PT.STRATEGIES}")
        self.graph = graph
        self.device = resolve_device(device)
        self.default_strategy = default_strategy
        self.default_hub_edge_fraction = default_hub_edge_fraction
        self._group = group
        _ensure_sanitizer()              # REPRO_SANITIZE instruments these
        self._lock = make_rlock("session")
        self._stats_lock = make_lock("session.stats")
        self._device_graph: Optional[DeviceGraph] = None
        self._partitions: dict = {}
        self._objects: dict[Any, Any] = {}
        self._warmed: set = set()
        self._kernels_built = False
        self._builds: dict = {}          # kind (key[0]) -> builds
        self._kernel_build_s = 0.0
        _ensure_faults()                 # REPRO_FAULTS chaos schedule, if any

    def device_graph(self) -> DeviceGraph:
        """CSR tensors on the session's device (built once)."""
        if self._device_graph is None:
            with self._lock:
                if self._device_graph is None:
                    self._device_graph = DeviceGraph.from_graph(self.graph,
                                                                self.device)
        return self._device_graph

    def ell_tiles(self, *, base: int = ELL.DEFAULT_BASE,
                  growth: int = ELL.DEFAULT_GROWTH):
        """Degree-bucketed ELL tiles on the session's device (built once
        per (base, growth))."""
        return self.cached(("ell", base, growth),
                           lambda: ELL.build_graph_ell(
                               self.graph, device=self.device, base=base,
                               growth=growth))

    def partitioned(self, n_parts: int, strategy: Optional[str] = None,
                    hub_edge_fraction: Optional[float] = None):
        """(plan, partitioned_graph) for a partitioning, built once (host
        numpy, every partition's blocks)."""
        strategy = strategy or self.default_strategy
        hub = (self.default_hub_edge_fraction
               if hub_edge_fraction is None else hub_edge_fraction)
        key = (n_parts, strategy, hub)
        got = self._partitions.get(key)
        if got is None:
            with self._lock:
                got = self._partitions.get(key)
                if got is None:
                    plan = PT.make_plan(self.graph, n_parts, strategy,
                                        hub_edge_fraction=hub)
                    got = (plan, PT.apply_plan(self.graph, plan))
                    self._partitions[key] = got
        return got

    def hybrid_ell(self, n_parts: int, strategy: Optional[str] = None,
                   hub_edge_fraction: Optional[float] = None, *,
                   base: int = ELL.DEFAULT_BASE,
                   growth: int = ELL.DEFAULT_GROWTH):
        """This rank's ELL tiles of a partitioning, on the session's device
        (built once per partitioning and (base, growth))."""
        strategy = strategy or self.default_strategy
        hub = (self.default_hub_edge_fraction
               if hub_edge_fraction is None else hub_edge_fraction)
        rank = dist.get_rank(self.group_for(n_parts))
        _plan, pg = self.partitioned(n_parts, strategy, hub)
        return self.cached(("hybrid_ell", n_parts, strategy, hub, base,
                            growth),
                           lambda: ELL.build_hybrid_ell(
                               pg, rank, device=self.device, base=base,
                               growth=growth))

    def group_for(self, n_parts: int):
        """The process group of an `n_parts`-partition query: the session's
        group, else the default group. Raises `ValueError` unless it has
        exactly `n_parts` ranks (one per partition); a partitioned query
        never runs in one process instead."""
        fix = (f"start one rank per partition: `torchrun --standalone "
               f"--nproc-per-node {n_parts}` or "
               f"`repro_torch.parallel.ranks.run_ranks(fn, {n_parts}, ...)`")
        group = self._group
        if group is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    f"{n_parts} partitions need a torch.distributed group "
                    f"of {n_parts} ranks and none is initialized; {fix}")
            group = dist.group.WORLD
        size = dist.get_world_size(group)
        if size != n_parts:
            raise ValueError(f"the process group has {size} ranks but the "
                             f"query wants {n_parts} partitions; {fix}")
        return group

    def world_size(self) -> int:
        """Ranks of the session's group, else of the default group; 1 when
        there is none."""
        if self._group is not None:
            return dist.get_world_size(self._group)
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    def ensure_kernels(self) -> None:
        """Build the CUDA kernels once, before the first query on a GPU."""
        if self.device.type != "cuda" or self._kernels_built:
            return
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()             # takes the build's own lock
        with self._stats_lock:
            self._kernel_build_s += time.perf_counter() - t0
        self._kernels_built = True

    def cached(self, key, build: Callable[[], Any]) -> Any:
        """Build `key`'s object once (step functions, tiles, backends).
        A build passes the `compile` fault site first; one that raises is
        not cached."""
        got = self._objects.get(key)
        if got is None:
            with self._lock:
                got = self._objects.get(key)
                if got is None:
                    fault_point("compile", key=key)
                    got = build()
                    self._objects[key] = got
                    with self._stats_lock:
                        self._builds[key[0]] = self._builds.get(key[0],
                                                                0) + 1
        return got

    def warm(self, key, run: Callable[[], Any]) -> None:
        """Run `run()` (a warm-up search) once per `key`. Only a run that
        returns is recorded: one that raises is tried again next time."""
        if key in self._warmed:
            return
        with self._lock:
            if key not in self._warmed:
                run()
                self._warmed.add(key)

    def runtime_stats(self) -> dict:
        """What this session built: cached objects by kind (the key's first
        element: "ell", "cohort", "stepper_step", ...), the warm-up
        searches run, and the seconds its call of the kernel build took
        (a wait for another session's build included; near 0 when the
        libraries were built already, 0.0 on the CPU)."""
        with self._lock, self._stats_lock:
            return dict(builds=dict(self._builds),
                        warmups=len(self._warmed),
                        kernel_build_s=self._kernel_build_s)

    def signal_close(self) -> None:
        """The server's teardown step that asks a session's background work
        to stop before anything is joined. The port's session starts no
        thread (the JAX package's pre-warm is not ported), so there is
        nothing to signal."""

    def close(self, timeout: Optional[float] = None) -> bool:
        """Drop the session's device tensors and step functions (a later
        query builds them again); True, since no thread is left to join.
        Call it once no query runs on the session (`BFSServer.close` joins
        its workers first)."""
        del timeout
        with self._lock:
            self._device_graph = None
            self._objects.clear()
            self._warmed.clear()
        return True

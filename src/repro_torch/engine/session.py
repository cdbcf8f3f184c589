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
before its first query, so the build never lands inside a timed search.

Sessions are thread-safe: every cache is guarded by one re-entrant lock
with double-checked builds.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

import torch.distributed as dist

from repro_torch.core import ell as ELL
from repro_torch.core import partition as PT
from repro_torch.core.bfs import DeviceGraph
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device


class GraphSession:
    """Owns one graph's device tensors, ELL tiles and step functions.

    `group` is the `torch.distributed` group of partitioned queries (None:
    the default group, if one is initialized); `default_strategy` and
    `default_hub_edge_fraction` are their partitioning defaults.

    The JAX package's session also keeps a persistent artifact cache, a
    background pre-warm, graph fingerprints, fault points and a kernel
    contract gate; none of those is ported yet (ROADMAP.md queue 1, items
    9-10).
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
        self._lock = threading.RLock()
        self._device_graph: Optional[DeviceGraph] = None
        self._partitions: dict = {}
        self._objects: dict[Any, Any] = {}
        self._warmed: set = set()
        self._kernels_built = False

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
        _build.build_all()             # takes the build's own lock
        self._kernels_built = True

    def cached(self, key, build: Callable[[], Any]) -> Any:
        """Build `key`'s object once (step functions, tiles, backends)."""
        got = self._objects.get(key)
        if got is None:
            with self._lock:
                got = self._objects.get(key)
                if got is None:
                    got = build()
                    self._objects[key] = got
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

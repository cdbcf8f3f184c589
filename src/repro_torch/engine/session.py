"""Graph sessions: preprocessing ownership and step-function caching.

A `GraphSession` holds one graph's device-side products, each built at
most once: the CSR tensors (`device_graph`), the degree-bucketed ELL tiles
(`ell_tiles`), the cohort step functions keyed by
(config, batch bucket, variant) and the single-root step per config.
PyTorch runs eagerly, so a "step function" is a bound Python function, not
a compiled executable; caching it keeps the session the one owner of what
a query runs. `warm` records which warm-up searches already ran.

On a CUDA device the session also builds the kernels (`kernels._build`)
before its first query, so the build never lands inside a timed search.

Sessions are thread-safe: every cache is guarded by one re-entrant lock
with double-checked builds.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from repro_torch.core import ell as ELL
from repro_torch.core.bfs import DeviceGraph
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device


class GraphSession:
    """Owns one graph's device tensors, ELL tiles and step functions.

    The JAX package's session also keeps a persistent artifact cache, a
    background pre-warm, graph fingerprints, fault points and a kernel
    contract gate; none of those is ported yet (ROADMAP.md queue 1, items
    9-10).
    """

    def __init__(self, graph: Graph, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._device_graph: Optional[DeviceGraph] = None
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

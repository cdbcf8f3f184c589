"""Graph sessions: preprocessing ownership, plans and their runtime tiers.

A `GraphSession` holds one graph's device-side products, each built at
most once: the CSR tensors (`device_graph`), the degree-bucketed ELL tiles
(`ell_tiles`), every partitioning requested (`partitioned`, keyed by
(n_parts, strategy, hub_edge_fraction)) with this rank's tiles of it
(`hybrid_ell`), the single-root step per config and the partitioned
searches and steppers (`cached`), and the cohort plans (`executable`).
PyTorch runs eagerly, so a plan is a step function (a closure over the
session's CSR and tiles), not a compiled executable; `warm` records which
warm-up searches already ran.

A cohort plan, keyed ("cohort", config, use_kernels, bucket, variant),
comes from the first of three tiers (the `repro_torch.runtime` layer, as
in the JAX package's session):

1. **the pre-warm pool**: with `RuntimeConfig.cache_dir` set, a session
   starts a background thread at attach that scans the artifact cache for
   plan records of this graph and environment and, up to
   `prewarm_limit`, rebuilds each (the kernel libraries, loaded from the
   cache; the tiles; the hub split; the step function) into a pool. A
   query whose plan the pass still has pending waits for it
   (`prewarm_progress` is the observable handle, `prewarm_wait()` blocks);
2. **the registry** (`RuntimeConfig.share_plans`): plans keyed by the
   graph's content hash, the device and the key, so two sessions over the
   same graph (or a rebuilt, byte-identical one) share one plan, its
   tiles and its CSR; the build counts on the session that made it;
3. **a build on the query path**, which also writes the plan's record to
   the cache, so a restarted process pre-warms it.

`load_count` / `materialize_count` and `runtime_stats()` make the tiers
observable: a pre-warmed plan is a load, a query-path build a build, a
registry hit a share. A step function is never pickled: the record holds
the key, and pre-warm rebuilds the plan from it (`plan_build`).

A partitioned query runs on a `torch.distributed` group with one rank per
partition (`group_for`): the session's own group, else the default group.
Each rank holds its own session over the same graph; the stepper, hybrid
and sharded objects stay session-local (`cached`).

On a CUDA device a plan's build first makes the kernels ready
(`ensure_kernels`: `kernels._build`, through the cache when one is set),
so the build never lands inside a timed search. A pre-warm thread binds
the session's device and synchronizes it before a plan enters the pool.

A build in `cached` or `executable` passes the `compile` fault site
(`runtime.faults`), the port's counterpart of the JAX package's trace; a
build that raises is not kept, so the next query builds again. The cache's
loads pass `cache_load`. Construction installs the concurrency sanitizer
and the fault schedule from the runtime config (`REPRO_SANITIZE`,
`REPRO_FAULTS`) if none is installed.

Sessions are thread-safe: every cache is guarded by one re-entrant lock
with double-checked builds; a plan builds under its own lock (once
process-wide), never under the session's, and counters live under a
leaf-level `_stats_lock`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.analysis.concurrency import ensure_installed as _ensure_sanitizer
from repro_torch.analysis.concurrency import (make_condition, make_lock,
                                              make_rlock)

from repro_torch.core import bfs as B
from repro_torch.core import ell as ELL
from repro_torch.core import partition as PT
from repro_torch.core.bfs import DeviceGraph
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device
from repro_torch.runtime import trace
from repro_torch.runtime.artifact_cache import artifact_cache_for
from repro_torch.runtime.config import RuntimeConfig, get_runtime_config
from repro_torch.runtime.faults import ensure_installed as _ensure_faults
from repro_torch.runtime.faults import fault_point
from repro_torch.runtime.fingerprint import (canonical_plan_key,
                                             environment_fingerprint,
                                             graph_fingerprint,
                                             plan_fingerprint)
from repro_torch.runtime.plan_registry import (registry_drop, registry_get,
                                               registry_put)


class _Plan:
    """One plan, built on its first `resolve()` under its own lock.

    May be shared across sessions through the registry: it builds at most
    once process-wide, and its build (or pre-warm load) and record land on
    the session that made it (`_session`), whoever resolves it. The first
    resolver names the path: "built" (a query) or "prewarmed".
    """

    __slots__ = ("key", "_build", "_session", "_fp", "_lock", "fn")

    def __init__(self, key, build: Callable[[], Callable],
                 session: "GraphSession", fingerprint: Optional[str]):
        self.key = key
        self._build = build
        self._session = session
        self._fp = fingerprint           # None = no record written
        self._lock = make_lock("plan")
        self.fn: Optional[Callable] = None

    def resolve(self, source: str = "built") -> Callable:
        if self.fn is None:
            with self._lock:
                if self.fn is None:
                    self.fn = self._session._build_plan(
                        self.key, self._build, self._fp, source)
        return self.fn


class _Shared:
    """A session object (the CSR, the ELL tiles) built once process-wide
    for a graph's content and device, through the registry."""

    __slots__ = ("key", "lock", "value")

    def __init__(self, key):
        self.key = key
        self.lock = make_lock("shared")
        self.value = None


class PrewarmProgress:
    """Observable progress of one session's background pre-warm pass."""

    def __init__(self):
        self.total = 0              # matching plan records found
        self.loaded = 0             # rebuilt into the pool
        self.failed = 0             # corrupt/unloadable (evicted by cache)
        self.skipped = 0            # beyond RuntimeConfig.prewarm_limit
        self.seconds = 0.0
        self.error: Optional[str] = None   # pass died: repr of the exception
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the pass finishes; True when it did."""
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def as_dict(self) -> dict:
        return dict(total=self.total, loaded=self.loaded, failed=self.failed,
                    skipped=self.skipped, seconds=self.seconds,
                    done=self.done, error=self.error)


class GraphSession:
    """Owns one graph's device tensors, ELL tiles and plans.

    `group` is the `torch.distributed` group of partitioned queries (None:
    the default group, if one is initialized); `default_strategy` and
    `default_hub_edge_fraction` are their partitioning defaults. `runtime`
    is a session-private `RuntimeConfig` (None: the process config);
    `prewarm` overrides its `prewarm`.
    """

    def __init__(self, graph: Graph, device=None, *, group=None,
                 default_strategy: str = "specialized",
                 default_hub_edge_fraction: float = 0.5,
                 runtime: Optional[RuntimeConfig] = None,
                 prewarm: Optional[bool] = None):
        if default_strategy not in PT.STRATEGIES:
            raise ValueError(f"unknown strategy {default_strategy!r}; "
                             f"want one of {PT.STRATEGIES}")
        self.graph = graph
        self.device = resolve_device(device)
        self.default_strategy = default_strategy
        self.default_hub_edge_fraction = default_hub_edge_fraction
        self._group = group
        self.runtime = runtime if runtime is not None else get_runtime_config()
        _ensure_sanitizer(self.runtime)  # REPRO_SANITIZE instruments these
        self._lock = make_rlock("session")
        self._stats_lock = make_lock("session.stats")
        self._device_graph: Optional[DeviceGraph] = None
        self._partitions: dict = {}
        self._objects: dict[Any, Any] = {}
        self._executables: dict[Any, Callable] = {}
        self._published: list = []       # (registry key, _Plan) it made
        self._warmed: set = set()
        self._kernels_built = False
        self._builds: dict = {}          # kind (key[0]) -> builds
        self._plan_builds: dict = {}     # plan key -> query-path builds
        self._load_counts: dict = {}     # plan key -> pre-warm rebuilds
        self._shared_counts: dict = {}   # plan key -> registry reuses
        self._plan_sources: dict = {}    # plan key -> built|prewarmed|shared
        self._kernel_build_s = 0.0
        # seconds this session spent hashing the graph, uploading its CSR
        # and building its tiles (0.0 for what it took from another)
        self._seconds = dict(fingerprint_s=0.0, csr_s=0.0, tiles_s=0.0)
        self._graph_fp: Optional[str] = None
        self._contract_checked: set = set()  # plan keys the gate passed
        self._graph_shape = None         # GraphShape, made at the first gate
        self._artifacts = artifact_cache_for(self.runtime)
        self._pool_cv = make_condition(make_lock("session.pool"),
                                       "session.pool")
        self._pool: dict = {}            # plan key -> pre-warmed step
        self._pending: set = set()       # plan keys the pass still builds
        self._scanning = False           # the pass has not listed them yet
        self.prewarm_progress: Optional[PrewarmProgress] = None
        self._prewarm_thread: Optional[threading.Thread] = None
        self._prewarm_stop = threading.Event()
        _ensure_faults(self.runtime)     # REPRO_FAULTS chaos schedule, if any
        do_prewarm = self.runtime.prewarm if prewarm is None else prewarm
        if do_prewarm and self._artifacts is not None:
            self._start_prewarm()

    def device_graph(self) -> DeviceGraph:
        """CSR tensors on the session's device (built once; with plan
        sharing on, once for every session of this graph on this device,
        so a shared plan's steps and this session's init read one CSR)."""
        dg = self._device_graph
        if dg is None:
            if self.runtime.share_plans:
                dg = self._shared(("csr",), self._upload_graph)
            with self._lock:
                if self._device_graph is None:
                    self._device_graph = (dg if dg is not None
                                          else self._upload_graph())
                dg = self._device_graph
        return dg

    def _upload_graph(self) -> DeviceGraph:
        t0 = time.perf_counter()
        dg = DeviceGraph.from_graph(self.graph, self.device)
        self._add_seconds("csr_s", t0)
        return dg

    def ell_tiles(self, *, base: int = ELL.DEFAULT_BASE,
                  growth: int = ELL.DEFAULT_GROWTH):
        """Degree-bucketed ELL tiles on the session's device (built once
        per (base, growth); with plan sharing on, once for every session
        of this graph on this device, like the plans that use them)."""
        def build():
            t0 = time.perf_counter()
            tiles = ELL.build_graph_ell(self.graph, device=self.device,
                                        base=base, growth=growth)
            self._add_seconds("tiles_s", t0)
            return tiles
        return self.cached(("ell", base, growth), build, share=True)

    def _add_seconds(self, what: str, t0: float) -> None:
        with self._stats_lock:
            self._seconds[what] += time.perf_counter() - t0

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
        """Make the CUDA kernels ready once, before the first query on a
        GPU: built, or loaded from the session's artifact cache."""
        if self.device.type != "cuda" or self._kernels_built:
            return
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all(cache=self._artifacts,   # takes the build's lock
                         device=self.device)
        with self._stats_lock:
            self._kernel_build_s += time.perf_counter() - t0
        # repro-ok: LS001 an idempotent flag: a racing caller only calls the build (under its own lock) again
        self._kernels_built = True

    def cached(self, key, build: Callable[[], Any], *,
               share: bool = False) -> Any:
        """Build `key`'s object once (step functions, tiles, backends).
        With `share` (and `RuntimeConfig.share_plans`) once process-wide
        for this graph's content and device, through the registry: another
        session's build is reused and counts on that session. A build
        passes the `compile` fault site first; one that raises is not
        cached."""
        got = self._objects.get(key)
        if got is not None:
            return got
        if share and self.runtime.share_plans:
            got = self._shared(key, lambda: self._build_object(key, build))
            with self._lock:
                return self._objects.setdefault(key, got)
        with self._lock:
            got = self._objects.get(key)
            if got is None:
                got = self._objects[key] = self._build_object(key, build)
        return got

    def _shared(self, key, build: Callable[[], Any]) -> Any:
        """`build()`'s value, made once process-wide for this graph's
        content and device through the registry (the first session to ask
        builds it, and counts it)."""
        handle = self._registered(key, lambda: _Shared(key))
        with handle.lock:
            if handle.value is None:
                handle.value = build()
        return handle.value

    def _build_object(self, key, build: Callable[[], Any]) -> Any:
        with trace.span("session.build", kind=key[0]):
            fault_point("compile", key=key)
            got = build()
        with self._stats_lock:
            self._builds[key[0]] = self._builds.get(key[0], 0) + 1
        return got

    def warm(self, key, run: Callable[[], Any]) -> None:
        """Run `run()` (a warm-up search) once per `key`, under the
        `engine.warm` span. Only a run that returns is recorded: one that
        raises is tried again next time."""
        if key in self._warmed:
            return
        with self._lock:
            if key not in self._warmed:
                with trace.span("engine.warm", kind=key[0]):
                    run()
                self._warmed.add(key)

    # --------------------------------------------------------- fingerprint --

    @property
    def graph_fingerprint(self) -> str:
        """Content hash of this session's CSR (memoized; identity of every
        shared or recorded plan)."""
        if self._graph_fp is None:
            with self._lock:
                if self._graph_fp is None:
                    t0 = time.perf_counter()
                    self._graph_fp = graph_fingerprint(self.graph)
                    self._add_seconds("fingerprint_s", t0)
        return self._graph_fp

    def _plan_fp(self, key) -> Optional[str]:
        if self._artifacts is None:
            return None
        return plan_fingerprint(self.graph_fingerprint, key,
                                environment_fingerprint(self.device))

    # --------------------------------------------------------------- plans --

    def plan_build(self, key) -> Callable[[], Callable]:
        """The build of plan `key`, what a query or pre-warm runs: for
        ("cohort", cfg, use_kernels, bucket, variant), the cohort step
        over this session's CSR and (with the kernels) its ELL tiles,
        kernels made ready first. A pure function of the key: the
        formulation is the key's, whatever the runtime config says."""
        if not (isinstance(key, tuple) and len(key) == 5
                and key[0] == "cohort"):
            raise KeyError(f"no plan build for key {key!r}")
        _kind, cfg, use_kernels, _bucket, variant = key
        cfg = dataclasses.replace(cfg, backend_kernels=bool(use_kernels))

        def build():
            ell = None
            if use_kernels:
                self.ensure_kernels()
                ell = self.ell_tiles()
            return B.make_batch_step(self.device_graph(), cfg, variant, ell)
        return build

    def executable(self, key, build: Callable[[], Callable]) -> Callable:
        """Plan `key`'s step function: from the pre-warm pool, else the
        registry (`share_plans`), else `build()` on the query path (once
        process-wide), whose record is then written to the cache. A new
        key passes the kernel-contract gate (`_contract_gate`) first."""
        fn = self._executables.get(key)
        if fn is not None:
            return fn
        self._contract_gate(key)
        fn = self._take_pooled(key)
        if fn is None:
            fn = self._plan_handle(key, build).resolve()
        with self._lock:
            return self._executables.setdefault(key, fn)

    def _contract_gate(self, key) -> None:
        """Static kernel-contract check of a plan before anything of it is
        taken or built (the pool, the registry, a build): once per key.

        Applies to the tiles formulation only: a cohort plan
        ("cohort", cfg, use_kernels, bucket, variant) whose `use_kernels`
        is set, and the partitioned search's ("sharded", hcfg, n_parts,
        strategy, hub), which `Engine` gates before it builds that search.
        Runs `repro_torch.analysis.kernel_contracts.contract_report` on
        this graph's shape (memoized) under the session runtime's
        `smem_budget_bytes`. An infeasible plan warns once
        (`KernelContractWarning`); under `strict_contracts` it raises
        `KernelBudgetError` and is not marked checked, so a retry refuses
        again. The contract model's own errors propagate.
        """
        if key in self._contract_checked or not isinstance(key, tuple):
            return
        if key[:1] == ("cohort",) and not key[2]:
            return                      # the gather formulation: no kernel
        if key[:1] not in (("cohort",), ("sharded",)):
            return
        from repro_torch.analysis.kernel_contracts import (GraphShape,
                                                           contract_report)
        from repro_torch.kernels.contracts import (KernelBudgetError,
                                                   KernelContractWarning)
        with self._lock:
            if key in self._contract_checked:
                return
            if self._graph_shape is None:
                self._graph_shape = GraphShape.from_graph(self.graph)
            report = contract_report(
                key, self._graph_shape,
                budget_bytes=self.runtime.smem_budget_bytes)
            if report.feasible:
                self._contract_checked.add(key)
                return
            first = report.errors[0]
            msg = (f"plan {key!r} fails its kernel contract: "
                   f"{report.summary()}; first error: [{first.kernel}] "
                   f"{first.rule} {first.message}")
            if self.runtime.strict_contracts:
                # NOT marked checked: a strict retry must refuse again.
                raise KernelBudgetError(msg)
            self._contract_checked.add(key)
        warnings.warn(msg, KernelContractWarning, stacklevel=3)

    def _registered(self, key, make: Callable[[], Any]) -> Any:
        """The registry's entry for `key` under this graph's content and
        device, else `make()`'s, published by this session (first writer
        wins)."""
        rkey = (self.graph_fingerprint, str(self.device), key)
        got = registry_get(rkey)
        if got is None:
            mine = make()
            got = registry_put(rkey, mine)
            if got is mine:
                with self._stats_lock:
                    self._published.append((rkey, got))
        return got

    def _plan_handle(self, key, build) -> _Plan:
        """The registry's plan for `key` (a share), else a new one that
        this session publishes."""
        fp = self._plan_fp(key)
        if not self.runtime.share_plans:
            return _Plan(key, build, self, fp)
        plan = self._registered(key, lambda: _Plan(key, build, self, fp))
        if plan._session is not self:
            with self._stats_lock:
                self._shared_counts[key] = self._shared_counts.get(key, 0) + 1
                self._plan_sources[key] = "shared"
        return plan

    def _build_plan(self, key, build, fp, source: str) -> Callable:
        """Build plan `key` (under its `_Plan`'s lock); count it, and write
        its record after a query-path build."""
        with trace.span("session.build", kind=key[0]):
            fault_point("compile", key=key)
            fn = build()
        with self._stats_lock:
            self._plan_sources[key] = source
            if source == "prewarmed":
                self._load_counts[key] = self._load_counts.get(key, 0) + 1
            else:
                self._plan_builds[key] = self._plan_builds.get(key, 0) + 1
                self._builds[key[0]] = self._builds.get(key[0], 0) + 1
        if fp is not None and source == "built":
            self._artifacts.store(fp, key, dict(
                graph_hash=self.graph_fingerprint,
                key=canonical_plan_key(key),
                **environment_fingerprint(self.device)))
        return fn

    # ------------------------------------------------------------- prewarm --

    def _start_prewarm(self) -> None:
        # repro-ok: LS001 called only from __init__, before the session is shared with any other thread
        self.prewarm_progress = PrewarmProgress()
        # repro-ok: LS001 attach-time init; the session object publishes it
        self._scanning = True            # queries wait for the scan
        # Non-daemon: a thread killed inside a CUDA call at interpreter
        # exit can abort the process. The pass is bounded (prewarm_limit
        # plans) and checks a stop flag, so joining at exit is cheap.
        # repro-ok: LS001 attach-time init; Thread.start() below is the publication barrier
        self._prewarm_thread = threading.Thread(
            target=self._prewarm_pass, name="bfs-session-prewarm",
            daemon=False)
        self._prewarm_thread.start()

    def _prewarm_pass(self) -> None:
        """Rebuild this graph's recorded plans into the pool.

        Runs on a background thread started at attach. It first loads
        every record whose graph hash and environment match, up to
        `prewarm_limit` (a corrupt one is evicted and counted `failed`),
        and marks their keys pending; then builds each plan: the kernel
        libraries, the tiles, the hub split, the step. A query that needs
        a pending plan (or comes during the scan) waits for it; once the
        pass ends (done, stopped or dead) a query builds on its own path.
        Every step is observable on `prewarm_progress`.
        """
        progress = self.prewarm_progress
        t0 = time.perf_counter()
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            gh = self.graph_fingerprint
            env = environment_fingerprint(self.device)
            matches = [
                fp for fp, meta in self._artifacts.scan()
                if meta.get("graph_hash") == gh
                and all(meta.get(k) == v for k, v in env.items())]
            progress.total = len(matches)
            limit = self.runtime.prewarm_limit
            progress.skipped = max(len(matches) - limit, 0)
            keys = []
            for fp in matches[:limit]:
                key = self._artifacts.load(fp)
                if key is None:
                    progress.failed += 1
                else:
                    keys.append(key)
            with self._pool_cv:
                self._pending.update(keys)
                self._scanning = False
                self._pool_cv.notify_all()
            for i, key in enumerate(keys):
                if self._prewarm_stop.is_set():
                    progress.skipped += len(keys) - i
                    break
                fn = self._plan_handle(key, self.plan_build(key)).resolve(
                    "prewarmed")
                if self.device.type == "cuda":
                    # repro-ok: TH001 pre-warm thread, off the query path: its plan's first work is done before the pool serves it
                    torch.cuda.synchronize(self.device)
                with self._pool_cv:
                    self._pool[key] = fn
                    self._pending.discard(key)
                    self._pool_cv.notify_all()
                progress.loaded += 1
        except Exception as e:  # noqa: BLE001 — a dead pre-warm thread must
            # be visible, not silent: the error lands on the progress object
            # and in runtime_stats(); queries still work (they build on
            # their own path, with the same kernels).
            progress.error = repr(e)
        finally:
            with self._pool_cv:
                self._pending.clear()
                self._scanning = False
                self._pool_cv.notify_all()
            progress.seconds = time.perf_counter() - t0
            progress._done.set()

    def _take_pooled(self, key) -> Optional[Callable]:
        """The pool's step for `key`, waiting while pre-warm scans or has
        it pending; None when the pass does not (or no longer) build it."""
        with self._pool_cv:
            while self._scanning or key in self._pending:
                self._pool_cv.wait()
            return self._pool.pop(key, None)

    def prewarm_wait(self, timeout: Optional[float] = None) -> dict:
        """Block until the attach-time pre-warm finishes; its report."""
        if self.prewarm_progress is None:
            return dict(total=0, loaded=0, failed=0, skipped=0, seconds=0.0,
                        done=True, error=None)
        self.prewarm_progress.wait(timeout)
        return self.prewarm_progress.as_dict()

    # ---------------------------------------------------------- inspection --

    def load_count(self, key) -> int:
        """Times this session's pre-warm rebuilt `key` from its record."""
        with self._stats_lock:
            return self._load_counts.get(key, 0)

    def materialize_count(self, key) -> int:
        """build_count + load_count: first-time work this session did for
        `key` (0 = it reused a plan another session made)."""
        with self._stats_lock:
            return (self._plan_builds.get(key, 0)
                    + self._load_counts.get(key, 0))

    @property
    def total_builds(self) -> int:
        with self._stats_lock:
            return sum(self._plan_builds.values())

    @property
    def total_loads(self) -> int:
        with self._stats_lock:
            return sum(self._load_counts.values())

    @property
    def total_materialized(self) -> int:
        with self._stats_lock:
            return (sum(self._plan_builds.values())
                    + sum(self._load_counts.values()))

    def cache_info(self) -> dict:
        """What the session holds: its plans and where each came from, and
        what it built by kind (no "ell" when its tiles, like its plans,
        are another session's)."""
        with self._lock, self._stats_lock:
            return {
                "graph": dict(V=self.graph.num_vertices,
                              E_undirected=self.graph.num_undirected_edges),
                "partitions": sorted(self._partitions),
                "executables": sorted(self._executables, key=repr),
                "builds": dict(self._builds),
                "build_counts": dict(self._plan_builds),
                "load_counts": dict(self._load_counts),
                "shared_counts": dict(self._shared_counts),
                "plan_sources": dict(self._plan_sources),
            }

    def runtime_stats(self) -> dict:
        """What this session built and where its plans came from: objects
        and query-path plan builds by kind (the key's first element:
        "ell", "cohort", "stepper_step", ...), the warm-up searches run,
        the seconds its call of the kernel build took (a wait for another
        session's build included; near 0 when the libraries were ready,
        0.0 on the CPU), the seconds it spent hashing the graph
        (`fingerprint_s`), uploading the CSR (`csr_s`) and building the
        tiles (`tiles_s`; 0.0 when another session built them), plan loads
        (pre-warm) and shares (registry),
        plan sources, the pre-warm's progress and, with a cache dir, the
        artifact cache's counters."""
        with self._lock, self._stats_lock:
            sources: dict = {}
            for src in self._plan_sources.values():
                sources[src] = sources.get(src, 0) + 1
            out = dict(builds=dict(self._builds),
                       warmups=len(self._warmed),
                       kernel_build_s=self._kernel_build_s,
                       **self._seconds,
                       cache_enabled=self._artifacts is not None,
                       loads=sum(self._load_counts.values()),
                       shared=sum(self._shared_counts.values()),
                       plan_sources=sources,
                       prewarm=(self.prewarm_progress.as_dict()
                                if self.prewarm_progress is not None
                                else None))
        if self._artifacts is not None:
            cache_stats = self._artifacts.stats()
            cache_stats.pop("per_entry", None)   # bulky; fetch via the cache
            out["artifact_cache"] = cache_stats
        return out

    # ------------------------------------------------------------ teardown --

    def signal_close(self) -> None:
        """Ask the pre-warm pass to stop WITHOUT waiting for it.

        `BFSServer.close()` calls this for every session up front, then
        joins everything on one shared deadline, so an early session's
        slow join cannot eat the budget while later sessions' passes keep
        running. Idempotent; `close()` still signals for standalone
        sessions.
        """
        self._prewarm_stop.set()

    def close(self, timeout: Optional[float] = None) -> bool:
        """Stop and join the pre-warm thread (it is non-daemon, so leaving
        it running blocks interpreter exit), then drop the session's
        references to its device tensors and plans and take back the
        registry entries it published (a later query builds them again).
        A shared CSR, tile set or plan lives as long as its last holder:
        another session that took one keeps it, and its tensors with it.
        True when the thread was joined. Call it once no query runs on
        the session (`BFSServer.close` joins its workers first)."""
        self._prewarm_stop.set()
        t = self._prewarm_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            if t.is_alive():
                return False
        # repro-ok: LS001 close() is single-caller teardown; the thread was joined above
        self._prewarm_thread = None
        with self._lock, self._stats_lock:
            published, self._published = self._published, []
            self._device_graph = None
            self._objects.clear()
            self._executables.clear()
            self._warmed.clear()
        with self._pool_cv:
            self._pool.clear()
        for rkey, plan in published:
            registry_drop(rkey, plan)
        return True

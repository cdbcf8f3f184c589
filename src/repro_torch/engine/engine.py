"""The traversal engine: the port's entry point for BFS queries.

    from repro_torch.engine import Engine
    engine = Engine(graph)                      # on the GPU; device="cpu" asks
    result = engine.bfs([r0, r1, ...])          # batch or single root
    result.validate(graph)

The port of the JAX package's `engine/engine.py`. Three backends; `auto`
picks `fused` for one partition and `sharded` for more:

* ``fused`` — a batch of B roots runs the batched cohort model
  (`repro_torch.core.bfs`) on the shared `LevelDriver`: per level the batch
  splits into a top-down cohort, a bottom-up cohort and the finished lanes,
  and each direction runs once over its masked cohort (per side under
  `BFSConfig.hub_split`). Batches pad to a power-of-two bucket (at least 8)
  with inactive lanes. Unbatched (Graph500) mode runs the same cohort step
  at bucket 1, one root at a time, timed per root.
* ``sharded`` — the paper's partitioned BSP search
  (`repro_torch.core.hybrid_bfs.make_hybrid_search`) on a
  `torch.distributed` group with one rank per partition
  (`GraphSession.group_for`). Every rank runs the same query and gets the
  same result. Roots run one after another (the reference pipelines their
  dispatch; here each level reads the host).
* ``stepper`` — one root at a time through the single-root level step, or
  with `n_parts > 1` through `BSPStepBackend` on the group, on the same
  driver, returning per-level direction/frontier/timing rows per root
  (`per_level_stats`, with the compute/exchange split on the partitioned
  path) and out-of-loop phase times (`timings`).

`n_parts=None` resolves to 1 unless a group with more than one rank exists
and the graph has at least `AUTO_SHARD_MIN_EDGES` directed edges; then to
the group's size.

Every path runs in the formulation `core.bfs.kernels_enabled` resolves from
the query's config: the ELL-tile kernels ("tiles") or the CSR gather steps
("gather", which builds no tiles). Fault sites (`runtime.faults`) sit
where the JAX package's do: `device` at query entry, `dispatch` per root
in Graph500 mode and on the sharded path, and through each backend's
`fault_ctx` (mode batch|scalar|stepper, kernels tiles|gather) the level
driver's `straggler` and `dispatch` before each level.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import bfs as B
from repro_torch.core.bfs import BFSConfig
from repro_torch.core.graph import Graph
from repro_torch.core.hybrid_bfs import (HybridConfig, finalize_hybrid,
                                         make_hybrid_search,
                                         make_hybrid_stepper)
from repro_torch.engine.level_loop import (BSPStepBackend,
                                           CohortBatchBackend, LevelDriver,
                                           QueryCancelled, QueryControl,
                                           QueryDeadlineExceeded,
                                           SingleStepBackend, check_point,
                                           fence)
from repro_torch.engine.result import (TraversalResult,
                                       edges_traversed_from_levels)
from repro_torch.engine.session import GraphSession
from repro_torch.runtime.faults import fault_point

BACKENDS = ("fused", "sharded", "stepper")

# Auto-selection: below this many directed edges one fused search beats
# the BSP machinery even when a group of ranks exists.
AUTO_SHARD_MIN_EDGES = 1 << 19

RootsLike = Union[int, np.integer, Sequence[int], np.ndarray]

# Batched queries pad to the next power of two, floored at this bucket, so
# ragged batch sizes share step functions (batch 1 stays 1: Graph500 mode).
MIN_BATCH_BUCKET = 8


def _bucket_batch(batch: int) -> int:
    """Batch bucket: 1, or the next power of two >= 8."""
    if batch <= 1:
        return 1
    return max(MIN_BATCH_BUCKET, 1 << (batch - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Fully resolved query parameters (hashable): queries with equal plans
    run the same cached step functions."""
    backend: str              # resolved: "fused" | "sharded" | "stepper"
    n_parts: int
    hcfg: HybridConfig
    strategy: str
    hub_edge_fraction: float


def _tree_depth(level: np.ndarray) -> np.ndarray:
    """Deepest discovered BFS level per root (0 when only the root)."""
    return np.where(level >= 0, level, 0).max(axis=1).astype(np.int32)


class Engine:
    """Facade over a `GraphSession`: build once, query many times.

    `session_kw` go to the `GraphSession` (`device`, `group`,
    `default_strategy`, `default_hub_edge_fraction`). `device` defaults to
    the GPU; without CUDA that raises, and a caller that wants the CPU (the
    tests) passes `device="cpu"`.
    """

    def __init__(self, graph_or_session: Union[Graph, GraphSession],
                 **session_kw):
        if isinstance(graph_or_session, GraphSession):
            if session_kw:
                raise ValueError("session keyword arguments only apply "
                                 "when passing a Graph")
            self.session = graph_or_session
        else:
            self.session = GraphSession(graph_or_session, **session_kw)

    @property
    def graph(self) -> Graph:
        return self.session.graph

    @property
    def device(self) -> torch.device:
        return self.session.device

    # ----------------------------------------------------------- selection --

    def _auto_parts(self) -> int:
        ranks = self.session.world_size()
        if ranks == 1 or self.graph.num_directed_edges < AUTO_SHARD_MIN_EDGES:
            return 1
        return ranks

    def _resolve(self, backend: str, n_parts: Optional[int]):
        if backend not in BACKENDS + ("auto",):
            raise ValueError(f"unknown backend {backend!r}; "
                             f"want one of {BACKENDS + ('auto',)}")
        if n_parts is None:
            n_parts = 1 if backend == "fused" else self._auto_parts()
        if backend == "auto":
            backend = "fused" if n_parts == 1 else "sharded"
        if backend == "fused" and n_parts != 1:
            raise ValueError("fused backend is single-partition; "
                             f"got n_parts={n_parts}")
        if backend == "sharded" and n_parts < 2:
            raise ValueError("sharded backend needs n_parts >= 2 "
                             "(use backend='fused' for one partition)")
        return backend, n_parts

    @staticmethod
    def _normalize_cfg(cfg) -> HybridConfig:
        if cfg is None:
            return HybridConfig()
        if isinstance(cfg, BFSConfig):
            return HybridConfig(bfs=cfg)
        if isinstance(cfg, HybridConfig):
            return cfg
        raise TypeError("cfg must be a BFSConfig or a HybridConfig, got "
                        f"{type(cfg)}")

    def _normalize_roots(self, roots: RootsLike) -> np.ndarray:
        arr = np.atleast_1d(np.asarray(roots, dtype=np.int64))
        if arr.ndim != 1:
            raise ValueError(f"roots must be a scalar or 1-D, got {arr.shape}")
        v = self.graph.num_vertices
        if arr.size:
            if v == 0:
                raise ValueError("cannot run BFS on an empty (0-vertex) graph")
            if arr.min() < 0 or arr.max() >= v:
                raise ValueError(f"roots out of range [0, {v})")
        return arr

    # --------------------------------------------------------------- query --

    def plan(self, cfg=None, *, backend: str = "auto",
             n_parts: Optional[int] = None, strategy: Optional[str] = None,
             hub_edge_fraction: Optional[float] = None) -> QueryPlan:
        """Resolve query knobs into a canonical, hashable `QueryPlan` (the
        session's partitioning defaults filled in)."""
        hcfg = self._normalize_cfg(cfg)
        backend, n_parts = self._resolve(backend, n_parts)
        strategy = strategy or self.session.default_strategy
        if hub_edge_fraction is None:
            hub_edge_fraction = self.session.default_hub_edge_fraction
        return QueryPlan(backend, n_parts, hcfg, strategy, hub_edge_fraction)

    def bfs(self, roots: RootsLike, cfg=None, *, backend: str = "auto",
            n_parts: Optional[int] = None, strategy: Optional[str] = None,
            hub_edge_fraction: Optional[float] = None, batched: bool = True,
            validate: bool = False, on_level: Optional[Callable] = None,
            control: Optional[QueryControl] = None) -> TraversalResult:
        """Run BFS from one root or a batch of roots.

        Args:
          roots: int or 1-D int array of vertex ids.
          cfg: `BFSConfig` (heuristic and tuning knobs) or a `HybridConfig`
            (adds the exchange and coordinator of the partitioned path).
          backend: "auto" | "fused" | "sharded" | "stepper".
          n_parts: partition count (None: auto, see the module docstring).
            More than one needs a group of exactly `n_parts` ranks, each
            calling `bfs` with the same arguments.
          strategy / hub_edge_fraction: partitioning knobs of the
            partitioned paths; the session's defaults otherwise.
          batched: True runs the batch as one cohort search (per-root
            seconds are an even split; on the sharded path the roots run
            one after another, timed together); False runs and times roots
            one at a time (the Graph500 measurement mode).
          validate: check every parent tree against the numpy oracle.
          on_level: streaming callback, `on_level(batch_index, row)` the
            moment each level's row lands on the host: one batch row per
            level with `batch_index == -1` on the batched fused path, one
            row per root per level (`batch_index` = root position) on the
            stepper.
          control: `QueryControl` checked before dispatch, between roots
            (but not on the batched sharded path) and once per level;
            aborts raise `QueryCancelled` / `QueryDeadlineExceeded`
            carrying the partial per-level stats. An `AgreedControl` makes
            each of these check points an agreement of the partitioned
            query's group (`engine.partition_front`).
        """
        qp = self.plan(cfg, backend=backend, n_parts=n_parts,
                       strategy=strategy,
                       hub_edge_fraction=hub_edge_fraction)
        return self.bfs_plan(roots, qp, batched=batched, validate=validate,
                             on_level=on_level, control=control)

    def bfs_plan(self, roots: RootsLike, plan: QueryPlan, *,
                 batched: bool = True, validate: bool = False,
                 on_level: Optional[Callable] = None,
                 control: Optional[QueryControl] = None) -> TraversalResult:
        """Run a query whose knobs were already resolved by `plan()`."""
        if on_level is not None and not (
                plan.backend == "stepper"
                or (plan.backend == "fused" and batched)):
            raise ValueError("on_level streaming needs backend='stepper' or "
                             "the batched fused path, got "
                             f"{plan.backend!r} (batched={batched})")
        # The control's entry check, then the chaos hook: simulated
        # device/memory pressure at query entry (non-transient
        # `DevicePressure`: the degradation chain, not the retry loop, is
        # the recovery path).
        check_point(control, ("device", dict(backend=plan.backend)))
        roots_arr = self._normalize_roots(roots)
        if roots_arr.size == 0:
            v = self.graph.num_vertices
            return TraversalResult(
                roots=roots_arr, parent=np.empty((0, v), np.int32),
                level=np.empty((0, v), np.int32),
                num_levels=np.empty((0,), np.int32), seconds=0.0,
                per_root_seconds=np.empty((0,)), backend=plan.backend,
                n_parts=plan.n_parts,
                edges_undirected=self.graph.num_undirected_edges,
                edges_traversed=np.empty((0,), np.int64))
        pkey = (plan.n_parts, plan.strategy, plan.hub_edge_fraction)
        if plan.backend == "stepper":
            res = self._bfs_stepper(roots_arr, plan.hcfg, pkey, on_level,
                                    control)
        elif plan.backend == "sharded":
            res = self._bfs_sharded(roots_arr, plan.hcfg, pkey, batched,
                                    control)
        else:
            res = self._bfs_fused(roots_arr, plan.hcfg.bfs, batched, control,
                                  on_level)
        res.edges_traversed = edges_traversed_from_levels(self.graph.degrees,
                                                          res.level)
        if validate:
            res.validate(self.graph)
        return res

    # --------------------------------------------------------- fused path --

    def _cohort_backend(self, cfg: BFSConfig, bucket: int,
                        use_kernels: bool) -> CohortBatchBackend:
        """Cohort driver backend for a batch bucket. Its plans are the step
        variants, keyed ("cohort", cfg, use_kernels, bucket, variant) and
        resolved through `session.executable` (pre-warm pool, registry,
        build), as the reference's `_cohort_backend` resolves its five
        executables; a forced single-direction heuristic has only its one
        reachable variant. The init and the sync payload are plain
        functions over the session's CSR (`B.init_batch`,
        `B.batch_scalars`), not plans: there is nothing to build."""
        sess = self.session
        steps = {}
        for var in B.reachable_variants(cfg):
            key = ("cohort", cfg, use_kernels, bucket, var)
            steps[var] = sess.executable(key, sess.plan_build(key))
        dg = sess.device_graph()
        return CohortBatchBackend(
            lambda roots, active: B.init_batch(dg, cfg, roots, active),
            steps, dg.num_vertices, bucket, sess.device)

    def _lanes(self, roots: np.ndarray, bucket: int):
        """Roots padded to `bucket` (pad lanes repeat roots[0] and start
        inactive) as device tensors."""
        padded = np.full(bucket, roots[0], dtype=np.int32)
        padded[:len(roots)] = roots
        active = np.arange(bucket) < len(roots)
        return (torch.from_numpy(padded).to(self.device),
                torch.from_numpy(active).to(self.device))

    def _bfs_fused(self, roots_arr, cfg, batched, control=None,
                   on_level=None) -> TraversalResult:
        e_und = self.graph.num_undirected_edges
        use = B.kernels_enabled(cfg)
        kernels = "tiles" if use else "gather"
        if batched:
            b = len(roots_arr)
            bucket = _bucket_batch(b)
            backend = self._cohort_backend(cfg, bucket, use)
            # How the driver's chaos hooks describe this dispatch: the
            # handle schedules like [kernels=tiles] or [mode=batch] use.
            backend.fault_ctx = dict(mode="batch", kernels=kernels)
            lanes = self._lanes(roots_arr, bucket)
            # Nothing a first run pays (library loads, first launches,
            # first allocations) lands inside the timed search.
            self.session.warm(("cohort_warm", cfg, use, bucket),
                              lambda: backend.warm(lanes))
            if control is not None:
                control.check()      # the warm-up may outlive a deadline
            cb = (lambda row: on_level(-1, row)) if on_level else None
            t0 = time.perf_counter()
            try:
                parent, level, rows, _timings = LevelDriver(backend).run(
                    lanes, cb, control)
            except (QueryCancelled, QueryDeadlineExceeded) as e:
                e.per_level_stats = [e.per_level_stats]
                raise
            dt = time.perf_counter() - t0
            parent, level = parent[:b], level[:b]
            return TraversalResult(roots_arr, parent, level,
                                   _tree_depth(level), dt, np.full(b, dt / b),
                                   "fused", 1, e_und,
                                   batch_level_stats=rows)
        # Graph500 mode: one root at a time through the B=1 cohort.
        backend = self._cohort_backend(cfg, 1, use)
        backend.fault_ctx = dict(mode="scalar", kernels=kernels)
        self.session.warm(("cohort_warm", cfg, use, 1),
                          lambda: backend.warm(self._lanes(roots_arr[:1], 1)))
        parents, levels, per_root = [], [], []
        for r in roots_arr:
            if control is not None:
                control.check()
            fault_point("dispatch", mode="scalar", kernels=kernels)
            lanes = self._lanes(np.asarray([r]), 1)
            t0 = time.perf_counter()
            parent, level, _rows, _timings = LevelDriver(backend).run(
                lanes, None, control)
            per_root.append(time.perf_counter() - t0)
            parents.append(parent[0])
            levels.append(level[0])
        per_root = np.asarray(per_root)
        level = np.stack(levels)
        return TraversalResult(roots_arr, np.stack(parents), level,
                               _tree_depth(level), float(per_root.sum()),
                               per_root, "fused", 1, e_und)

    # ------------------------------------------------------- stepper path --

    def _stepper_backend_single(self, cfg: BFSConfig,
                                use_kernels: bool) -> SingleStepBackend:
        """Single-root driver backend; its step is cached per (config,
        formulation)."""
        sess = self.session
        dg = sess.device_graph()
        ell = None
        if use_kernels:
            sess.ensure_kernels()
            ell = sess.ell_tiles()
        step = sess.cached(("stepper_step", cfg, use_kernels),
                           lambda: B.make_level_step(dg, cfg, ell))
        return SingleStepBackend(
            lambda root: B.init_state(dg, root), step,
            lambda st: B.state_scalars(dg, cfg, st), dg.num_vertices,
            sess.device)

    def _stepper_backend_sharded(self, hcfg: HybridConfig, pkey,
                                 use_kernels: bool) -> BSPStepBackend:
        """This rank's BSP driver backend over session-cached pieces."""
        sess = self.session
        group = sess.group_for(pkey[0])
        plan, pg = sess.partitioned(*pkey)
        ell = None
        if use_kernels:
            sess.ensure_kernels()
            ell = sess.hybrid_ell(*pkey)
        pieces = sess.cached(("hybrid_stepper", hcfg, use_kernels) + pkey,
                             lambda: make_hybrid_stepper(
                                 pg, hcfg, group, sess.device, ell))
        return BSPStepBackend(pieces, plan, sess.device)

    def _bfs_stepper(self, roots_arr, hcfg, pkey, on_level=None,
                     control=None) -> TraversalResult:
        n_parts = pkey[0]
        use = B.kernels_enabled(hcfg.bfs)
        backend = (self._stepper_backend_single(hcfg.bfs, use)
                   if n_parts == 1
                   else self._stepper_backend_sharded(hcfg, pkey, use))
        backend.fault_ctx = dict(mode="stepper",
                                 kernels="tiles" if use else "gather")
        driver = LevelDriver(backend)
        wkey = (("stepper_warm", hcfg.bfs, use) if n_parts == 1
                else ("stepper_warm", hcfg, use) + pkey)
        # The warm-up is a whole search too: it honours the control, and an
        # aborted one is not recorded, so the next query warms again.
        try:
            self.session.warm(wkey,
                              lambda: driver.run(int(roots_arr[0]), None,
                                                 control))
        except (QueryCancelled, QueryDeadlineExceeded) as e:
            e.per_level_stats = [e.per_level_stats]
            raise
        check_point(control)            # the warm-up may outlive a deadline
        parents, levels, stats_all, timings, per_root = [], [], [], [], []
        for i, r in enumerate(roots_arr):
            cb = (lambda row, _i=i: on_level(_i, row)) if on_level else None
            t0 = time.perf_counter()
            try:
                parent, level, stats, extra = driver.run(int(r), cb, control)
            except (QueryCancelled, QueryDeadlineExceeded) as e:
                # Per-root convention: completed roots + the aborted one.
                e.per_level_stats = stats_all + [e.per_level_stats]
                raise
            per_root.append(time.perf_counter() - t0)
            parents.append(parent)
            levels.append(level)
            stats_all.append(stats)
            timings.append(extra)
        per_root = np.asarray(per_root)
        level = np.stack(levels)
        return TraversalResult(roots_arr, np.stack(parents), level,
                               _tree_depth(level), float(per_root.sum()),
                               per_root, "stepper", n_parts,
                               self.graph.num_undirected_edges,
                               per_level_stats=stats_all, timings=timings)

    # ------------------------------------------------------- sharded path --

    def _bfs_sharded(self, roots_arr, hcfg, pkey, batched,
                     control=None) -> TraversalResult:
        """Every root through this rank's cached partitioned search, after
        one warm-up search per (config, partitioning)."""
        sess = self.session
        group = sess.group_for(pkey[0])
        plan, pg = sess.partitioned(*pkey)
        use = B.kernels_enabled(hcfg.bfs)
        kernels = "tiles" if use else "gather"
        ell = None
        if use:
            # the JAX package gates this plan in `session.executable`; the
            # port caches the search with `cached`, so it gates it here,
            # before the kernels, the tiles or the search are built
            sess._contract_gate(("sharded", hcfg) + pkey)
            sess.ensure_kernels()
            ell = sess.hybrid_ell(*pkey)
        search_fn, root_mapper = sess.cached(
            ("hybrid_search", hcfg, use) + pkey,
            lambda: make_hybrid_search(pg, hcfg, group, sess.device, ell))
        roots_new = [root_mapper(int(r)) for r in roots_arr]
        sess.warm(("sharded_warm", hcfg, use) + pkey,
                  lambda: search_fn(roots_new[0]))
        outs, per_root = [], []
        fctx = dict(mode="sharded", kernels=kernels)
        if batched:
            # One fault point for the whole batch and no control check past
            # the entry's, as the reference's one pipelined dispatch has.
            check_point(control, ("dispatch", fctx), check=False)
        t_all = time.perf_counter()
        for rn in roots_new:
            if not batched:
                check_point(control, ("dispatch", fctx))
            t0 = time.perf_counter()
            outs.append(search_fn(rn))
            fence(sess.device)
            per_root.append(time.perf_counter() - t0)
        dt = time.perf_counter() - t_all
        per_root = (np.full(len(roots_new), dt / len(roots_new)) if batched
                    else np.asarray(per_root))
        parents, levels = [], []
        for parent_new, level_new, _rounds in outs:
            parent, level = finalize_hybrid(plan, parent_new, level_new)
            parents.append(parent)
            levels.append(level)
        level = np.stack(levels)
        return TraversalResult(roots_arr, np.stack(parents), level,
                               _tree_depth(level), float(per_root.sum()),
                               per_root, "sharded", pkey[0],
                               self.graph.num_undirected_edges)

"""Direction-optimized BFS on PyTorch tensors: batched cohorts and one root.

The port of the JAX package's `core/bfs.py` in its kernel formulation.

* **Batched cohort path** (`init_batch` .. `batch_scalars`). A batch of B
  searches is a structure of arrays (`[B, V]` flags, parents and levels
  plus per-lane statistics). Each level partitions the batch into a
  top-down cohort, a bottom-up cohort and the finished lanes, and each
  direction runs once over its masked cohort through the kernels of
  `repro_torch.kernels.ops` over degree-bucketed ELL tiles
  (`repro_torch.core.ell`). A lane outside a cohort carries zero degrees
  and costs no traversal work. With `BFSConfig.hub_split` every level runs
  as two sides, the hub rows (degree above the snapped `hub_deg` floor) and
  the tail, each with its own direction per lane; the hub side pulls
  through the hub kernel. The host loop lives in
  `repro_torch.engine.level_loop.CohortBatchBackend`. The two kernel steps
  are named after their kernels (`_topdown_step_kernels_batch`,
  `_bottomup_step_kernels_batch`); their reference counterparts are the
  kernel steps at `repro/core/bfs.py:700-745`.
* **Single-root path** (`init_state` .. `bfs_instrumented`), through the
  single-lane kernels. The reference branches on the device with
  `lax.cond`; here the branch is taken on the host, from the one sync per
  level: its payload (`state_scalars`) carries the next step's direction,
  decided on the device by the same `_decide_direction` that sets the
  state's `bu_mode`, and the step takes it as an argument.

Steps are plain functions of tensors; a state is never updated in place, so
a state can be kept and compared after later steps ran.

Results equal the JAX package's bit for bit: integer state keeps its
dtypes (torch's integer sums widen to int64 and are cast back to int32),
and the direction tests compare in float32 on the device, as the reference
does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ell as ELL
from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K

INT_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class BFSConfig:
    """Tuning and heuristic knobs (defaults follow the paper / Beamer).

    Field names and defaults are the JAX package's. Its `backend_kernels`
    switch is gone: here the tensors' device decides between a kernel and
    its plain version (`kernels.ops`), so no config knob is needed.
    `td_chunk`/`bu_chunk` size the JAX package's XLA formulation, which is
    not ported yet, and `hub_slab` its XLA hub pull; they are kept so
    configs carry over unchanged.

    `hub_split` runs every cohort level as a hub side and a tail side, each
    with its own direction decision per lane (the pull-cost input `mu` is
    side-local). The paper heuristic's threshold is a fraction of all
    edges, so its sides always agree and the split equals the unsplit
    search bit for bit; beamer's hub side can flip bottom-up earlier. The
    single-root path ignores `hub_split`, as the reference's does.
    """
    heuristic: str = "paper"      # "paper" | "beamer" | "topdown" | "bottomup"
    alpha: float = 14.0           # beamer: switch down when mf > mu/alpha
    beta: float = 24.0            # beamer: switch up when nf < V/beta
    gamma: float = 0.06           # paper: switch down when mf > gamma * E
    fixed_bu_steps: int = 3       # paper: return to top-down after N BU rounds
    td_chunk: int = 4096          # edge slots per top-down chunk
    bu_chunk: int = 512           # rows per bottom-up chunk
    bu_slab: int = 32             # neighbour slots per bottom-up slab
    max_levels: int = 0           # 0 = num_vertices (safe upper bound)
    hub_split: bool = False       # hub/tail split per-level dispatch
    hub_deg: int = 256            # hub threshold (snapped to bucket ladder)
    hub_slab: int = 256           # neighbour slots per hub-side pull slab


@dataclasses.dataclass
class DeviceGraph:
    """CSR graph as device tensors (+ one degree slot for the fill id V).

    `memo` holds what is derived from the graph once and reused by every
    step: the hub masks and split tiles per `hub_deg`, and the ELL tiles a
    one-shot search builds.
    """
    indptr: torch.Tensor     # int32[V+1]
    indices: torch.Tensor    # int32[E]
    deg_ext: torch.Tensor    # int32[V+1]; deg_ext[V] == 0
    num_vertices: int
    num_directed_edges: int
    memo: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    @property
    def device(self) -> torch.device:
        return self.deg_ext.device

    @classmethod
    def from_graph(cls, g: Graph, device) -> "DeviceGraph":
        assert g.num_directed_edges < INT_MAX, "per-partition E must be < 2^31"
        deg_ext = np.zeros(g.num_vertices + 1, dtype=np.int32)
        deg_ext[:g.num_vertices] = g.degrees
        # Edgeless graphs keep one dummy slot so gathers stay well-formed.
        indices = g.indices if g.num_directed_edges else np.zeros(1, np.int32)
        return cls(
            indptr=torch.from_numpy(g.indptr.astype(np.int32)).to(device),
            indices=torch.from_numpy(indices.astype(np.int32)).to(device),
            deg_ext=torch.from_numpy(deg_ext).to(device),
            num_vertices=g.num_vertices,
            num_directed_edges=g.num_directed_edges,
        )


def _memo(dg: DeviceGraph, key, build):
    """`dg.memo[key]`, built on first use. Two threads racing on a missing
    key both build it; the builds are equal, so either result serves."""
    got = dg.memo.get(key)
    if got is None:
        got = dg.memo[key] = build()
    return got


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _f32(value: float, device) -> torch.Tensor:
    """A Python threshold as a float32 tensor on `device`.

    JAX rounds a Python scalar to float32 before comparing it with a
    float32 array; so does this. A device tensor also keeps torch from
    taking `x / scalar` as `x * (1 / scalar)`, which rounds differently.
    `torch.full` fills on the device: no host-to-device copy, no sync.
    """
    return torch.full((), value, dtype=torch.float32, device=device)


def _decide_direction_batch(dg: DeviceGraph, cfg: BFSConfig, bu_mode,
                            bu_steps, mu, nf, mf):
    """Per-lane next direction (True = bottom-up) + bottom-up counter.

    The comparisons are float32 on the device, as in the reference: above
    2^24 float32 rounds, and float64 or host comparisons would flip
    directions near the thresholds. Under `hub_split` this runs once per
    side, with that side's unvisited edge mass as `mu`. Works on 0-dim
    tensors too (the single-root `_decide_direction`).
    """
    v = dg.num_vertices
    e = dg.num_directed_edges
    dev = bu_mode.device
    if cfg.heuristic == "topdown":
        return torch.zeros_like(bu_mode), bu_steps
    if cfg.heuristic == "bottomup":
        return torch.ones_like(bu_mode), bu_steps
    zero = torch.zeros_like(bu_steps)
    if cfg.heuristic == "beamer":
        go_down = ~bu_mode & (mf.to(torch.float32)
                              > mu.to(torch.float32) / _f32(cfg.alpha, dev))
        go_up = bu_mode & (nf.to(torch.float32) < _f32(v / cfg.beta, dev))
        bu = (bu_mode | go_down) & ~go_up
        return bu, torch.where(bu, bu_steps + 1, zero)
    go_down = ~bu_mode & (mf.to(torch.float32) > _f32(cfg.gamma * e, dev))
    stay_down = bu_mode & (bu_steps < cfg.fixed_bu_steps)
    bu = go_down | stay_down
    return bu, torch.where(bu, bu_steps + 1, zero)


# ------------------------------------------------------------- single root --


# The 10 fields in the JAX package's `BFSState.tree_flatten` order.
BFS_STATE_FIELDS = ("visited", "frontier", "parent", "level", "cur_level",
                    "bu_mode", "bu_steps", "mu", "nf", "mf")


@dataclasses.dataclass
class BFSState:
    """One search's state. `bu_mode` is the direction of the step that
    produced it (the reference's meaning)."""
    visited: torch.Tensor    # uint8[V]
    frontier: torch.Tensor   # uint8[V]
    parent: torch.Tensor     # int32[V], INT_MAX = undiscovered
    level: torch.Tensor      # int32[V], INT_MAX = undiscovered
    cur_level: torch.Tensor  # int32 scalar
    bu_mode: torch.Tensor    # bool scalar
    bu_steps: torch.Tensor   # int32 scalar: bottom-up rounds taken
    mu: torch.Tensor         # int32 scalar: edge mass of unvisited vertices
    nf: torch.Tensor         # int32 scalar: frontier vertex count
    mf: torch.Tensor         # int32 scalar: frontier edge mass


def init_state(dg: DeviceGraph, root: int) -> BFSState:
    """The search from `root` (a host int) before its first level."""
    v = dg.num_vertices
    dev = dg.device
    root = int(root)
    visited = torch.zeros(v, dtype=torch.uint8, device=dev)
    visited[root] = 1
    parent = torch.full((v,), INT_MAX, dtype=torch.int32, device=dev)
    parent[root] = root
    level = torch.full((v,), INT_MAX, dtype=torch.int32, device=dev)
    level[root] = 0
    rdeg = dg.deg_ext[root].clone()
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return BFSState(visited, visited.clone(), parent, level, z,
                    torch.zeros((), dtype=torch.bool, device=dev), z,
                    _i32(dg.deg_ext.sum()) - rdeg,
                    torch.ones((), dtype=torch.int32, device=dev), rdeg)


def _decide_direction(dg: DeviceGraph, cfg: BFSConfig, st: BFSState):
    """Next-level direction (True = bottom-up) + updated bu_steps counter,
    from the statistics carried in `st`."""
    return _decide_direction_batch(dg, cfg, st.bu_mode, st.bu_steps, st.mu,
                                   st.nf, st.mf)


def _topdown_step_kernels(dg: DeviceGraph, cfg: BFSConfig, ell,
                          st: BFSState):
    """Push level through `kernels.ops.topdown_push`, one launch per ELL
    bucket into one `pcand`; the flags follow from it, as in
    `_topdown_step_kernels_batch`."""
    pcand = torch.full((dg.num_vertices,), INT_MAX, dtype=torch.int32,
                       device=st.frontier.device)
    for rows, deg, nbrs in ell:
        act_deg = torch.where(st.frontier[rows] != 0, deg, 0)
        K.topdown_push(act_deg, nbrs, rows, st.visited, pcand)
    next_flags = (pcand != INT_MAX).to(torch.uint8)
    return next_flags, torch.minimum(st.parent, pcand)


def _bottomup_step_kernels(dg: DeviceGraph, cfg: BFSConfig, ell,
                           st: BFSState):
    """Pull level through `kernels.ops.bottomup`, one launch per ELL bucket;
    visited rows carry degree 0 and cost no slabs."""
    next_flags = torch.zeros(dg.num_vertices, dtype=torch.uint8,
                             device=st.frontier.device)
    parent = st.parent.clone()
    for rows, deg, nbrs in ell:
        act_deg = torch.where(st.visited[rows] == 0, deg, 0)
        found, par = K.bottomup(act_deg, nbrs, st.frontier,
                                slab=min(cfg.bu_slab, nbrs.shape[1]))
        next_flags[rows] = torch.maximum(next_flags[rows], found)
        parent[rows] = torch.minimum(
            parent[rows], torch.where(found != 0, par, INT_MAX))
    return next_flags, parent


def _advance(dg: DeviceGraph, cfg: BFSConfig, ell, st: BFSState,
             bu: bool) -> BFSState:
    """One level. `bu` is the host's copy of this step's direction, which
    `state_scalars(dg, cfg, st)["bu_next"]` brought over in the level's
    sync; the state records the same decision, made here on the device."""
    bu_t, bu_steps = _decide_direction(dg, cfg, st)
    step = _bottomup_step_kernels if bu else _topdown_step_kernels
    next_flags, parent = step(dg, cfg, ell, st)
    _, nf, mf = K.frontier_fused(next_flags, dg.deg_ext[:-1], packed=False)
    cur = st.cur_level + 1
    return BFSState(torch.maximum(st.visited, next_flags), next_flags, parent,
                    torch.where(next_flags != 0, cur, st.level), cur,
                    bu_t, bu_steps, st.mu - mf, nf, mf)


def state_scalars(dg: DeviceGraph, cfg: BFSConfig, st: BFSState) -> dict:
    """Per-level host-sync payload of the single-root path, as device
    tensors: the loop condition, the direction of the step that produced
    `st` (`bu`, the stats row's) and of the next step (`bu_next`)."""
    return dict(nf=st.nf, mf=st.mf, cur=st.cur_level, bu=st.bu_mode,
                bu_next=_decide_direction(dg, cfg, st)[0])


def _resolve_ell(dg: DeviceGraph, ell):
    """`ell`, or the graph's own tiles built once and kept on `dg`."""
    if ell is not None:
        return ell
    return _memo(dg, ("ell",), lambda: ELL.build_device_graph_ell(dg))


def make_level_step(dg: DeviceGraph, cfg: BFSConfig, ell=None):
    """`(state, bu) -> state` advancing one level, `bu` the host bool
    `state_scalars(...)["bu_next"]` of the same state."""
    return functools.partial(_advance, dg, cfg, _resolve_ell(dg, ell))


def search_state(dg: DeviceGraph, root: int, cfg: BFSConfig,
                 ell=None) -> BFSState:
    """Whole search from one root: init, then levels while the frontier is
    non-empty and below `cfg.max_levels` (0 = V). One host sync per level
    (`engine.level_loop.host_sync` of `state_scalars`) reads the loop
    condition and the next direction together."""
    from repro_torch.engine.level_loop import host_sync
    ell = _resolve_ell(dg, ell)
    max_levels = cfg.max_levels or dg.num_vertices
    st = init_state(dg, root)
    while True:
        s = host_sync(state_scalars(dg, cfg, st))
        if not (s["nf"] > 0 and s["cur"] < max_levels):
            return st
        st = _advance(dg, cfg, ell, st, s["bu_next"])


def _device_graph(g, device) -> DeviceGraph:
    if isinstance(g, DeviceGraph):
        return g
    return DeviceGraph.from_graph(g, resolve_device(device))


def bfs(g: Graph | DeviceGraph, root: int, cfg: BFSConfig = BFSConfig(), *,
        device=None) -> tuple[np.ndarray, np.ndarray]:
    """Full direction-optimized search; returns (parent, level) on the host.

    One-shot convenience: a `DeviceGraph` keeps its ELL tiles between calls
    (use `repro_torch.engine` for repeated queries). A `Graph` goes to
    `device`, the GPU when None (`device="cpu"` asks for the CPU).
    """
    dg = _device_graph(g, device)
    return finalize(search_state(dg, root, cfg))


def bfs_instrumented(g: Graph | DeviceGraph, root: int,
                     cfg: BFSConfig = BFSConfig(), *, device=None):
    """Level-by-level search over the shared `LevelDriver`.

    Returns (parent, level, per_level_stats), rows in the driver's schema
    (level, direction, frontier_size, frontier_edges, seconds, compute_s,
    exchange_s).
    """
    from repro_torch.engine.level_loop import LevelDriver, SingleStepBackend
    dg = _device_graph(g, device)
    backend = SingleStepBackend(
        functools.partial(init_state, dg), make_level_step(dg, cfg),
        functools.partial(state_scalars, dg, cfg), dg.num_vertices, dg.device)
    parent, level, stats, _timings = LevelDriver(backend).run(int(root))
    return parent, level, stats


# ---------------------------------------------------------- batched cohort --

BATCH_VARIANTS = ("td", "bu", "mixed")

# The 20 fields in the JAX package's `BatchState.tree_flatten` order.
BATCH_STATE_FIELDS = (
    "visited", "frontier", "parent", "level", "cur_level", "active",
    "bu_mode", "bu_steps", "mu", "nf", "mf", "used_td", "used_bu",
    "bu_hub", "bu_steps_hub", "mu_hub", "nf_hub", "mf_hub",
    "used_td_hub", "used_bu_hub")


@dataclasses.dataclass
class BatchState:
    """SoA state for a batch of B concurrent single-partition searches.

    `bu_mode` holds each lane's direction for the NEXT step. `active` gates
    every cohort mask: a finished or pad lane is in no cohort. `used_td`/
    `used_bu` are the cohort sizes of the step that produced this state.
    Under `hub_split` the tail side's track is `bu_mode`/`bu_steps` and the
    hub side's `bu_hub`/`bu_steps_hub`/`mu_hub` (hub frontier statistics in
    `nf_hub`/`mf_hub`, hub cohort sizes in `used_*_hub`); with the split
    off the hub track mirrors the tail's and its side statistics stay zero.
    """
    visited: torch.Tensor       # uint8[B, V]
    frontier: torch.Tensor      # uint8[B, V]
    parent: torch.Tensor        # int32[B, V], INT_MAX = undiscovered
    level: torch.Tensor         # int32[B, V], INT_MAX = undiscovered
    cur_level: torch.Tensor     # int32 scalar
    active: torch.Tensor        # bool[B]
    bu_mode: torch.Tensor       # bool[B]
    bu_steps: torch.Tensor      # int32[B]
    mu: torch.Tensor            # int32[B]: unvisited edge mass per lane
    nf: torch.Tensor            # int32[B]: frontier vertex count per lane
    mf: torch.Tensor            # int32[B]: frontier edge mass per lane
    used_td: torch.Tensor       # int32 scalar
    used_bu: torch.Tensor       # int32 scalar
    bu_hub: torch.Tensor        # bool[B]
    bu_steps_hub: torch.Tensor  # int32[B]
    mu_hub: torch.Tensor        # int32[B]: unvisited hub edge mass
    nf_hub: torch.Tensor        # int32[B]
    mf_hub: torch.Tensor        # int32[B]
    used_td_hub: torch.Tensor   # int32 scalar
    used_bu_hub: torch.Tensor   # int32 scalar


def _hub_row_mask(dg: DeviceGraph, cfg: BFSConfig) -> torch.Tensor:
    """bool[V]: the row is on the hub side (degree above the snapped floor
    `ell.hub_degree_floor`, so exactly the rows of the hub ELL buckets).
    Built once per (graph, `hub_deg`)."""
    floor = ELL.hub_degree_floor(cfg.hub_deg)
    return _memo(dg, ("hub_v", floor), lambda: dg.deg_ext[:-1] > floor)


class HubSplit(NamedTuple):
    """One graph's ELL tiles split at one `hub_deg`, built once.

    `keep_tail`/`keep_hub` are `~hub_v` and `hub_v` as uint8[V]: the `keep`
    of a side's push in a mixed step, so that each side discovers only its
    own vertices. Built by `_hub_split`.
    """
    hub_v: torch.Tensor      # bool[V]
    ell_tail: tuple
    ell_hub: tuple
    keep_tail: torch.Tensor  # uint8[V]
    keep_hub: torch.Tensor   # uint8[V]


def _hub_split(dg: DeviceGraph, cfg: BFSConfig, ell) -> HubSplit:
    """The `HubSplit` of `ell` at `cfg.hub_deg`, memoized on `dg` (the entry
    keeps `ell` alive, so its id stays its own)."""
    def build():
        hub_v = _hub_row_mask(dg, cfg)
        ell_tail, ell_hub = ELL.split_tiles(ell, cfg.hub_deg)
        return ell, HubSplit(hub_v, ell_tail, ell_hub,
                             (~hub_v).to(torch.uint8), hub_v.to(torch.uint8))
    return _memo(dg, ("split", cfg.hub_deg, id(ell)), build)[1]


def init_batch(dg: DeviceGraph, cfg: BFSConfig, roots: torch.Tensor,
               active: torch.Tensor) -> BatchState:
    """Batched search start with an activity mask.

    `roots` is int32[B] (pad lanes may repeat any valid id); `active` is
    bool[B]. Inactive lanes get an empty frontier, nothing visited, and
    INT_MAX parent/level everywhere. The first step's per-lane direction is
    decided here, per side under `hub_split`.
    """
    v = dg.num_vertices
    dev = dg.device
    b = roots.shape[0]
    roots = roots.to(device=dev, dtype=torch.int64)
    active = active.to(device=dev, dtype=torch.bool)
    lanes = torch.arange(b, device=dev)
    visited = torch.zeros((b, v), dtype=torch.uint8, device=dev)
    visited[lanes, roots] = active.to(torch.uint8)
    parent = torch.full((b, v), INT_MAX, dtype=torch.int32, device=dev)
    parent[lanes, roots] = torch.where(active, _i32(roots), INT_MAX)
    level = torch.full((b, v), INT_MAX, dtype=torch.int32, device=dev)
    level[lanes, roots] = torch.where(active, 0, INT_MAX).to(torch.int32)
    total_e = _i32(dg.deg_ext.sum())
    rdeg = dg.deg_ext[roots]
    zi = torch.zeros(b, dtype=torch.int32, device=dev)
    mu = torch.where(active, total_e - rdeg, zi)
    nf = _i32(active)
    mf = torch.where(active, rdeg, zi)
    off = torch.zeros(b, dtype=torch.bool, device=dev)
    if cfg.hub_split:
        hub_v = _hub_row_mask(dg, cfg)
        e_hub = _i32(torch.where(hub_v, dg.deg_ext[:-1], 0).sum())
        root_hub = active & hub_v[roots]
        nf_hub = _i32(root_hub)
        mf_hub = torch.where(root_hub, rdeg, zi)
        mu_hub = torch.where(active, e_hub - mf_hub, zi)
        bu, bu_steps = _decide_direction_batch(dg, cfg, off, zi,
                                               mu - mu_hub, nf, mf)
        bu_h, steps_h = _decide_direction_batch(dg, cfg, off, zi,
                                                mu_hub, nf, mf)
    else:
        bu, bu_steps = _decide_direction_batch(dg, cfg, off, zi, mu, nf, mf)
        bu_h, steps_h = bu, bu_steps
        nf_hub = mf_hub = mu_hub = zi
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return BatchState(visited, visited.clone(), parent, level, z, active,
                      bu, bu_steps, mu, nf, mf, z, z,
                      bu_h, steps_h, mu_hub, nf_hub, mf_hub, z, z)


def _topdown_step_kernels_batch(dg: DeviceGraph, cfg: BFSConfig, ell,
                                 frontier, visited, parent, mask,
                                 keep=None):
    """Kernel push over the top-down cohort: one `topdown_push_batch`
    launch per ELL bucket serves every lane, all into one `pcand`; masked
    lanes carry zero degrees.

    The reference scatters `fresh` into the flags with a scatter-max and
    the sources into `pcand` with a scatter-min. Here the push does the
    scatter-min (an int32 atomicMin on the card, `scatter_reduce_("amin")`
    in its plain version), and the flags follow from it: a vertex got a
    fresh slot iff its `pcand` is below INT_MAX (sources are real ids). So
    no uint8 scatter-max is needed, and
    `where(flags, min(parent, pcand), parent)` is `min(parent, pcand)`.

    `keep` (uint8[V]: the split side's vertices, `HubSplit.keep_tail`/
    `keep_hub`) restricts which vertices this pass may discover, as the
    reference's `dst_mask` does; the push tests it before it writes
    `pcand`, so the flags derived from `pcand` stay exact.
    """
    b, v = frontier.shape
    pcand = torch.full((b, v), INT_MAX, dtype=torch.int32,
                       device=frontier.device)
    for rows, deg, nbrs in ell:
        act = mask[:, None] & (frontier[:, rows] != 0)
        act_deg = torch.where(act, deg[None, :], 0)
        K.topdown_push_batch(act_deg, nbrs, rows, visited, pcand, keep)
    next_flags = (pcand != INT_MAX).to(torch.uint8)
    return next_flags, torch.minimum(parent, pcand)


def _bottomup_step_kernels_batch(dg: DeviceGraph, cfg: BFSConfig, ell,
                                  frontier, visited, parent, mask,
                                  hub_kernel=False):
    """Kernel pull over the bottom-up cohort: one `bottomup_batch` launch
    per ELL bucket (`hub_bottomup_batch` with `hub_kernel`, the split's hub
    buckets); masked lanes and settled rows carry degree 0. A bucket's rows
    are distinct, so its max/min merges are gather, combine, write back."""
    b, v = frontier.shape
    next_flags = torch.zeros((b, v), dtype=torch.uint8, device=frontier.device)
    parent = parent.clone()
    for rows, deg, nbrs in ell:
        act = mask[:, None] & (visited[:, rows] == 0)
        act_deg = torch.where(act, deg[None, :], 0)
        if hub_kernel:
            found, par = K.hub_bottomup_batch(act_deg, nbrs, frontier)
        else:
            found, par = K.bottomup_batch(act_deg, nbrs, frontier,
                                          slab=min(cfg.bu_slab,
                                                   nbrs.shape[1]))
        next_flags[:, rows] = torch.maximum(next_flags[:, rows], found)
        parent[:, rows] = torch.minimum(
            parent[:, rows], torch.where(found != 0, par, INT_MAX))
    return next_flags, parent


def _advance_batch(dg: DeviceGraph, cfg: BFSConfig, ell, split, variant: str,
                   st: BatchState) -> BatchState:
    """One cohort level: at most one top-down plus one bottom-up pass, each
    over its masked cohort, never both per lane. `variant` ("td" | "bu" |
    "mixed") names the passes this step contains.

    Under `hub_split` (`split` is the graph's `HubSplit`), "td" stays one
    unmasked push (every side of every lane pushes); "bu" is a tail pull
    over the tail buckets plus a hub pull over the hub buckets, which
    together give the unsplit pull's flags and parents (a row's first hit
    does not depend on which pass scans it); "mixed" adds a push per side,
    each discovering only its side's vertices.
    """
    b, v = st.frontier.shape
    dev = st.frontier.device
    bu_t, bu_h = st.bu_mode, st.bu_hub
    td_t_mask = st.active & ~bu_t
    bu_t_mask = st.active & bu_t
    td_h_mask = st.active & ~bu_h
    bu_h_mask = st.active & bu_h
    pushes, pulls = [], []      # (lanes, keep) and (lanes, tiles, hub)
    if split is None:
        if variant in ("td", "mixed"):
            pushes.append((td_t_mask, None))
        if variant in ("bu", "mixed"):
            pulls.append((bu_t_mask, ell, False))
    elif variant == "td":
        pushes.append((td_t_mask, None))
    else:
        if variant == "mixed":
            pushes += [(td_t_mask, split.keep_tail),
                       (td_h_mask, split.keep_hub)]
        pulls += [(bu_t_mask, split.ell_tail, False),
                  (bu_h_mask, split.ell_hub, True)]
    next_flags = torch.zeros((b, v), dtype=torch.uint8, device=dev)
    parent = st.parent
    for lanes, keep in pushes:
        flags, parent = _topdown_step_kernels_batch(
            dg, cfg, ell, st.frontier, st.visited, parent, lanes, keep)
        next_flags = torch.maximum(next_flags, flags)
    for lanes, tiles, hub in pulls:
        flags, parent = _bottomup_step_kernels_batch(
            dg, cfg, tiles, st.frontier, st.visited, parent, lanes,
            hub_kernel=hub)
        next_flags = torch.maximum(next_flags, flags)
    _, nf, mf = K.frontier_fused_batch(next_flags, dg.deg_ext[:-1],
                                       packed=False)
    cur = st.cur_level + 1
    visited = torch.maximum(st.visited, next_flags)
    level = torch.where(next_flags != 0, cur, st.level)
    mu = st.mu - mf
    max_levels = cfg.max_levels or dg.num_vertices
    active = st.active & (nf > 0) & (cur < max_levels)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    if split is not None:
        on_hub = (next_flags != 0) & split.hub_v[None, :]
        nf_hub = _i32(on_hub.sum(dim=1))
        mf_hub = _i32(torch.where(on_hub, dg.deg_ext[:-1].to(torch.int64), 0)
                      .sum(dim=1))
        mu_hub = st.mu_hub - mf_hub
        bu2, steps2 = _decide_direction_batch(dg, cfg, bu_t, st.bu_steps,
                                              mu - mu_hub, nf, mf)
        bu_h2, steps_h2 = _decide_direction_batch(
            dg, cfg, bu_h, st.bu_steps_hub, mu_hub, nf, mf)
        used_hub = (_i32(td_h_mask.sum()), _i32(bu_h_mask.sum()))
    else:
        bu2, steps2 = _decide_direction_batch(dg, cfg, bu_t, st.bu_steps,
                                              mu, nf, mf)
        bu_h2, steps_h2 = bu2, steps2
        nf_hub = mf_hub = mu_hub = torch.zeros(b, dtype=torch.int32,
                                               device=dev)
        used_hub = (z, z)
    return BatchState(visited, next_flags, parent, level, cur, active,
                      bu2, steps2, mu, nf, mf,
                      _i32(td_t_mask.sum()), _i32(bu_t_mask.sum()),
                      bu_h2, steps_h2, mu_hub, nf_hub, mf_hub, *used_hub)


def reachable_variants(cfg: BFSConfig) -> tuple[str, ...]:
    """Step variants `_decide_direction_batch` can actually produce."""
    if cfg.heuristic == "topdown":
        return ("td",)
    if cfg.heuristic == "bottomup":
        return ("bu",)
    return BATCH_VARIANTS


def make_batch_step(dg: DeviceGraph, cfg: BFSConfig, variant: str, ell):
    """`BatchState -> BatchState` for one cohort step variant over `ell`
    (the graph's ELL tiles, `GraphSession.ell_tiles`)."""
    if variant not in BATCH_VARIANTS:
        raise ValueError(f"variant must be one of {BATCH_VARIANTS}, "
                         f"got {variant!r}")
    split = _hub_split(dg, cfg, ell) if cfg.hub_split else None
    return functools.partial(_advance_batch, dg, cfg, ell, split, variant)


def batch_scalars(st: BatchState) -> dict:
    """Per-level host-sync payload for the batched driver backend.

    Everything the host needs each level, as device tensors; `LevelDriver`
    stacks them into one tensor and copies it to the host once. `nf`/`mf`
    count ACTIVE lanes only, so the loop ends when every lane finished.
    `td_next`/`bu_next` count active lanes with ANY side in that direction.
    """
    act = st.active
    return dict(
        nf=_i32(torch.where(act, st.nf, 0).sum()),
        mf=_i32(torch.where(act, st.mf, 0).sum()),
        cur=st.cur_level,
        bu=torch.any(act & (st.bu_mode | st.bu_hub)),
        td_next=_i32((act & (~st.bu_mode | ~st.bu_hub)).sum()),
        bu_next=_i32((act & (st.bu_mode | st.bu_hub)).sum()),
        active_n=_i32(act.sum()),
        used_td=st.used_td,
        used_bu=st.used_bu,
        used_td_hub=st.used_td_hub,
        used_bu_hub=st.used_bu_hub,
        nf_hub=_i32(torch.where(act, st.nf_hub, 0).sum()),
        mf_hub=_i32(torch.where(act, st.mf_hub, 0).sum()),
        nf_lanes=st.nf,
        mf_lanes=st.mf,
        bu_lanes=st.bu_mode,
        hub_bu_lanes=st.bu_hub,
        nf_hub_lanes=st.nf_hub,
        active_lanes=act,
    )


def finalize(st) -> tuple[np.ndarray, np.ndarray]:
    """Sentinels -> Graph500 conventions (-1 for unreached), host numpy.
    Works on a `BFSState` ([V]) or a `BatchState` ([B, V])."""
    parent = st.parent.cpu().numpy()
    level = st.level.cpu().numpy()
    parent = np.where(parent == INT_MAX, -1, parent)
    level = np.where(level == INT_MAX, -1, level)
    return parent.astype(np.int32), level.astype(np.int32)

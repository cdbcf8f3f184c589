"""Batched cohort direction-optimized BFS on PyTorch tensors.

The port of the JAX package's batched cohort path (`core/bfs.py`,
`init_batch` .. `batch_scalars`) in its kernel formulation, unsplit. A
batch of B searches is a structure of arrays (`[B, V]` flags, parents and
levels plus per-lane statistics). Each level partitions the batch into a
top-down cohort, a bottom-up cohort and the finished lanes, and each
direction runs once over its masked cohort through the kernels of
`repro_torch.kernels.ops` over degree-bucketed ELL tiles
(`repro_torch.core.ell`). A lane outside a cohort carries zero degrees and
costs no traversal work. The host loop lives in
`repro_torch.engine.level_loop.CohortBatchBackend`. The two kernel steps
are named after their kernels (`_topdown_step_kernels_batch`,
`_bottomup_step_kernels_batch`); their reference counterparts are the
kernel steps at `repro/core/bfs.py:700-745`.

Steps are plain functions of tensors; a state is never updated in place, so
a `BatchState` can be kept and compared after later steps ran.

Results equal the JAX package's bit for bit: integer state keeps its
dtypes (torch's integer sums widen to int64 and are cast back to int32),
and the direction tests compare in float32 on the device, as the reference
does.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.kernels import ops as K

INT_MAX = int(np.iinfo(np.int32).max)

HUB_SPLIT_TODO = ("hub_split=True is not ported yet: ROADMAP.md queue 1 "
                  "item 5 (core/bfs.py, hub/tail split)")


@dataclasses.dataclass(frozen=True)
class BFSConfig:
    """Tuning and heuristic knobs (defaults follow the paper / Beamer).

    Field names and defaults are the JAX package's. Its `backend_kernels`
    switch is gone: here the tensors' device decides between a kernel and
    its plain version (`kernels.ops`), so no config knob is needed.
    `td_chunk`/`bu_chunk` size the JAX package's XLA formulation, which is
    not ported yet; they are kept so configs carry over unchanged.
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

    def __post_init__(self):
        if self.hub_split:
            raise NotImplementedError(HUB_SPLIT_TODO)


@dataclasses.dataclass
class DeviceGraph:
    """CSR graph as device tensors (+ one degree slot for the fill id V)."""
    indptr: torch.Tensor     # int32[V+1]
    indices: torch.Tensor    # int32[E]
    deg_ext: torch.Tensor    # int32[V+1]; deg_ext[V] == 0
    num_vertices: int
    num_directed_edges: int

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
    The hub track (`bu_hub` .. `used_bu_hub`) mirrors the tail track with
    the split off, as in the reference, and its side statistics stay zero.
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
    mu_hub: torch.Tensor        # int32[B]
    nf_hub: torch.Tensor        # int32[B]
    mf_hub: torch.Tensor        # int32[B]
    used_td_hub: torch.Tensor   # int32 scalar
    used_bu_hub: torch.Tensor   # int32 scalar


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
    directions near the thresholds.
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


def init_batch(dg: DeviceGraph, cfg: BFSConfig, roots: torch.Tensor,
               active: torch.Tensor) -> BatchState:
    """Batched search start with an activity mask.

    `roots` is int32[B] (pad lanes may repeat any valid id); `active` is
    bool[B]. Inactive lanes get an empty frontier, nothing visited, and
    INT_MAX parent/level everywhere. The first step's per-lane direction is
    decided here.
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
    bu, bu_steps = _decide_direction_batch(dg, cfg, off, zi, mu, nf, mf)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return BatchState(visited, visited.clone(), parent, level, z, active,
                      bu, bu_steps, mu, nf, mf, z, z,
                      bu, bu_steps, zi, zi, zi, z, z)


def _topdown_step_kernels_batch(dg: DeviceGraph, cfg: BFSConfig, ell,
                                 frontier, visited, parent, mask):
    """Kernel push over the top-down cohort: one `topdown_batch` launch per
    ELL bucket serves every lane; masked lanes carry zero degrees.

    The reference scatters `fresh` into the flags with a scatter-max and
    the sources into `pcand` with a scatter-min. Here the scatter-min is
    `scatter_reduce_("amin")` in int32, and the flags follow from it: a
    vertex got a fresh slot iff its `pcand` is below INT_MAX (sources are
    real ids). So no uint8 scatter-max is needed, and
    `where(flags, min(parent, pcand), parent)` is `min(parent, pcand)`.
    """
    b, v = frontier.shape
    pcand = torch.full((b, v), INT_MAX, dtype=torch.int32,
                       device=frontier.device)
    for rows, deg, nbrs in ell:
        act = mask[:, None] & (frontier[:, rows] != 0)
        act_deg = torch.where(act, deg[None, :], 0)
        fresh = K.topdown_batch(act_deg, nbrs, visited)       # uint8[B, R, W]
        dst = nbrs.clamp(0, v - 1).reshape(-1).to(torch.int64)  # lane-invariant
        src = torch.where(fresh != 0, rows[None, :, None], INT_MAX)
        pcand.scatter_reduce_(1, dst[None, :].expand(b, -1),
                              src.reshape(b, -1), "amin", include_self=True)
    next_flags = (pcand != INT_MAX).to(torch.uint8)
    return next_flags, torch.minimum(parent, pcand)


def _bottomup_step_kernels_batch(dg: DeviceGraph, cfg: BFSConfig, ell,
                                  frontier, visited, parent, mask):
    """Kernel pull over the bottom-up cohort: one `bottomup_batch` launch
    per ELL bucket; masked lanes and settled rows carry degree 0. A
    bucket's rows are distinct, so its max/min merges are gather, combine,
    write back."""
    b, v = frontier.shape
    next_flags = torch.zeros((b, v), dtype=torch.uint8, device=frontier.device)
    parent = parent.clone()
    for rows, deg, nbrs in ell:
        act = mask[:, None] & (visited[:, rows] == 0)
        act_deg = torch.where(act, deg[None, :], 0)
        found, par = K.bottomup_batch(act_deg, nbrs, frontier,
                                      slab=min(cfg.bu_slab, nbrs.shape[1]))
        next_flags[:, rows] = torch.maximum(next_flags[:, rows], found)
        parent[:, rows] = torch.minimum(
            parent[:, rows], torch.where(found != 0, par, INT_MAX))
    return next_flags, parent


def _advance_batch(dg: DeviceGraph, cfg: BFSConfig, ell, variant: str,
                   st: BatchState) -> BatchState:
    """One cohort level: at most one top-down plus one bottom-up pass, each
    over its masked cohort, never both per lane. `variant` ("td" | "bu" |
    "mixed") names the passes this step contains."""
    b, v = st.frontier.shape
    dev = st.frontier.device
    next_flags = torch.zeros((b, v), dtype=torch.uint8, device=dev)
    parent = st.parent
    bu_t = st.bu_mode
    td_t_mask = st.active & ~bu_t
    bu_t_mask = st.active & bu_t
    if variant in ("td", "mixed"):
        flags, parent = _topdown_step_kernels_batch(
            dg, cfg, ell, st.frontier, st.visited, parent, td_t_mask)
        next_flags = torch.maximum(next_flags, flags)
    if variant in ("bu", "mixed"):
        flags, parent = _bottomup_step_kernels_batch(
            dg, cfg, ell, st.frontier, st.visited, parent, bu_t_mask)
        next_flags = torch.maximum(next_flags, flags)
    _, nf, mf = K.frontier_fused_batch(next_flags, dg.deg_ext[:-1])
    cur = st.cur_level + 1
    visited = torch.maximum(st.visited, next_flags)
    level = torch.where(next_flags != 0, cur, st.level)
    mu = st.mu - mf
    max_levels = cfg.max_levels or dg.num_vertices
    active = st.active & (nf > 0) & (cur < max_levels)
    bu2, steps2 = _decide_direction_batch(dg, cfg, bu_t, st.bu_steps,
                                          mu, nf, mf)
    zi = torch.zeros(b, dtype=torch.int32, device=dev)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return BatchState(visited, next_flags, parent, level, cur, active,
                      bu2, steps2, mu, nf, mf,
                      _i32(td_t_mask.sum()), _i32(bu_t_mask.sum()),
                      bu2, steps2, zi, zi, zi, z, z)


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
    return functools.partial(_advance_batch, dg, cfg, ell, variant)


def batch_scalars(st: BatchState) -> dict:
    """Per-level host-sync payload for the batched driver backend.

    Everything the host needs each level, as device tensors; `LevelDriver`
    stacks them into one tensor and copies it to the host once. `nf`/`mf`
    count ACTIVE lanes only, so the loop ends when every lane finished.
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


def finalize(st: BatchState) -> tuple[np.ndarray, np.ndarray]:
    """Sentinels -> Graph500 conventions (-1 for unreached), host numpy."""
    parent = st.parent.cpu().numpy()
    level = st.level.cpu().numpy()
    parent = np.where(parent == INT_MAX, -1, parent)
    level = np.where(level == INT_MAX, -1, level)
    return parent.astype(np.int32), level.astype(np.int32)

"""Partitioned direction-optimized BFS on `torch.distributed` (paper Alg. 1-3).

The port of the JAX package's `core/hybrid_bfs.py` in its kernel
formulation. One process (rank) per partition runs the same query (SPMD),
the counterpart of the JAX package's `shard_map` over a mesh; the process
group takes the place of the mesh axis.

BSP structure (paper §3.1):

* Every rank owns a partition's rows (ELL tiles with *global* columns,
  `ell.build_hybrid_ell`) and keeps replicated `visited`/`frontier` flags
  over the padded global id space. The push (after top-down) and the pull
  (before bottom-up) of Algorithms 2/3 are one OR all-reduce of the next
  frontier's flags a round (`_or_exchange`): an int32 sum of the flags
  (`exchange="psum"`), or a bitwise OR of the packed words
  (`exchange="bitmap"`, the fused frontier kernel's bitmap).
* **Deferred parent aggregation** (§3.1): during traversal each rank only
  keeps parent candidates of its own rows; one min all-reduce after the
  last round assembles the tree (and the levels, replicated already).
* **Direction switching** (§3.3): every rank evaluates the switch statistic
  on replicated data, with no collective. Under `coordinator="hub"` it is
  the edge mass of the frontier's hub slice (new ids < hub_count); the
  bottom-up -> top-down return is a fixed step count. `_decide` treats
  every heuristic but "topdown" and "beamer" as "paper", as the reference
  does.

Per level a rank's step runs the kernels of `kernels.ops` over its tiles:
the pull `ops.bottomup`, the push `ops.topdown_push` (into a `pcand`
refilled with INT_MAX each level; the local next flags are
`pcand != INT_MAX`, which equals the reference's scatter-max of the fresh
flags), the statistics `ops.frontier_fused(packed=False)`, and with the
bitmap exchange the wire words `ops.frontier_fused(packed=True)`. Padding
rows carry id `v_pad`: their gathers read the extended arrays' sentinel
slot, and the pull's merges write into a `[v_pad + 1]` buffer whose last
slot is sliced off (the reference relies on `mode="drop"` scatters; a
clamp would write into vertex `v_pad - 1`).

The host branches on the direction: each level's one host read (`scalars`)
carries the replicated frontier count and the next direction, decided on
the device. The JAX package's XLA formulation is not ported, and
`BFSConfig.hub_split` is ignored here, as the reference's kernel path
ignores it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import ell as ELL
from repro_torch.core import frontier as fr
from repro_torch.core.bfs import INT_MAX, BFSConfig, _f32
from repro_torch.core.partition import (PartitionedGraph, PartitionPlan,
                                        unpermute, unpermute_ids)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as K
from repro_torch.parallel import collectives as C

# The 11 fields of the JAX package's stepper state dict, in its order.
HYBRID_STATE_FIELDS = ("visited", "frontier", "pcand", "lcand", "cur", "bu",
                       "bu_steps", "mu", "nf", "mf", "mf_dec")


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """The JAX package's `HybridConfig` without `axis_name`: the process
    group is an argument of the builders instead."""
    bfs: BFSConfig = BFSConfig()
    coordinator: str = "hub"      # "hub" (paper §3.3) | "global"
    exchange: str = "psum"        # "psum" (int32 flag sum) | "bitmap" (OR)


# ------------------------------------------------------------- collectives --

def _or_exchange(flags: torch.Tensor, hcfg: HybridConfig, group,
                 deg: torch.Tensor) -> torch.Tensor:
    """Merge the ranks' next-frontier flags: the push/pull of Algs. 2/3.

    `bitmap` sends the fused frontier kernel's packed words (V/8 bytes)."""
    if hcfg.exchange == "psum":
        return C.or_allreduce_flags(flags, group)
    packed, _, _ = K.frontier_fused(flags, deg, packed=True)
    return fr.unpack(C.or_allreduce_bitmap(packed, group), flags.shape[0])


# ---------------------------------------------------------------- per-level --

def _local_topdown_kernels(v_pad: int, ell, visited, frontier):
    """Push over this rank's tiles: (next_flags, parent candidates).

    Padding rows (id `v_pad`) read the sentinel slot of `frontier_ext` and
    push nothing.
    """
    frontier_ext = torch.cat([frontier, frontier.new_zeros(1)])
    pcand = torch.full((v_pad,), INT_MAX, dtype=torch.int32,
                       device=frontier.device)
    for rows, deg, nbrs in ell:
        act_deg = torch.where(frontier_ext[rows] != 0, deg, 0)
        K.topdown_push(act_deg, nbrs, rows, visited, pcand)
    return (pcand != INT_MAX).to(torch.uint8), pcand


def _local_bottomup_kernels(cfg: BFSConfig, v_pad: int, ell, visited,
                            frontier):
    """Pull over this rank's unvisited rows: (next_flags, parent candidates).

    Padding rows (id `v_pad`) count as visited through `visited_ext` and
    merge into the last slot of `[v_pad + 1]` buffers, which is dropped.
    """
    dev = frontier.device
    visited_ext = torch.cat([visited, visited.new_ones(1)])
    nxt = torch.zeros(v_pad + 1, dtype=torch.uint8, device=dev)
    pcand = torch.full((v_pad + 1,), INT_MAX, dtype=torch.int32, device=dev)
    for rows, deg, nbrs in ell:
        act_deg = torch.where(visited_ext[rows] == 0, deg, 0)
        found, par = K.bottomup(act_deg, nbrs, frontier,
                                slab=min(cfg.bu_slab, nbrs.shape[1]))
        nxt[rows] = torch.maximum(nxt[rows], found)
        pcand[rows] = torch.minimum(pcand[rows],
                                    torch.where(found != 0, par, INT_MAX))
    return nxt[:v_pad], pcand[:v_pad]


def _frontier_stats(flags, deg, dec_hub: int):
    """(nf, mf_full, mf_dec) of `flags`: one fused kernel pass, plus the
    hub prefix's edge mass under the hub coordinator (`dec_hub` > 0)."""
    _, nf, mf_full = K.frontier_fused(flags, deg, packed=False)
    if not dec_hub:
        return nf, mf_full, mf_full
    return nf, mf_full, fr.edge_count(flags[:dec_hub], deg[:dec_hub])


def _dec_hub(hcfg: HybridConfig, hub_count: int) -> int:
    """Hub-slice length for the decision statistic (0 = use full mass)."""
    return hub_count if hcfg.coordinator == "hub" else 0


def _init_mf_dec(root: int, deg, dec_hub: int):
    """Decision statistic of the initial {root} frontier."""
    if dec_hub and root >= dec_hub:
        return torch.zeros((), dtype=torch.int32, device=deg.device)
    return deg[root].clone()


def _decide(hcfg: HybridConfig, cfg: BFSConfig, v_pad: int, e_total: int,
            nf, mf, bu_mode, bu_steps, mu):
    """Direction decision; identical on every rank (no collective).

    float32 comparisons on the device against float32 thresholds, as the
    reference's."""
    dev = nf.device
    if cfg.heuristic == "topdown":
        return torch.zeros((), dtype=torch.bool, device=dev), bu_steps
    zero = torch.zeros_like(bu_steps)
    if cfg.heuristic == "beamer":
        go_down = ~bu_mode & (mf.to(torch.float32)
                              > mu.to(torch.float32) / _f32(cfg.alpha, dev))
        go_up = bu_mode & (nf.to(torch.float32)
                           < _f32(v_pad / cfg.beta, dev))
        bu = (bu_mode | go_down) & ~go_up
        return bu, torch.where(bu, bu_steps + 1, zero)
    go_down = ~bu_mode & (mf.to(torch.float32)
                          > _f32(cfg.gamma * e_total, dev))
    stay_down = bu_mode & (bu_steps < cfg.fixed_bu_steps)
    bu = go_down | stay_down
    return bu, torch.where(bu, bu_steps + 1, zero)


# ------------------------------------------------------------ the pieces --

def make_root_mapper(plan: PartitionPlan):
    """Returns orig-id -> new-id root translation for a partition plan."""
    inv = np.full(plan.v_orig, -1, dtype=np.int64)
    real = plan.perm_new_to_old >= 0
    inv[plan.perm_new_to_old[real]] = np.flatnonzero(real)

    def root_mapper(root_orig: int) -> int:
        root_new = int(inv[root_orig])
        assert root_new >= 0, f"root {root_orig} not in plan"
        return root_new

    return root_mapper


class HybridStepper(NamedTuple):
    """One rank's level-by-level pieces (`make_hybrid_stepper`).

    init(root_new) -> state; compute(state, bu) -> work (the local step, no
    communication; `bu` the host's copy of `scalars(state)["bu_next"]`);
    exchange(state, *work) -> state (the OR exchange and the state update);
    finalize(state) -> (parent_new, level_new) after the min all-reduce;
    root_mapper(orig id) -> new id; scalars(state) -> the one host read's
    payload (nf, mf, cur, bu, bu_next) as device tensors.
    """
    init: Callable
    compute: Callable
    exchange: Callable
    finalize: Callable
    root_mapper: Callable
    scalars: Callable


def make_hybrid_stepper(pg: PartitionedGraph,
                        hcfg: HybridConfig = HybridConfig(), group=None,
                        device=None, ell=None) -> HybridStepper:
    """This rank's level-by-level pieces over `group` (None: the default
    group), on `device` (None: the current CUDA device).

    `ell` is this rank's tiles (`GraphSession.hybrid_ell` caches them); when
    omitted they are built for `dist.get_rank(group)`, and the group must
    have one rank per partition. The state is a dict of tensors with the
    JAX package's stepper fields (`HYBRID_STATE_FIELDS`); its `pcand` is
    this rank's `[v_pad]`, row `rank` of the reference's `[n, v_pad]`, and
    `frontier_edges` in the rows is the full frontier edge mass `mf`.
    """
    plan = pg.plan
    device = resolve_device(device)
    if ell is None:
        if dist.get_world_size(group) != plan.n_parts:
            raise ValueError(f"the group has {dist.get_world_size(group)} "
                             f"ranks for {plan.n_parts} partitions")
        ell = ELL.build_hybrid_ell(pg, dist.get_rank(group), device=device)
    v_pad = plan.v_pad
    e_total = pg.total_directed_edges
    cfg = hcfg.bfs
    deg_ext = torch.from_numpy(pg.deg_ext).to(device)
    deg = deg_ext[:-1]
    total_deg = deg.sum().to(torch.int32)
    dec_hub = _dec_hub(hcfg, plan.hub_count)

    def decide(state):
        return _decide(hcfg, cfg, v_pad, e_total, state["nf"],
                       state["mf_dec"], state["bu"], state["bu_steps"],
                       state["mu"])

    def init_fn(root: int) -> dict:
        root = int(root)
        visited = torch.zeros(v_pad, dtype=torch.uint8, device=device)
        visited[root] = 1
        pcand = torch.full((v_pad,), INT_MAX, dtype=torch.int32,
                           device=device)
        pcand[root] = root
        lcand = torch.full((v_pad,), INT_MAX, dtype=torch.int32,
                           device=device)
        lcand[root] = 0
        z = torch.zeros((), dtype=torch.int32, device=device)
        return dict(visited=visited, frontier=visited.clone(), pcand=pcand,
                    lcand=lcand, cur=z, bu=torch.zeros((), dtype=torch.bool,
                                                       device=device),
                    bu_steps=z, mu=total_deg - deg_ext[root],
                    nf=torch.ones((), dtype=torch.int32, device=device),
                    mf=deg_ext[root].clone(),
                    mf_dec=_init_mf_dec(root, deg, dec_hub))

    def compute_fn(state: dict, bu: bool):
        bu_t, bu_steps = decide(state)
        if bu:
            nxt, pc = _local_bottomup_kernels(cfg, v_pad, ell,
                                              state["visited"],
                                              state["frontier"])
        else:
            nxt, pc = _local_topdown_kernels(v_pad, ell, state["visited"],
                                             state["frontier"])
        return nxt, pc, bu_t, bu_steps

    def exchange_fn(state: dict, nxt_local, pc_local, bu, bu_steps) -> dict:
        nxt = _or_exchange(nxt_local, hcfg, group, deg)
        newly = torch.where(state["visited"] != 0, 0, nxt).to(torch.uint8)
        fresh = newly != 0
        pcand = torch.where(fresh, torch.minimum(state["pcand"], pc_local),
                            state["pcand"])
        lcand = torch.where(fresh, torch.minimum(state["lcand"],
                                                 state["cur"] + 1),
                            state["lcand"])
        nf, mf_full, mf_dec = _frontier_stats(newly, deg, dec_hub)
        return dict(visited=torch.maximum(state["visited"], newly),
                    frontier=newly, pcand=pcand, lcand=lcand,
                    cur=state["cur"] + 1, bu=bu, bu_steps=bu_steps,
                    mu=state["mu"] - mf_full, nf=nf, mf=mf_full,
                    mf_dec=mf_dec)

    def finalize_fn(state: dict):
        # Deferred aggregation: one min all-reduce of parents and levels.
        both = C.min_allreduce(torch.stack([state["pcand"], state["lcand"]]),
                               group)
        return both[0], both[1]

    def scalars_fn(state: dict) -> dict:
        return dict(nf=state["nf"], mf=state["mf"], cur=state["cur"],
                    bu=state["bu"], bu_next=decide(state)[0])

    return HybridStepper(init_fn, compute_fn, exchange_fn, finalize_fn,
                         make_root_mapper(plan), scalars_fn)


def make_hybrid_search(pg: PartitionedGraph,
                       hcfg: HybridConfig = HybridConfig(), group=None,
                       device=None, ell=None):
    """This rank's whole-search callable: `(search_fn, root_mapper)`.

    `search_fn(root_new)` runs the level loop over the stepper's pieces,
    with one host read a level (the replicated frontier count, the level
    and the next direction), then the min all-reduce; it returns
    `(parent_new, level_new, levels)`, the first two tensors in the padded
    new-id space (`finalize_hybrid` maps them back), on every rank alike.
    Every rank of `group` calls it with the same root.
    """
    from repro_torch.engine.level_loop import host_sync

    pieces = make_hybrid_stepper(pg, hcfg, group, device, ell)
    v_pad = pg.plan.v_pad

    def search_fn(root_new: int):
        state = pieces.init(root_new)
        while True:
            sync = host_sync(pieces.scalars(state))
            if not (sync["nf"] > 0 and sync["cur"] < v_pad):
                break
            state = pieces.exchange(state, *pieces.compute(state,
                                                           sync["bu_next"]))
        parent_new, level_new = pieces.finalize(state)
        return parent_new, level_new, sync["cur"]

    return search_fn, pieces.root_mapper


def finalize_hybrid(plan: PartitionPlan, parent_new, level_new):
    """Padded new-id results (tensors or numpy) -> original ids, Graph500
    conventions (-1), host numpy."""
    parent_new, level_new = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                             else np.asarray(x)
                             for x in (parent_new, level_new))
    parent_new = np.where(parent_new == INT_MAX, -1, parent_new)
    level_new = np.where(level_new == INT_MAX, -1, level_new)
    parent = unpermute_ids(plan, parent_new)
    level = unpermute(plan, level_new.astype(np.int64)).astype(np.int32)
    return parent.astype(np.int32), level


def hybrid_bfs(pg: PartitionedGraph, root_orig: int,
               hcfg: HybridConfig = HybridConfig(), group=None,
               device=None):
    """The partitioned BFS on this rank of `group` (one rank per partition;
    every rank calls it with the same root); returns orig-id results
    `(parent, level, levels)`, equal on every rank. One-shot: it builds
    this rank's tiles (use `repro_torch.engine` for repeated queries)."""
    search_fn, root_mapper = make_hybrid_search(pg, hcfg, group, device)
    parent_new, level_new, levels = search_fn(root_mapper(int(root_orig)))
    parent, level = finalize_hybrid(pg.plan, parent_new, level_new)
    return parent, level, int(levels)


def hybrid_bfs_instrumented(pg: PartitionedGraph, root_orig: int,
                            hcfg: HybridConfig = HybridConfig(), group=None,
                            device=None):
    """Per-level BSP search over the shared `LevelDriver`: (parent, level,
    stats), rows in the driver's schema with the compute/exchange split."""
    from repro_torch.engine.level_loop import BSPStepBackend, LevelDriver

    device = resolve_device(device)
    backend = BSPStepBackend(make_hybrid_stepper(pg, hcfg, group, device),
                             pg.plan, device)
    parent, level, stats, _timings = LevelDriver(backend).run(int(root_orig))
    return parent, level, stats

"""The paper's workload driver: graph -> engine session -> BFS -> TEPS.

Graph500 methodology: search roots sampled from non-isolated vertices,
each searched and timed on its own, harmonic-mean TEPS (undirected edges /
time), every parent tree validated. All traversal goes through
`repro_torch.engine`.

    python -m repro_torch.launch.bfs_run --scale 14          # one GPU
    python -m repro_torch.launch.bfs_run --scale 10 --device cpu
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.bfs_run \\
        --scale 14 --nparts 4 --dist-backend gloo   # one rank a partition

Under `torchrun` every rank joins the group from the environment
(`env://`), runs the same query on `cuda:(LOCAL_RANK % device_count)`
(or the CPU with `--device cpu`), and only rank 0 prints. `--nparts` > 1
needs as many ranks. Ranks that share one GPU must use gloo: NCCL refuses
two ranks on one card.

`--cache-dir DIR` (or REPRO_CACHE_DIR) enables the persistent artifact
cache: the first run builds the kernel libraries and its plans and
records them; a later run of the same graph and config loads the
libraries and pre-warms the plans (the reported `warm` block shows plan
builds against loads and the `nvcc` runs of the process).
"""
from __future__ import annotations

import argparse
import os
import warnings

import numpy as np


def sample_roots(g, roots: int, seed: int = 0) -> np.ndarray:
    """Sample distinct non-isolated roots, clamped to what the graph has
    (all vertices when none has an edge), with a warning when clamped."""
    rng = np.random.default_rng(seed)
    candidates = np.flatnonzero(g.degrees > 0)
    if candidates.size == 0:
        warnings.warn("graph has no edges; sampling roots from all vertices")
        candidates = np.arange(g.num_vertices)
    k = min(roots, candidates.size)
    if k < roots:
        warnings.warn(
            f"requested {roots} roots but only {candidates.size} candidate "
            f"vertices exist; clamping to {k}")
    return rng.choice(candidates, size=k, replace=False)


def run(scale: int, nparts: int, strategy: str, roots: int = 8,
        heuristic: str = "paper", edgefactor: int = 16, seed: int = 0,
        validate: bool = True, graph=None, device=None,
        cache_dir=None) -> dict:
    """One Graph500-mode run; with `nparts` > 1 on a process group of as
    many ranks, every rank calling it alike. `cache_dir` configures the
    process's artifact cache (None: REPRO_CACHE_DIR, if set)."""
    from repro_torch.core import graph as G
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import Engine
    from repro_torch.kernels import _build
    from repro_torch.runtime import configure

    if cache_dir is not None:
        configure(cache_dir=cache_dir)
    g = graph if graph is not None else G.rmat(scale, edgefactor=edgefactor,
                                               seed=seed)
    if roots < 1:
        raise ValueError(f"need at least one search root, got roots={roots}")
    root_list = sample_roots(g, roots, seed)
    engine = Engine(g, device=device, default_strategy=strategy)
    # batched=False: every root timed on its own (the first query's
    # warm-up outside the timed region).
    res = engine.bfs(root_list, BFSConfig(heuristic=heuristic),
                     n_parts=nparts, batched=False, validate=validate)
    teps = res.teps_per_root
    rt = engine.session.runtime_stats()
    return {"scale": scale, "nparts": nparts, "strategy": strategy,
            "heuristic": heuristic, "backend": res.backend,
            "device": str(engine.device), "teps_hmean": res.teps_hmean,
            "teps_min": float(teps.min()), "teps_max": float(teps.max()),
            "mean_s": float(res.per_root_seconds.mean()),
            "V": g.num_vertices, "E_undirected": g.num_undirected_edges,
            "warm": {"builds": rt["builds"].get("cohort", 0),
                     "loads": rt["loads"],
                     "compiles": _build.STATS["compiles"],
                     "cache_enabled": rt["cache_enabled"]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--nparts", type=int, default=1)
    ap.add_argument("--strategy", default="specialized",
                    choices=("random", "hub0", "specialized"))
    ap.add_argument("--heuristic", default="paper",
                    choices=("paper", "beamer", "topdown", "bottomup"))
    ap.add_argument("--roots", type=int, default=8)
    ap.add_argument("--no-validate", action="store_true")
    ap.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"),
                    help="process group backend under torchrun (gloo when "
                         "ranks share a GPU: NCCL refuses that)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, "
                         "cuda:(LOCAL_RANK %% cards) under torchrun)")
    ap.add_argument("--cache-dir", default=None,
                    help="persistent artifact cache directory: kernel "
                         "libraries and plan records (default: "
                         "REPRO_CACHE_DIR if set, else disabled)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    rank, device = 0, args.device
    joined = "RANK" in os.environ          # started by torchrun
    if joined:
        rank = int(os.environ["RANK"])
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device; pass --device cpu")
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(args.dist_backend, init_method="env://")
    try:
        res = run(args.scale, args.nparts, args.strategy, args.roots,
                  args.heuristic, args.edgefactor,
                  validate=not args.no_validate, device=device,
                  cache_dir=args.cache_dir)
    finally:
        if joined:
            dist.destroy_process_group()
    if rank == 0:
        warm = res["warm"]
        cache_note = (f" cache[builds={warm['builds']} loads={warm['loads']}"
                      f" compiles={warm['compiles']}]"
                      if warm["cache_enabled"] else "")
        print(f"[bfs] scale={res['scale']} V={res['V']} "
              f"E={res['E_undirected']} P={res['nparts']} "
              f"{res['strategy']}/{res['heuristic']}: "
              f"{res['teps_hmean'] / 1e6:.2f} MTEPS (hmean over "
              f"{args.roots} roots){cache_note}", flush=True)
    return res


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: the paper's algorithm end to end.

Generates a Graph500-style RMAT graph, runs a direction-optimized BFS from
its highest-degree vertex through `repro_torch.engine.Engine` on the
single-root stepper, validates the parent tree, and prints the direction
taken at each level (the paper's Fig. 1 story at small scale).

    PYTHONPATH=src python examples/quickstart_torch.py               # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

It runs on the GPU unless given the CPU, and raises where CUDA is missing.
"""
import argparse

import numpy as np


def main(tiny: bool = False, device=None):
    from repro_torch.core import graph as G
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import Engine

    scale = 10 if tiny else 14
    g = G.rmat(scale, seed=0)
    root = int(np.argmax(g.degrees))
    print(f"RMAT scale {scale}: V={g.num_vertices:,} "
          f"E={g.num_undirected_edges:,} max_deg={g.max_degree}")

    engine = Engine(g, device=device)
    res = engine.bfs(root, BFSConfig(heuristic="paper"), backend="stepper",
                     n_parts=1, validate=True)
    stats = res.per_level_stats[0]
    print(f"BFS from hub {root}: {len(stats)} levels, "
          f"{len(res.reached()):,} reached, parent tree VALID")
    for s in stats:
        bar = "#" * max(1, int(40 * s["frontier_size"] / g.num_vertices))
        print(f"  L{s['level']:<2} {s['direction']:>2} "
              f"|F|={s['frontier_size']:>8,} mf={s['frontier_edges']:>10,} "
              f"{s['seconds'] * 1e3:7.1f}ms {bar}")
    dev = engine.device
    name = ""
    if dev.type == "cuda":
        import torch
        name = f", {torch.cuda.get_device_name(dev)}"
    teps = g.num_undirected_edges / sum(s["seconds"] for s in stats)
    print(f"~{teps / 1e6:.1f} MTEPS ({dev}{name}, eager PyTorch)")
    return stats


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="RMAT scale 10")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(tiny=args.tiny, device=args.device)

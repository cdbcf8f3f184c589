"""Partitioned BFS demo on the PyTorch port: the paper's Fig. 2 contrast.

Runs random, hub0 and specialized partitioning on P partitions, one
`torch.distributed` rank each, through ONE `Engine` (the graph is
preprocessed once; each strategy adds its partition plan), and rank 0
prints each strategy's harmonic-mean MTEPS over the sampled roots:

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        examples/bfs_demo_torch.py                    # ranks share the GPU
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        examples/bfs_demo_torch.py --scale 8 --device cpu

Every rank joins the group from the environment (`env://`), as
`repro_torch.launch.bfs_run` does, and runs on
`cuda:(LOCAL_RANK % device_count)` unless given the CPU; without CUDA it
raises. Ranks that share one card exchange through gloo (NCCL refuses two
ranks on one GPU), so the numbers compare the strategies on one card, not
speed across cards.
"""
import argparse
import os

NOTES = {"random": "paper baseline",
         "hub0": "paper-faithful hub placement",
         "specialized": "hubs delegated: each high-degree vertex's edges "
                        "spread over every partition"}


def run(scale: int, nparts: int, roots: int = 4, device=None) -> dict:
    """Every rank of a group of `nparts` calls this alike: {strategy:
    harmonic-mean TEPS}, each strategy's trees validated."""
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    from repro_torch.launch.bfs_run import sample_roots

    g = G.rmat(scale, seed=0)
    engine = Engine(g, device=device)
    root_list = sample_roots(g, roots)
    return {strategy: engine.bfs(root_list, n_parts=nparts,
                                 strategy=strategy, batched=False,
                                 validate=True).teps_hmean
            for strategy in NOTES}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--roots", type=int, default=4)
    ap.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"),
                    help="process group backend (gloo when ranks share a "
                         "GPU: NCCL refuses that)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:(LOCAL_RANK %% cards))")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if "RANK" not in os.environ:
        raise SystemExit("run under torchrun, one rank a partition: "
                         "torchrun --standalone --nproc-per-node 4 "
                         "examples/bfs_demo_torch.py")
    rank = int(os.environ["RANK"])
    dist.init_process_group(args.dist_backend, init_method="env://")
    nparts = dist.get_world_size()
    try:
        results = run(args.scale, nparts, args.roots, device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(f"RMAT scale {args.scale}, P={nparts} ranks on {device}")
        print(f"{'strategy':>12} {'MTEPS':>8}  note")
        for strategy, teps in results.items():
            print(f"{strategy:>12} {teps / 1e6:8.2f}  {NOTES[strategy]}")
    return results


if __name__ == "__main__":
    main()

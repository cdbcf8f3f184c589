"""One process per partition: `run_ranks` starts `n` ranks and joins them.

The port's counterpart of the JAX package's device mesh. Each rank is a
process spawned with `torch.multiprocessing` that joins a
`torch.distributed` group through a `file://` rendezvous in a directory the
caller gives (a file cannot collide with the ports of parallel test
workers), runs `fn(rank, group, device, *args)` and hands its return value
(numpy or plain Python: it is pickled) back to the parent.

* The device is `cuda:(rank % device_count)` unless the caller asks for the
  CPU: with no device the ranks run on CUDA, and without CUDA this raises
  before any rank starts. On CUDA the parent builds the kernels once
  (`kernels._build.build_all`) first, so the ranks find them built.
* The backend is the caller's (`gloo` or `nccl`); nothing here switches
  it. NCCL refuses two ranks on one GPU, so ranks that share a card
  exchange through gloo.
* Every rank calls `torch.set_num_threads(1)`.
* `timeout` bounds the group's collectives (`init_process_group(timeout=)`)
  and the whole run: if a rank raises, dies or outlives it, the others are
  killed and this raises with the failing rank's traceback.

`torchrun --standalone --nproc-per-node P` is the other way in: the
launcher (`repro_torch.launch.bfs_run`) then takes the group from the
environment.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device


def _rank_main(rank: int, n: int, init_file: str, backend: str,
               on_cuda: bool, timeout: float, fn: Callable, args: tuple,
               results) -> None:
    """A rank's process: join the group, run `fn`, report to the parent."""
    try:
        torch.set_num_threads(1)
        if on_cuda:
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, dist.group.WORLD, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, n: int, rendezvous_dir: str, *,
              args: Sequence = (), backend: str = "gloo", device=None,
              timeout: float = 600.0) -> list[Any]:
    """Run `fn(rank, group, device, *args)` on `n` spawned ranks and return
    their results in rank order. `fn` must be importable (module level).

    `device`: None or "cuda" for CUDA (raises without it), "cpu" for the
    CPU. Raises `RuntimeError` with the traceback of the first rank that
    fails or dies, `TimeoutError` if the ranks outlive `timeout` seconds;
    either way every rank is stopped first.
    """
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        from repro_torch.kernels import _build
        _build.build_all()
    fd, init_file = tempfile.mkstemp(prefix="rendezvous-", dir=rendezvous_dir)
    os.close(fd)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init_file, backend, on_cuda, timeout,
                               fn, tuple(args), results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    gone: set[int] = set()      # exited, report not read yet
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                # A rank's report is in the queue before its process ends,
                # so one that is still missing a second later never comes.
                dead = [r for r in gone if r not in got]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} before reporting")
                gone |= {r for r, p in enumerate(procs)
                         if p.exitcode is not None}
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{n} ranks still running after {timeout} s; "
                        f"missing ranks {sorted(set(range(n)) - set(got))}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        if os.path.exists(init_file):     # the store may have removed it
            os.remove(init_file)
    return [got[r] for r in range(n)]

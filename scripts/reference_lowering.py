"""Lower and compile the JAX package's train and prefill cells at full
width on a production mesh of `Auto` axes, and print each cell's compiled
bytes a device: the reference's side of the port's dry-run (`PERF.md` §6
puts these in brackets beside the port's `bytes_per_rank_est`).

    python3 scripts/reference_lowering.py yi-34b:train_4k \\
        stablelm-3b:prefill_32k [--multi-pod]

Runs on the CPU over 512 host devices (it sets `XLA_FLAGS` itself). The
installed JAX's `jax.make_mesh`, which `repro.launch.dryrun` calls, builds
`Explicit` axes, on which the reference's sharding constraints raise;
here `repro.launch.dryrun.make_production_mesh` is replaced, in this
process only, by a `jax.sharding.Mesh` of the same shape and axis names
(`Auto` axes). Nothing of the JAX package is edited. One JSON line a
cell: `bytes_per_device` as the reference's `run_cell` computes it
(temporaries + arguments + outputs - aliases), `arg_bytes`,
`temp_bytes`, and the lowering's and the compile's seconds; a cell that
fails prints its error instead. `lower` is the same for one cell, with
a config of the caller's (`tests/test_torch_dryrun_train.py` imports it).
Needs the JAX package and JAX on the path (`PYTHONPATH=src`); it is a tool
beside the port, which imports neither.
"""
from __future__ import annotations

import json
import os
import sys
import time


def auto_mesh(*, multi_pod: bool = False):
    import jax
    import numpy as np
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    devs = jax.devices()[:int(np.prod(shape))]
    return jax.sharding.Mesh(np.array(devs).reshape(shape), axes)


def lower(arch: str, shape: str, multi_pod: bool, cfg=None) -> dict:
    """One cell's record (`cfg` overrides the arch's config), its mesh of
    `Auto` axes; the process must see 512 host devices."""
    from repro.launch import dryrun as JDR
    JDR.make_production_mesh = auto_mesh
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16", "axes": "auto"}
    try:
        t0 = time.time()
        _, _, _, lowered = JDR.lower_cell(arch, shape, multi_pod,
                                          cfg_override=cfg)
        t1 = time.time()
        mem = lowered.compile().memory_analysis()
        rec.update(lower_s=round(t1 - t0, 1),
                   compile_s=round(time.time() - t1, 1),
                   bytes_per_device=int(
                       mem.temp_size_in_bytes
                       + mem.argument_size_in_bytes
                       + mem.output_size_in_bytes
                       - mem.alias_size_in_bytes),
                   arg_bytes=int(mem.argument_size_in_bytes),
                   temp_bytes=int(mem.temp_size_in_bytes))
    except Exception as e:          # recorded; the next cell runs
        rec["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    return rec


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    multi_pod = "--multi-pod" in args
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    for cell in args:
        if cell != "--multi-pod":
            print(json.dumps(lower(*cell.split(":"), multi_pod)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

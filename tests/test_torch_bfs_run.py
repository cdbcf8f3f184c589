"""The port's workload driver (`repro_torch.launch.bfs_run`) on the CPU.

Root sampling equals the JAX driver's; `main` runs one partition in
process, refuses more partitions than ranks with the fix in its message,
and under `torchrun` (two gloo ranks on the CPU) every rank runs the query
and only rank 0 prints the JAX driver's line.
"""
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

from repro.core import graph as JG
from repro.launch import bfs_run as jrun
from repro_torch.core import graph as TG
from repro_torch.launch import bfs_run

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pairs():
    star = [G.from_edges(np.zeros(6, np.int64), np.arange(1, 7), 9)
            for G in (TG, JG)]
    edgeless = [G.from_edges(np.array([], np.int64), np.array([], np.int64),
                             12) for G in (TG, JG)]
    return [(TG.rmat(8, seed=2), JG.rmat(8, seed=2)), star, edgeless]


def _sampled(fn, g, roots):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = fn(g, roots, 3)
    return got, [str(w.message) for w in seen]


@pytest.mark.parametrize("roots", [1, 5, 40])
def test_sample_roots_matches_reference(roots):
    for tg, jg in _pairs():
        mine, mine_w = _sampled(bfs_run.sample_roots, tg, roots)
        ref, ref_w = _sampled(jrun.sample_roots, jg, roots)
        np.testing.assert_array_equal(mine, ref)
        assert mine_w == ref_w


def test_main_runs_one_partition_on_the_cpu(capsys):
    res = bfs_run.main(["--scale", "8", "--roots", "2", "--device", "cpu"])
    assert res["backend"] == "fused" and res["device"] == "cpu"
    assert res["teps_hmean"] > 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[bfs] scale=8 V=256 ") and "P=1 " in line


def test_main_needs_a_rank_per_partition():
    with pytest.raises(ValueError, match="torchrun"):
        bfs_run.main(["--scale", "7", "--nparts", "2", "--device", "cpu"])


def test_torchrun_ranks_print_once():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.bfs_run",
         "--scale", "8", "--nparts", "2", "--roots", "2", "--device", "cpu",
         "--strategy", "hub0"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[bfs]")]
    assert len(lines) == 1 and "P=2 hub0/paper" in lines[0], out.stdout

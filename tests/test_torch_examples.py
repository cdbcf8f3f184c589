"""The port's two BFS examples on the CPU, and their refusal without CUDA.

`examples/quickstart_torch.py` runs a validated stepper search and returns
its per-level rows, which equal the JAX quickstart's (levels, directions,
frontier sizes and edges are integers); `examples/bfs_demo_torch.py` runs
its three strategies on 2 gloo ranks under `torchrun`, and only rank 0
prints (their refusal without CUDA is in `test_torch_isolation.py`).
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("level", "direction", "frontier_size", "frontier_edges")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_rows_match_the_jax_quickstart(capsys):
    rows = _example("quickstart_torch").main(tiny=True, device="cpu")
    out = capsys.readouterr().out
    assert "parent tree VALID" in out and "MTEPS (cpu, " in out
    want = _example("quickstart").main(tiny=True)
    assert [{k: r[k] for k in KEYS} for r in rows] == \
        [{k: r[k] for k in KEYS} for r in want]
    assert {r["direction"] for r in rows} == {"td", "bu"}


def test_bfs_demo_runs_on_two_gloo_ranks():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(REPO / "examples" / "bfs_demo_torch.py"),
         "--scale", "8", "--roots", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines.count("RMAT scale 8, P=2 ranks on cpu") == 1, out.stdout
    rows = [ln.split() for ln in lines if ln.split()[:1] in (
        ["random"], ["hub0"], ["specialized"])]
    assert [r[0] for r in rows] == ["random", "hub0", "specialized"]
    assert all(float(r[1]) > 0 for r in rows)


def test_bfs_demo_outside_torchrun_says_how_to_start_it(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        _example("bfs_demo_torch").main(["--device", "cpu"])

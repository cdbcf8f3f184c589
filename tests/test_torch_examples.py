"""The port's examples on the CPU, and their refusal without CUDA.

`examples/quickstart_torch.py` runs a validated stepper search and returns
its per-level rows, which equal the JAX quickstart's (levels, directions,
frontier sizes and edges are integers); `examples/bfs_demo_torch.py` runs
its three strategies on 2 gloo ranks under `torchrun`, and only rank 0
prints (their refusal without CUDA is in `test_torch_isolation.py`).
`examples/train_lm_torch.py` trains its ~100 M-parameter model two
steps at a small batch (and asks for CUDA unless told the CPU);
`examples/serve_lm_torch.py` serves its default smoke model.
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


def test_train_lm_example_trains(tmp_path, capsys, monkeypatch):
    mod = _example("train_lm_torch")
    args = ["--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt",
            str(tmp_path)]
    losses = mod.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "params=" in out and "on cpu" in out and "done" in out
    n = float(out.split("params=")[1].split("M")[0])
    assert 90 < n < 130, n
    assert len(losses) == 2 and all(9 < x < 12 for x in losses), losses
    assert not list(tmp_path.iterdir())          # no checkpoint before 50
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--steps", "1"])


def test_serve_lm_example_serves_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "serve_lm_torch.py"),
         "--arch", "gemma2-9b", "--smoke", "--batch", "2", "--prompt-len",
         "24", "--gen", "4", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "[serve] gemma2-9b-smoke on cpu: prefill 2x24" in out.stdout
    assert "[serve] decoded 3 steps x 2 seqs" in out.stdout

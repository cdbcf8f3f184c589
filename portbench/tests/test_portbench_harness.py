"""Whole runs of each cell on the CPU at scale 8 (the look for a chip
skipped), and `run.py`'s refusals."""
import json
import os
import subprocess
import sys

import pytest
import torch

import portbench_tiny

REPO = portbench_tiny.REPO
CELLS = ["g500-s24.keys", "svc-s22.poisson", "g500-s24.cohort16",
         "g500-s24.cohort16-hub"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_with_its_end_to_end_metrics(root, cell):
    out = portbench_tiny.run_cell(root, cell)
    from portbench.manifest import Manifest
    want = {x["name"] for x in Manifest(root).metrics("end_to_end", cell)}
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


@pytest.mark.parametrize("cell", ["g500-s24.keys", "svc-s22.poisson"])
def test_traced_run_reads_its_spans_and_counters(root, cell):
    out = portbench_tiny.run_cell(root, cell, trace=True)
    assert out["correct"]
    m = out["metrics"]
    # the CPU has no device trace and runs no kernel launch: those readers
    # find nothing; the spans and counters are read
    assert "setup.tiles_s" in m and "setup.fingerprint_s" in m
    if cell.startswith("g500"):
        assert 0 < m["driver.finalize_share.g500"]["value"] < 100
        assert 0 < m["driver.levels_share.g500"]["value"] < 100
        assert m["search.hmean_gteps"]["value"] > 0
    else:
        assert m["server.roots_per_dispatch"]["value"] >= 1
        assert 0 < m["driver.finalize_share.svc"]["value"] < 100
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _run_py(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(cwd / "portbench" / "run.py"), "--workload",
         "g500-s24.keys", "--seed", "3", "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_run_py_refuses_without_cuda():
    got = _run_py(REPO)
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "CUDA" in got.stderr


def test_run_py_fails_with_only_the_benchmark(tmp_path):
    # a directory that holds only BENCHMARK.json and the files under paths
    portbench_tiny.tiny_root(tmp_path)
    got = _run_py(tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(root, cuda_device):
    from portbench import harness
    import time
    out = harness.run(root, "g500-s24.cohort16", 5, 0.5, True, cuda_device,
                      time.perf_counter())
    assert out["correct"] and out["device"]["busy_s"] > 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the benchmark's cells run on the "
                    "card through portbench/run.py")
    return torch.device("cuda", 0)

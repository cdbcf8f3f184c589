"""A cell on four chips run as four gloo ranks on the CPU at scale 8
(`portbench_tiny.RANKED`): rank 0's loop through the port's
`PartitionFront`, a follower that fails mid-window or in the traced
slice, a rank that loads a forbidden module, the refusals; and a one-chip
cell, which makes no front and calls `Engine.bfs` as it always has."""
import functools
import sys
import threading
import time
import types

import numpy as np
import pytest

import portbench_tiny

RANKED = "g500-p4.keys"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_ranked_cell_runs_correct_on_four_gloo_ranks(root, trace):
    from portbench.manifest import Manifest
    out = portbench_tiny.run_cell(root, RANKED, trace=trace, seconds=1.0)
    section = "per_layer" if trace else "end_to_end"
    want = {x["name"] for x in Manifest(root).metrics(section, RANKED)}
    want -= set(portbench_tiny.LEVEL_DRIVER_ONLY + portbench_tiny.CPU_SILENT
                + portbench_tiny.SESSION_BUILDS)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 1 and out["failed"] == 0
    # every closed-loop reader reads a number on rank 0, but those of the
    # level driver and of the session's builds, which the partitioned
    # search does not run
    assert set(out["metrics"]) == want, want ^ set(out["metrics"])
    for name, x in out["metrics"].items():
        if x["unit"] == "%":
            assert 0 <= x["value"] <= 100, (name, x)
    dev = out["device"]
    assert dev["count"] == 4 and len(dev["memory_peak_bytes_by_rank"]) == 4
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_rank"])
    assert list(out)[-1] == "checks"
    assert out["checks"]["ranks_failed"] == {"value": 0, "limit": 0}
    if not trace:
        assert out["metrics"]["gteps"]["value"] > 0
        assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("at, seconds, trace, attempted, unanswered", [
    # rank 1 raises at its fourth dispatch, the window's third query, inside
    # a window of 45 s: rank 0 sees its group lost at once, stops, and still
    # returns its result
    (4, 45.0, False, 3, 1),
    # a window of one query (dispatch 2, after the warm-up), then rank 1
    # raises at the traced slice's first: every query of the window came
    # back, and the run is still not correct
    (3, 0.0, True, 1, 0),
], ids=["mid-window", "traced-slice"])
def test_a_failing_follower_ends_the_run_not_correct(
        root, at, seconds, trace, attempted, unanswered):
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "out", portbench_tiny.run_cell(
            root, RANKED, trace=trace, seconds=seconds,
            follower=functools.partial(portbench_tiny.failing_follower,
                                       at=at))))
    t0 = time.perf_counter()
    t.start()
    t.join(timeout=120.0)
    assert not t.is_alive(), "the run outlived its 120 s"
    assert time.perf_counter() - t0 < 45.0, "the window did not stop"
    out = got["out"]
    assert out["attempted"] == attempted
    assert out["failed"] == out["checks"]["unanswered"]["value"] == unanswered
    # rank 1, and ranks 2 and 3 as far as they see the group lost
    lost = out["checks"]["ranks_failed"]
    assert lost["limit"] == 0 and 1 <= lost["value"] <= 3, lost
    assert not out["correct"] and list(out)[-1] == "checks"


def forbidden_follower(group, device, *args) -> tuple:
    """A follower that has loaded a module named `jax` (an empty one)."""
    from portbench import harness
    sys.modules["jax"] = types.ModuleType("jax")
    return harness.follow_front(group, device, *args)


def test_a_rank_holding_a_forbidden_module_fails_the_run(root):
    from portbench import harness
    with pytest.raises(harness.ForbiddenLoaded) as e:
        portbench_tiny.run_cell(root, RANKED, seconds=0.2,
                                follower=forbidden_follower)
    assert e.value.names == ["jax"]
    assert "rank 1: jax" in str(e.value) and "rank 0" not in str(e.value)


def test_open_loop_on_four_chips_is_refused(tmp_path, monkeypatch):
    import json

    from repro_torch.parallel import ranks
    root = portbench_tiny.tiny_root(tmp_path)
    d = json.loads((root / "BENCHMARK.json").read_text())
    d["workloads"][-1]["traffic"] = "poisson"
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    monkeypatch.setattr(ranks, "run_ranks", None)     # no rank may start
    with pytest.raises(ValueError, match="takes a closed loop"):
        portbench_tiny.run_cell(root, RANKED)


def test_unknown_partition_key_is_refused():
    from portbench import drivers
    assert drivers.partition_block({}) == {}
    got = drivers.partition_block({"partition": portbench_tiny.PARTITION})
    assert got == portbench_tiny.PARTITION
    with pytest.raises(ValueError, match="unknown keys"):
        drivers.partition_block({"partition": {"strategie": "specialized"}})


@pytest.mark.parametrize("cell", ["g500-s24.keys", "g500-s24.cohort16"])
def test_one_chip_cell_makes_no_front_and_calls_bfs_as_before(
        root, cell, monkeypatch):
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import Engine, QueryControl
    from repro_torch.engine import partition_front
    from repro_torch.parallel import ranks

    def refuse(*a, **kw):
        raise AssertionError("a one-chip cell made a front or ranks")
    monkeypatch.setattr(partition_front.PartitionFront, "__init__", refuse)
    monkeypatch.setattr(ranks, "run_ranks", refuse)
    calls = []
    bfs = Engine.bfs

    def recorded(self, roots, *args, **kw):
        calls.append((roots, args, kw))
        return bfs(self, roots, *args, **kw)
    monkeypatch.setattr(Engine, "bfs", recorded)
    out = portbench_tiny.run_cell(root, cell)
    assert out["correct"] and out["device"]["count"] == 1
    assert len(calls) == out["attempted"] + 1          # and the warm-up
    batched = cell != "g500-s24.keys"
    for roots, args, kw in calls:
        assert args == (BFSConfig(heuristic="paper"),)
        assert set(kw) == {"batched", "control"}
        assert kw["batched"] is batched
        assert isinstance(kw["control"], QueryControl)
        if batched:
            assert isinstance(roots, np.ndarray) and roots.shape == (16,)
        else:
            assert type(roots) is int

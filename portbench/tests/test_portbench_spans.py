"""The readers of the port's own spans (`repro_torch.runtime.trace`) in a
traced run of each closed-loop cell on the CPU at scale 8, and what they
read where the port records no spans."""
import sys
import time

import pytest

import portbench_tiny

SHARES = ("driver.copy_share.g500", "driver.map_share.g500",
          "driver.init_share.g500", "driver.sync_share.g500",
          "engine.assemble_share.g500", "engine.untraced_share.g500")
STEP_MS = ("step.issue_ms.g500", "step.wait_ms.g500")
SPAN_METRICS = SHARES + STEP_MS


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["g500-s24.keys", "g500-s24.cohort16",
                                  "g500-s24.cohort16-hub"])
def test_traced_run_reads_the_program_spans(root, cell):
    out = portbench_tiny.run_cell(root, cell, trace=True)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in SHARES:
        assert 0 <= m[name] <= 100, (name, m.get(name))
        assert out["metrics"][name]["unit"] == "%"
    for name in STEP_MS:
        assert m[name] > 0, (name, m.get(name))
        assert out["metrics"][name]["unit"] == "ms"
    # the two halves of `finalize` add up to the driver's `agg_s` share
    # (whose denominator is the benchmark's own clock around each query)
    assert abs(m["driver.copy_share.g500"] + m["driver.map_share.g500"]
               - m["driver.finalize_share.g500"]) <= 1.0


def test_readers_find_nothing_without_the_recorder(root, monkeypatch):
    import repro_torch.runtime
    from portbench.harness import Readings
    from portbench.manifest import Manifest
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    from repro_torch.runtime import trace
    eng = Engine(G.rmat(8, seed=1), device="cpu")
    r = Readings("closed")
    r.start = time.perf_counter()
    eng.bfs([0, 1, 2])
    r.close = time.perf_counter()
    eng.session.close()
    read = [Manifest(root).reader(n) for n in SPAN_METRICS]
    assert all(0 <= f(r) <= 100 for f in read[:len(SHARES)])
    assert all(f(r) > 0 for f in read[len(SHARES):])
    monkeypatch.setattr(trace.RECORDER, "_dropped_until", r.close)
    assert all(f(r) is None for f in read)          # a span was dropped
    monkeypatch.undo()
    # a port without the recorder, as versions before it are
    monkeypatch.delattr(repro_torch.runtime, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    assert all(f(r) is None for f in read)
    monkeypatch.undo()
    r.loop = "open"
    assert all(f(r) is None for f in read)


def test_a_share_of_a_span_the_path_never_records_is_none():
    # the partitioned search records no `finalize` and no `driver.init`:
    # their shares find nothing, and copy (`finalize` less `finalize.map`)
    # does not go below 0
    from portbench.harness import Readings
    from portbench.program_spans import share
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    eng = Engine(G.rmat(8, seed=1), device="cpu")
    r = Readings("closed")
    r.start = time.perf_counter()
    eng.bfs([0, 1, 2])
    r.close = time.perf_counter()
    eng.session.close()
    assert 0 < share(r, "finalize") <= 100
    assert share(r, "no.such.span") is None
    assert share(r, "no.such.span", minus="finalize") is None

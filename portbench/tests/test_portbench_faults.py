"""Whole runs on the CPU at scale 8 with the timed path broken underneath:
each fault a cell can have turns `correct` false."""
import numpy as np
import pytest

import portbench_tiny

CELLS = ["g500-s24.keys", "svc-s22.poisson", "g500-s24.cohort16",
         "g500-s24.cohort16-hub"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def hasty_root(tmp_path_factory):
    # a search that never ends is given up 1.5 s past the window
    return portbench_tiny.tiny_root(tmp_path_factory.mktemp("hasty"), 1.5)


def _state_unchanged(monkeypatch):
    from repro_torch.engine import level_loop
    monkeypatch.setattr(level_loop.CohortBatchBackend, "step",
                        lambda self, state, sync: state)


def _half_the_batch(monkeypatch):
    from repro_torch.engine.engine import Engine
    lanes = Engine._lanes

    def half(self, roots, bucket):
        padded, active = lanes(self, roots, bucket)
        active[len(roots) // 2:] = False
        return padded, active
    monkeypatch.setattr(Engine, "_lanes", half)


def _answer_altered(monkeypatch):
    from repro_torch.core import bfs
    finalize = bfs.finalize

    def altered(st):
        parent, level = finalize(st)
        flat = parent.reshape(-1)
        far = np.flatnonzero(level.reshape(-1) > 0)
        if far.size:
            flat[far[-1]] = (flat[far[-1]] + 1) % level.shape[-1]
        return parent, level
    monkeypatch.setattr(bfs, "finalize", altered)


FAULTS = {"a step that returns its state unchanged": _state_unchanged,
          "half of the batch left out": _half_the_batch,
          "an answer altered where it is produced": _answer_altered}


# Each fault a cell can have (a batch of one key has no half to leave
# out; no cell runs on more than one chip, so none has an exchange).
CASES = [(f, c) for f in sorted(FAULTS) for c in CELLS
         if not (f == "half of the batch left out" and c == "g500-s24.keys")]


@pytest.mark.parametrize("fault,cell", CASES)
def test_fault_under_the_timed_path_fails_the_run(root, hasty_root, cell,
                                                  fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    never_ends = fault == "a step that returns its state unchanged"
    out = portbench_tiny.run_cell(hasty_root if never_ends else root, cell,
                                  seconds=0.2)
    assert not out["correct"], out["checks"]
    if not never_ends:
        # the answers came back, and the comparison found them wrong
        assert out["checks"]["unanswered"]["value"] == 0

"""The hub/tail split against the JAX package on small special graphs.

The star, path and edgeless graphs of `tests/test_hetero_split.py`, every
heuristic, `hub_deg` 32 (every row with an edge is on the hub side) and 256
(none is), batched; Graph500 mode at `hub_deg` 32. Parents, levels and
every row key, the hub ones included, must be equal bit for bit. (The
skewed RMAT graph is in `tests/test_torch_hub_split.py`.)
"""
import numpy as np
import pytest

from repro.core import bfs as JB
from repro.core import graph as JG
from repro.engine import Engine as JaxEngine
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import Engine

ROW_KEYS = ("level", "direction", "td_lanes", "bu_lanes", "frontier_size",
            "frontier_edges", "active_lanes", "batch", "lane_frontier",
            "lane_edges", "lane_direction", "lane_active",
            "lane_hub_direction", "lane_hub_frontier", "hub_td_lanes",
            "hub_bu_lanes", "frontier_hub", "frontier_tail")


def _graphs(G):
    star = G.from_edges(np.zeros(47, np.int64), np.arange(1, 48), 48)
    path = G.from_edges(np.arange(49, dtype=np.int64),
                        np.arange(1, 50, dtype=np.int64), 50)
    empty = np.zeros(0, np.int64)
    return {"star": star, "path": path,
            "edgeless": G.from_edges(empty, empty, 17)}


T_GRAPHS, J_GRAPHS = _graphs(TG), _graphs(JG)
ROOTS = {"star": [0, 1, 5], "path": [0, 25], "edgeless": [0, 3]}


@pytest.mark.parametrize("heuristic", ["paper", "beamer", "topdown",
                                       "bottomup"])
@pytest.mark.parametrize("gname", list(T_GRAPHS))
def test_split_engine_matches_reference(gname, heuristic):
    for hub_deg, modes in ((32, (True, False)), (256, (True,))):
        kw = dict(heuristic=heuristic, hub_split=True, hub_deg=hub_deg)
        for batched in modes:
            mine = Engine(T_GRAPHS[gname], device="cpu").bfs(
                ROOTS[gname], TB.BFSConfig(**kw), batched=batched,
                validate=True)
            ref = JaxEngine(J_GRAPHS[gname]).bfs(
                ROOTS[gname], JB.BFSConfig(**kw), batched=batched)
            np.testing.assert_array_equal(mine.parent, ref.parent)
            np.testing.assert_array_equal(mine.level, ref.level)
            np.testing.assert_array_equal(mine.edges_traversed,
                                          ref.edges_traversed)
            if batched:
                rows = [[{k: r[k] for k in ROW_KEYS}
                         for r in res.batch_level_stats] for res in (mine, ref)]
                assert rows[0] == rows[1], (hub_deg, batched)

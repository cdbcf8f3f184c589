"""Traversal engine of the PyTorch port: sessions, batched multi-root BFS.

    from repro_torch.engine import Engine
    result = Engine(graph).bfs([root0, root1, ...])       # on the GPU
    result = Engine(graph, device="cpu").bfs(root0)       # plain versions
    result = Engine(graph).bfs(root0, backend="stepper")  # per-level rows
"""
from repro_torch.engine.engine import BACKENDS, Engine, QueryPlan
from repro_torch.engine.level_loop import (CohortBatchBackend, LevelDriver,
                                           QueryCancelled, QueryControl,
                                           QueryDeadlineExceeded,
                                           SingleStepBackend)
from repro_torch.engine.result import (TraversalResult,
                                       edges_traversed_from_levels)
from repro_torch.engine.session import GraphSession

__all__ = ["Engine", "GraphSession", "TraversalResult", "BACKENDS",
           "QueryPlan", "LevelDriver", "CohortBatchBackend",
           "SingleStepBackend",
           "QueryControl", "QueryCancelled", "QueryDeadlineExceeded",
           "edges_traversed_from_levels"]

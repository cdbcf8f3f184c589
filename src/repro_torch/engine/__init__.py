"""Traversal engine of the PyTorch port: sessions, batched multi-root BFS,
and the concurrent query server.

    from repro_torch.engine import Engine, BFSServer
    result = Engine(graph).bfs([root0, root1, ...])       # on the GPU
    result = Engine(graph, device="cpu").bfs(root0)       # plain versions
    result = Engine(graph).bfs(root0, backend="stepper")  # per-level rows

    server = BFSServer({"web": graph})                    # on the GPU
    handle = server.submit("web", [root0, root1], client="alice")
    result = handle.result(timeout=60)
    server.close()

Partitioned plans are served on rank 0 of a group through a
`PartitionFront` while the other ranks run `follow` (see
`partition_front`).
"""
from repro_torch.engine.engine import (AUTO_SHARD_MIN_EDGES, BACKENDS,
                                       Engine, QueryPlan)
from repro_torch.engine.level_loop import (AgreedAbort, AgreedControl,
                                           BSPStepBackend,
                                           CohortBatchBackend, LevelDriver,
                                           QueryCancelled, QueryControl,
                                           QueryDeadlineExceeded,
                                           SingleStepBackend)
from repro_torch.engine.partition_front import (PartitionFront,
                                                PartitionLost, follow)
from repro_torch.engine.queueing import (BatchPopError, BoundedPriorityQueue,
                                         CircuitBreaker, ClientCaps,
                                         QueueClosed, QueueFull, RetryPolicy,
                                         ServerOverloaded,
                                         SessionUnavailable)
from repro_torch.engine.result import (TraversalResult,
                                       edges_traversed_from_levels)
from repro_torch.engine.server import BFSServer, QueryHandle, ServerClosed
from repro_torch.engine.session import GraphSession

__all__ = ["Engine", "GraphSession", "TraversalResult", "BACKENDS",
           "AUTO_SHARD_MIN_EDGES", "QueryPlan",
           "LevelDriver", "SingleStepBackend", "BSPStepBackend",
           "CohortBatchBackend",
           "QueryControl", "QueryCancelled", "QueryDeadlineExceeded",
           "AgreedControl", "AgreedAbort",
           "PartitionFront", "PartitionLost", "follow",
           "BFSServer", "QueryHandle", "ServerOverloaded", "ServerClosed",
           "BoundedPriorityQueue", "ClientCaps", "QueueFull", "QueueClosed",
           "BatchPopError", "CircuitBreaker", "RetryPolicy",
           "SessionUnavailable",
           "edges_traversed_from_levels"]

"""Multi-process execution of the partitioned BFS on `torch.distributed`:
the exchange collectives (`collectives`) and a launcher of one process per
partition (`ranks`), the port's counterpart of a `shard_map` mesh."""

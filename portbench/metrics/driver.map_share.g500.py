"""driver.map_share.g500: the port's `finalize.map` spans (in
`core.bfs.finalize`, the issue of the device mapping of the unreached
sentinel to -1, before the result's copy to the host; on the
partitioned path, `core.hybrid_bfs.finalize_hybrid`, still the host
mapping and unpermutation after the copy) summed over the window, as a
share of its `engine.query` spans there, summed
(`portbench.program_spans`)."""
from portbench.program_spans import share


def read(r):
    return share(r, "finalize.map")

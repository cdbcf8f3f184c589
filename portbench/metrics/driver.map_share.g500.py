"""driver.map_share.g500: the port's `finalize.map` spans (the host
mapping of the copied result to Graph500 conventions, `np.where` and
`astype` in `core.bfs.finalize`) summed over the window, as a share of
its `engine.query` spans there, summed (`portbench.program_spans`)."""
from portbench.program_spans import share


def read(r):
    return share(r, "finalize.map")

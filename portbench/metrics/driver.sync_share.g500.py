"""driver.sync_share.g500: the port's `level.sync` spans (`host_sync`,
the level driver's one copy of a level's scalars to the host) summed
over the window, as a share of its `engine.query` spans there, summed
(`portbench.program_spans`)."""
from portbench.program_spans import share


def read(r):
    return share(r, "level.sync")

"""driver.copy_share.g500: the port's `finalize` spans (the level
driver's `agg_s`) less the `finalize.map` spans under them, that is the
[B, V] result's copy to the host, summed over the window, as a share of
its `engine.query` spans there, summed (`portbench.program_spans`)."""
from portbench.program_spans import share


def read(r):
    return share(r, "finalize", minus="finalize.map")

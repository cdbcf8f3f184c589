"""driver.init_share.g500: the port's `driver.init` spans (the level
driver's `init_s`: the backend's initial state, up to its device fence)
summed over the window, as a share of its `engine.query` spans there,
summed (`portbench.program_spans`)."""
from portbench.program_spans import share


def read(r):
    return share(r, "driver.init")

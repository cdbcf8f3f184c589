"""step.wait_ms.g500: the port's `level.wait` spans (the host waiting at
a level's device fence for the step's device work) summed over the
window, per level searched there, in ms (`portbench.program_spans`)."""
from portbench.program_spans import per_level_ms


def read(r):
    return per_level_ms(r, "level.wait")

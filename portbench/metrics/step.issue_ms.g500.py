"""step.issue_ms.g500: the port's `level.issue` spans (the host issuing
a level's step, up to its device fence) summed over the window, per level
searched there, in ms (`portbench.program_spans`)."""
from portbench.program_spans import per_level_ms


def read(r):
    return per_level_ms(r, "level.issue")

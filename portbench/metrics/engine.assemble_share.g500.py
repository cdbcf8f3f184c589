"""engine.assemble_share.g500: the port's `engine.assemble` spans (the
engine's result assembly after the last level-driver run: slices,
stacks, `_tree_depth`, `edges_traversed_from_levels`) summed over the
window, as a share of its `engine.query` spans there, summed
(`portbench.program_spans`)."""
from portbench.program_spans import share


def read(r):
    return share(r, "engine.assemble")

"""Graph substrate, ELL tiles, frontier helpers and the batched BFS steps."""

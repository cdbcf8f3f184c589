"""PyTorch port of the direction-optimized BFS system, for NVIDIA Hopper.

A second package beside the JAX reference (`repro`): the same module
names, held against the reference bit for bit. It imports torch and numpy,
never JAX and nothing of `repro`. Entry point: `repro_torch.engine.Engine`.
"""

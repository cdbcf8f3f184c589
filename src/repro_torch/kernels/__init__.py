"""Hand-written CUDA kernels (`csrc/`), their plain PyTorch versions, and
the dispatch wrappers (`ops`)."""

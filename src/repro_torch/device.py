"""The device every entry point of the port runs on: the GPU unless the
caller names another. Shared by the BFS engine and the serving launcher."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device`, or the GPU when None. Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Mesh construction (the JAX package's `launch/mesh.py`). Functions, not
module-level constants: importing this module touches no process group.

The production meshes (16 x 16 and 2 x 16 x 16 chips) have no hardware
behind them here: `fake_world(n)` opens a process group of `n` ranks on
PyTorch's `fake` backend (this process is the last rank, and a collective
on it moves nothing), in which `init_device_mesh` builds them, and always
destroys it on the way out. DTensors on such a mesh, made under
`FakeTensorMode`, carry shapes, placements and the collectives DTensor
would issue, with no data (`launch/dryrun.py`). A fake group left behind
would change what later code in the process sees (`dist.is_initialized()`).
`make_debug_mesh` builds a small mesh over real ranks that already share
a group (`parallel.ranks.run_ranks`, torchrun).
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """((dims), (axis names)) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def mesh_name(multi_pod: bool = False) -> str:
    return "x".join(map(str, production_shape(multi_pod)[0]))


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of `n` ranks on the `fake` backend, destroyed on exit
    (also when the body raises). This process is the last rank: under
    sequence parallelism its block of queries sees every key, so the
    dry-run counts the rank with the most causal attention work."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), world_size=n,
                            rank=n - 1)
    try:
        yield n
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 single-pod (256 chips) or 2 x 16 x 16 multi-pod (512 chips)
    mesh over the ranks of the current (fake) world, which must hold
    exactly its size.

    Axes: `pod` carries pure data parallelism across pods; `data` carries
    DP + FSDP; `model` carries TP/EP/SP.
    """
    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have}; open "
            f"`launch.mesh.fake_world({n})` first")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False):
    """`make_production_mesh` in a fake world of exactly its size, opened
    and destroyed around the body."""
    n = math.prod(production_shape(multi_pod)[0])
    with fake_world(n):
        yield make_production_mesh(multi_pod=multi_pod)


def make_debug_mesh(n_data: int = 1, n_model: int = 1,
                    device_type: str = "cpu") -> DeviceMesh:
    """(`data`, `model`) mesh over the ranks of the current group, which
    must hold exactly n_data * n_model of them (tests, the card's gloo
    ranks)."""
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))

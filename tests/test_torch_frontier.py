"""The port's frontier pack-and-count wrappers against the JAX package.

On the CPU, `repro_torch.kernels.ops.frontier_fused_batch` and
`frontier_fused` run the plain PyTorch version; the JAX side runs the
Pallas kernels in interpret mode. Inputs are made with numpy from a seed,
and every output is an integer, so equality is exact: the bitmap, `nf`
and `mf` (an int32 sum that wraps as the reference's does). The CUDA
kernel itself is checked on the card (`chip_smoke.py` phases 2 and 2b and
the `cuda`-marked test in `tests/test_torch_kernels.py`).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.core import graph as TG
from repro_torch.engine import Engine
from repro_torch.kernels import frontier_fused as tff
from repro_torch.kernels import ops

# (B, V): ragged V (below one word, not a multiple of 32), one lane and the
# lane blocks of the CUDA kernel (8, 16) and one between.
SHAPES = list(dict.fromkeys(
    [(1, 37), (8, 257), (3, 8192), (2, 10000)]
    + [(b, v) for b in (1, 3, 8, 16) for v in (1, 31, 37, 4096, 10000)]))


def _eq(mine, ref):
    mine = mine.numpy()
    ref = np.asarray(ref)
    assert mine.dtype == ref.dtype, (mine.dtype, ref.dtype)
    np.testing.assert_array_equal(mine, ref)


def _case(b, v, seed=None):
    """flags uint8[B, V] of density 0.3 with the last lane empty (when
    there is more than one), degrees int32[V]."""
    rng = np.random.default_rng(v if seed is None else seed)
    flags = (rng.random((b, v)) < 0.3).astype(np.uint8)
    if b > 1:
        flags[-1] = 0
    deg = rng.integers(0, 5000, v).astype(np.int32)
    return flags, deg


@functools.lru_cache(maxsize=None)
def _pallas(b, v):
    flags, deg = _case(b, v)
    return tuple(np.asarray(x) for x in jops.frontier_fused_batch(
        jnp.asarray(flags), jnp.asarray(deg), interpret=True))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("b,v", SHAPES)
def test_frontier_fused_batch_matches_pallas(b, v, packed):
    flags, deg = _case(b, v)
    pk1, nf1, mf1 = ops.frontier_fused_batch(torch.from_numpy(flags),
                                             torch.from_numpy(deg),
                                             packed=packed)
    pk2, nf2, mf2 = _pallas(b, v)
    if packed:
        _eq(pk1, pk2)
    else:
        assert pk1 is None
    _eq(nf1, nf2)
    _eq(mf1, mf2)
    if b > 1:
        assert int(nf1[-1]) == int(mf1[-1]) == 0       # the empty lane


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("total", [2**31 - 1, 2**31])
def test_frontier_fused_mf_near_int32_limit(total, packed):
    """Every flag set, degrees summing to 2^31 - 1 per lane (int32 exactly
    at the top) or to 2^31 (one past it: the sum wraps to -2^31)."""
    v = 4096
    deg = np.full(v, total // v, np.int64)
    deg[0] += total - int(deg.sum())
    deg = deg.astype(np.int32)
    flags = np.ones((2, v), np.uint8)
    flags[1, 0] = 0
    pk1, nf1, mf1 = ops.frontier_fused_batch(torch.from_numpy(flags),
                                             torch.from_numpy(deg),
                                             packed=packed)
    pk2, nf2, mf2 = jops.frontier_fused_batch(jnp.asarray(flags),
                                              jnp.asarray(deg),
                                              interpret=True)
    assert mf1.tolist()[0] == (total if total < 2**31 else -2**31)
    assert nf1.tolist() == [v, v - 1]
    if packed:
        _eq(pk1, pk2)
    _eq(nf1, nf2)
    _eq(mf1, mf2)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("v", [1, 31, 37, 4096, 10000])
def test_frontier_fused_one_lane_matches_pallas(v, packed):
    """The single-lane entry: 0-dim nf and mf, the bitmap or None."""
    flags, deg = _case(1, v, seed=v + 1)
    got = ops.frontier_fused(torch.from_numpy(flags[0]),
                             torch.from_numpy(deg), packed=packed)
    want = jops.frontier_fused(jnp.asarray(flags[0]), jnp.asarray(deg),
                               interpret=True)
    assert got[1].dim() == got[2].dim() == 0
    assert (got[1].dtype, got[2].dtype) == (torch.int32, torch.int32)
    if packed:
        assert tuple(got[0].shape) == ((v + 31) // 32,)
        _eq(got[0], want[0])
    else:
        assert got[0] is None
    _eq(got[1], want[1])
    _eq(got[2], want[2])


@pytest.mark.parametrize("b,v", [(1, 37), (3, 100), (8, 4099), (16, 31)])
def test_frontier_fused_unaligned_view(b, v):
    """Rows that start one byte in (a view `flags[:, 1:]`, row stride V + 1)
    and degrees one int32 in: the wrapper takes the views as they are."""
    flags, deg = _case(b, v + 1)
    tf, td = torch.from_numpy(flags)[:, 1:], torch.from_numpy(deg)[1:]
    assert tf.storage_offset() == 1 and tf.stride(0) == v + 1
    pk1, nf1, mf1 = ops.frontier_fused_batch(tf, td)
    pk2, nf2, mf2 = jops.frontier_fused_batch(
        jnp.asarray(flags[:, 1:]), jnp.asarray(deg[1:]), interpret=True)
    _eq(pk1, pk2)
    _eq(nf1, nf2)
    _eq(mf1, mf2)


def test_wrappers_hand_over_the_callers_tensors(monkeypatch):
    """No padding and no copy: for any V the wrappers pass the caller's own
    tensors (views included) to the kernel's function, with the keyword."""
    seen = []

    def record(flags, deg, *, packed=True):
        seen.append((flags, deg, packed))
        return None, torch.zeros(flags.shape[0], dtype=torch.int32), \
            torch.zeros(flags.shape[0], dtype=torch.int32)
    monkeypatch.setattr(tff, "frontier_fused_batch_plain", record)
    flags, deg = (torch.from_numpy(x) for x in _case(3, 38))
    view = flags[:, 1:]
    ops.frontier_fused_batch(view, deg[1:], packed=False)
    assert seen[-1][0] is view and seen[-1][2] is False
    assert seen[-1][1].data_ptr() == deg.data_ptr() + 4
    assert not hasattr(ops, "pad_words")


def test_bfs_paths_ask_for_no_bitmap(monkeypatch):
    """Both BFS paths (the fused cohort path and the stepper) call the
    packing wrappers with packed=False: they read only nf and mf."""
    calls = []
    for name in ("frontier_fused_batch", "frontier_fused"):
        real = getattr(ops, name)

        def wrap(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("packed", True)))
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, wrap)
    g = TG.rmat(8, seed=1)
    roots = np.flatnonzero(g.degrees > 0)[:3]
    eng = Engine(g, device="cpu")
    eng.bfs(roots)
    eng.bfs(roots[:1], backend="stepper")
    assert {n for n, _ in calls} == {"frontier_fused_batch",
                                     "frontier_fused"}
    assert all(packed is False for _, packed in calls)


@pytest.mark.parametrize("b,v,sms,resident", [
    (1, 1, 132, 8), (1, 4194304, 132, 8), (8, 4194304, 132, 8),
    (2, 37, 132, 8), (3, 10000, 132, 8), (16, 37, 132, 8),
    (40, 1 << 20, 132, 6), (9, 100003, 1, 1), (1, 1 << 30, 1000, 8)])
def test_fused_plan_covers_every_word(b, v, sms, resident):
    """The launch shape: every lane in a group, every word in a tile, no
    more blocks than there are tiles, than the SMs hold (shared by the
    groups) or than the accumulators' count bits allow."""
    p = tff.fused_plan(b, v, sms, resident)
    lb = p["lanes_block"]
    assert lb == (1 if b == 1 else (2 if b == 2 else (4 if b <= 4 else 8)))
    assert p["groups"] * lb >= b > (p["groups"] - 1) * lb
    assert p["tile_words"] * lb == tff.THREADS
    assert p["tiles"] * p["tile_words"] >= (v + 31) // 32 \
        > (p["tiles"] - 1) * p["tile_words"]
    assert 1 <= p["blocks"] <= min(p["tiles"], tff.MAX_BLOCKS)
    assert p["blocks"] <= -(-(sms * resident) // p["groups"])

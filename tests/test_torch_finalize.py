"""The port's `core.bfs.finalize` against the JAX package's.

Both are fed the same numpy state through `repro_torch.interop`: a single
root's [V] `BFSState` and a cohort's [B, V] `BatchState`, with a pad lane
that holds only sentinels, with no sentinel, with nothing but sentinels,
and with the only reached entries at vertices 0 and V - 1. The results
must be equal, int32, of the state's shape and C-contiguous; the port
maps on the state's device into new tensors, so the state is left as it
was and a second call returns the same answer.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bfs as JB
from repro_torch import interop
from repro_torch.core import bfs as TB

CPU = torch.device("cpu")
INT_MAX = TB.INT_MAX
V = 37
B = 4


def _state_arrays(parent, level):
    """Every field of a `BFSState` ([V]) or `BatchState` ([B, V]) around
    the given parent/level arrays, each with its dtype."""
    shape = parent.shape
    lanes = shape[:-1]
    u8 = np.zeros(shape, np.uint8)
    i32 = np.zeros(lanes, np.int32)
    flag = np.zeros(lanes, bool)
    arrays = dict(visited=(level != INT_MAX).astype(np.uint8),
                  frontier=u8, parent=parent, level=level,
                  cur_level=np.int32(3), bu_mode=flag, bu_steps=i32, mu=i32,
                  nf=i32, mf=i32)
    if lanes:
        arrays.update(active=(level != INT_MAX).any(axis=-1),
                      used_td=np.int32(0), used_bu=np.int32(0), bu_hub=flag,
                      bu_steps_hub=i32, mu_hub=i32, nf_hub=i32, mf_hub=i32,
                      used_td_hub=np.int32(0), used_bu_hub=np.int32(0))
    return arrays


def _reached(shape, share, seed):
    """parent/level with `share` of the entries reached, INT_MAX elsewhere."""
    rng = np.random.default_rng(seed)
    hit = rng.random(shape) < share
    parent = np.where(hit, rng.integers(0, V, shape), INT_MAX)
    level = np.where(hit, rng.integers(0, V, shape), INT_MAX)
    return parent.astype(np.int32), level.astype(np.int32)


def _bfs_state():
    return _reached((V,), 0.5, 1)


def _pad_lane():
    parent, level = _reached((B, V), 0.6, 2)
    parent[-1] = level[-1] = INT_MAX
    return parent, level


def _no_sentinel():
    return _reached((B, V), 1.0, 3)


def _only_sentinels():
    return _reached((B, V), 0.0, 4)


def _ends():
    parent = np.full((B, V), INT_MAX, np.int32)
    level = np.full((B, V), INT_MAX, np.int32)
    parent[:, 0], level[:, 0] = 0, 0
    parent[:, V - 1], level[:, V - 1] = V - 1, 1
    return parent, level


CASES = {"bfs_state": _bfs_state, "batch_pad_lane": _pad_lane,
         "no_sentinel": _no_sentinel, "only_sentinels": _only_sentinels,
         "ends_0_and_v_minus_1": _ends}


@pytest.mark.parametrize("case", list(CASES))
def test_finalize_matches_reference(case):
    parent, level = CASES[case]()
    arrays = _state_arrays(parent, level)
    if parent.ndim == 1:
        st = interop.bfs_state_from_arrays(arrays, CPU)
        jst = JB.BFSState(*[jnp.asarray(arrays[f])
                            for f in TB.BFS_STATE_FIELDS])
    else:
        st = interop.batch_state_from_arrays(arrays, CPU)
        jst = JB.BatchState(*[jnp.asarray(arrays[f])
                              for f in TB.BATCH_STATE_FIELDS])
    want = JB.finalize(jst)
    got = TB.finalize(st)
    for g, w, src in zip(got, want, (parent, level)):
        assert isinstance(g, np.ndarray)
        assert g.dtype == np.int32 and g.shape == src.shape
        assert g.flags.c_contiguous and g.flags.writeable
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.where(src == INT_MAX, -1, src))
    # the state is left as it was: a second call gives the same answer
    np.testing.assert_array_equal(st.parent.numpy(), parent)
    np.testing.assert_array_equal(st.level.numpy(), level)
    for g, again in zip(got, TB.finalize(st)):
        np.testing.assert_array_equal(g, again)

"""The top-down push (`ops.topdown_push_batch`, `ops.topdown_push`) against
the JAX package's composite.

The reference's top-down step runs the Pallas visited-gather
(`jops.topdown_batch`, in interpret mode here), masks the destinations with
the split side's `dst_mask[dst]`, then scatter-mins the rows' ids into
`pcand` (`.at[:, dst].min(where(fresh, rows, INT_MAX))`). The port's push
does all of it in one call, in place on `pcand`. On the CPU the wrapper
runs its plain version; every output is an int32 min, so equality is
exact. Inputs are ELL-like (0-padded past each row's degree, vertex 0
unvisited so that a padding slot read by mistake would show) and made with
numpy from a seed. The CUDA kernel is held against its plain version by
the `cuda`-marked test, on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import Engine
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import topdown as ttd

INT_MAX = 2**31 - 1


def _push_case(seed, b, r, w, v, masked=0, targets=0, keep=False,
               seeded=False):
    """(deg [B, R], nbrs [R, W], rows [R], visited [B, V], pcand [B, V],
    keep [V] or None) as numpy. Each row has a true degree in 0..W (a
    quarter 0) and ids past it 0, as ELL pads; a lane holds the row's
    degree or 0 (not in its frontier), the last `masked` lanes hold 0
    everywhere. Real ids are 1 .. V + 1 (the top ones clipped), so vertex
    0 is named by padding slots alone. With `targets`, every id is one of
    `targets` vertices, all unvisited: many rows hit one vertex. Row ids
    are distinct, so each min has one winner. `seeded` starts `pcand` with
    ids already in some entries (earlier buckets of the level), else
    INT_MAX."""
    rng = np.random.default_rng(seed)
    true_deg = rng.integers(1, w + 1, r)
    true_deg[rng.random(r) < 0.25] = 0
    if targets:
        ids = rng.integers(1, targets + 1, (r, w))
    else:
        ids = rng.integers(1, v + 2, (r, w))               # clipped
    cols = np.arange(w)[None, :]
    nbrs = np.where(cols < true_deg[:, None], ids, 0).astype(np.int32)
    deg = np.where(rng.random((b, r)) < 0.6, true_deg[None], 0)
    if masked:
        deg[b - masked:] = 0
    deg = deg.astype(np.int32)
    rows = rng.permutation(max(v, r))[:r].astype(np.int32)
    visited = (rng.random((b, v)) < 0.4).astype(np.uint8)
    visited[:, 0] = 0                                     # padding target
    if targets:
        visited[:, 1:targets + 1] = 0
    pcand = np.full((b, v), INT_MAX, np.int32)
    if seeded:
        some = rng.random((b, v)) < 0.3
        pcand[some] = rng.integers(0, v, int(some.sum()))
    kp = (rng.random(v) < 0.5).astype(np.uint8) if keep else None
    return deg, nbrs, rows, visited, pcand, kp


def _jax_push(deg, nbrs, rows, visited, pcand, keep):
    """The reference's composite: one bucket of the batched top-down
    kernel step of `src/repro/core/bfs.py`."""
    v = visited.shape[1]
    fresh = jops.topdown_batch(jnp.asarray(deg), jnp.asarray(nbrs),
                               jnp.asarray(visited), interpret=True)
    dst = jnp.clip(jnp.asarray(nbrs), 0, v - 1)
    if keep is not None:
        dst_mask = jnp.asarray(keep) != 0
        fresh = fresh * dst_mask[dst][None].astype(fresh.dtype)
    src = jnp.broadcast_to(jnp.asarray(rows)[:, None], nbrs.shape)
    return np.asarray(jnp.asarray(pcand).at[:, dst].min(
        jnp.where(fresh > 0, src[None], INT_MAX)))


def _t(x):
    return None if x is None else torch.from_numpy(x.copy())


# (B, R, W, V, masked lanes, targets, keep, seeded pcand, seed): B 1 and 8,
# masked lanes, W not a multiple of 32 and wider than one chunk, many
# rows into a few vertices, keep on and off, pcand from INT_MAX or seeded.
CASES = [(1, 40, 32, 97, 0, 0, False, False, 1),
         (8, 130, 40, 257, 3, 0, False, False, 2),
         (8, 130, 40, 257, 3, 0, True, True, 3),
         (1, 9, 300, 1000, 0, 0, True, False, 4),
         (8, 200, 32, 500, 1, 4, False, False, 5),
         (8, 200, 32, 500, 1, 4, True, True, 6),
         (1, 300, 64, 64, 0, 16, False, True, 7),
         (3, 7, 100, 40, 0, 0, False, True, 8)]


@pytest.mark.parametrize("b,r,w,v,masked,targets,keep,seeded,seed", CASES)
def test_push_matches_jax_composite(b, r, w, v, masked, targets, keep,
                                    seeded, seed):
    deg, nbrs, rows, vis, pcand, kp = _push_case(seed, b, r, w, v, masked,
                                                 targets, keep, seeded)
    want = _jax_push(deg, nbrs, rows, vis, pcand, kp)
    got = _t(pcand)
    ops.topdown_push_batch(_t(deg), _t(nbrs), _t(rows), _t(vis), got, _t(kp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != pcand).any()              # some slot was fresh
    np.testing.assert_array_equal(got[:, 0].numpy(), pcand[:, 0])  # padding
    if targets:                               # the winners are the least ids
        live = deg > 0
        for lane in range(b):
            for n in range(1, targets + 1):
                hit = (live[lane][:, None]
                       & (np.arange(w)[None] < deg[lane][:, None])
                       & (nbrs == n)).any(axis=1)
                if kp is None or kp[n]:
                    best = min([pcand[lane, n]] + list(rows[hit]))
                    assert got[lane, n] == best


@pytest.mark.parametrize("r,w,v,keep,seed",
                         [(40, 32, 97, False, 11), (9, 300, 1000, True, 12),
                          (300, 64, 64, False, 13)])
def test_single_lane_push_matches_jax_topdown(r, w, v, keep, seed):
    """The one-lane wrapper against the reference stepper's composite:
    `jops.topdown` (fresh, dst), then `.at[dst].min`."""
    deg, nbrs, rows, vis, pcand, kp = _push_case(seed, 1, r, w, v, 0, 0,
                                                 keep, True)
    fresh, dst = jops.topdown(jnp.asarray(deg[0]), jnp.asarray(nbrs),
                              jnp.asarray(vis[0]), interpret=True)
    if kp is not None:
        fresh = fresh * (jnp.asarray(kp) != 0)[dst].astype(fresh.dtype)
    src = jnp.broadcast_to(jnp.asarray(rows)[:, None], dst.shape)
    want = jnp.asarray(pcand[0]).at[dst].min(jnp.where(fresh > 0, src,
                                                       INT_MAX))
    got = _t(pcand[0])
    ops.topdown_push(_t(deg[0]), _t(nbrs), _t(rows), _t(vis[0]), got, _t(kp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_push_on_cpu_counts_no_launch_and_skips_empty_tiles(monkeypatch):
    """The launch counts have the push's keys; a CPU tensor runs the plain
    version (no build, no launch counted); an empty tile leaves `pcand` as
    it was."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached kernels._build")
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(_build, "function", refuse)
    assert {"topdown_push_batch", "topdown_push"} <= set(ops.LAUNCHES)
    before = dict(ops.LAUNCHES)
    deg, nbrs, rows, vis, pcand, kp = (_t(x) for x in _push_case(
        21, 2, 20, 32, 64, keep=True))
    ops.topdown_push_batch(deg, nbrs, rows, vis, pcand, kp)
    ops.topdown_push(deg[0], nbrs, rows, vis[0], pcand[0])
    z = torch.zeros
    for b, r in ((0, 5), (3, 0)):
        pc = torch.full((b, 50), 7, dtype=torch.int32)
        ops.topdown_push_batch(z((b, r), dtype=torch.int32),
                               z((r, 32), dtype=torch.int32),
                               z(r, dtype=torch.int32),
                               z((b, 50), dtype=torch.uint8), pc)
        assert (pc == 7).all()
    pc = torch.full((50,), 7, dtype=torch.int32)
    ops.topdown_push(z(0, dtype=torch.int32), z((0, 32), dtype=torch.int32),
                     z(0, dtype=torch.int32), z(50, dtype=torch.uint8), pc)
    assert (pc == 7).all()
    assert ops.LAUNCHES == before


def test_push_launcher_refuses_cpu_and_misfit_tensors():
    deg, nbrs, rows, vis, pcand, _ = (_t(x) for x in _push_case(
        22, 2, 8, 32, 40))
    with pytest.raises(ValueError, match="CUDA"):
        ttd.topdown_push_cuda(deg, nbrs, rows, vis, pcand)


def test_topdown_steps_write_pcand_only_through_the_push(monkeypatch):
    """Whole searches on every path (unsplit, split with mixed levels,
    Graph500 mode, stepper) push only through `ops.topdown_push_batch` /
    `ops.topdown_push`: no scatter_reduce_ outside them, no fresh entry
    called."""
    inside = [False]
    real_scatter = torch.Tensor.scatter_reduce_

    def guarded(self, *a, **k):
        assert inside[0], "scatter_reduce_ outside the push wrapper"
        return real_scatter(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", guarded)
    pushes = {}
    for name in ("topdown_push_batch", "topdown_push"):
        def wrapped(*a, _real=getattr(ops, name), _name=name, **k):
            pushes[_name] = pushes.get(_name, 0) + 1
            inside[0] = True
            try:
                return _real(*a, **k)
            finally:
                inside[0] = False
        monkeypatch.setattr(ops, name, wrapped)
    for name in ("topdown_batch", "topdown"):
        monkeypatch.setattr(ops, name, lambda *a, **k: pytest.fail(
            "a step called the fresh entry"))
    g = TG.rmat(9, seed=3)
    eng = Engine(g, device="cpu")
    roots = [int(np.argmax(g.degrees)), 0, 7, 123]
    eng.bfs(roots, validate=True)
    res = eng.bfs(roots, TB.BFSConfig(heuristic="beamer", hub_split=True,
                                      hub_deg=64), validate=True)
    assert any(r["direction"] == "mixed" for r in res.batch_level_stats)
    eng.bfs(roots[:2], batched=False, validate=True)
    eng.bfs(roots[:2], backend="stepper", validate=True)
    assert pushes["topdown_push_batch"] > 0 and pushes["topdown_push"] > 0


@pytest.mark.cuda
def test_push_kernel_matches_plain_on_cuda():
    """On a card: the push kernel against its plain version, bitwise, for
    B 1, 8, 16 and 40 (three lane groups), keep on and off, seeded pcand,
    many rows into a few vertices; each wrapper call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    cases = CASES + [(16, 3000, 32, 5000, 2, 0, True, True, 31),
                     (40, 500, 96, 3000, 5, 0, False, True, 32),
                     (8, 100000, 32, 4096, 0, 16, False, False, 33),
                     (8, 6, 70000, 100000, 1, 0, True, False, 34)]
    for b, r, w, v, masked, targets, keep, seeded, seed in cases:
        deg, nbrs, rows, vis, pcand, kp = (
            None if x is None else torch.from_numpy(x).to(dev)
            for x in _push_case(seed, b, r, w, v, masked, targets, keep,
                                seeded))
        n = dict(ops.LAUNCHES)
        got, want = pcand.clone(), pcand.clone()
        ops.topdown_push_batch(deg, nbrs, rows, vis, got, kp)
        ttd.topdown_push_batch_plain(deg, nbrs, rows, vis, want, kp)
        assert torch.equal(got, want), (b, r, w, v, seed)
        got1, want1 = pcand[0].clone(), pcand[0].clone()
        ops.topdown_push(deg[0], nbrs, rows, vis[0], got1, kp)
        ttd.topdown_push_plain(deg[0], nbrs, rows, vis[0], want1, kp)
        assert torch.equal(got1, want1), (b, r, w, v, seed)
        assert ops.LAUNCHES["topdown_push_batch"] == \
            n["topdown_push_batch"] + 1
        assert ops.LAUNCHES["topdown_push"] == n["topdown_push"] + 1
    torch.cuda.synchronize()

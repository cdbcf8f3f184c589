"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU, `repro_torch.kernels.ops` runs each kernel's plain PyTorch
version; the JAX side runs the Pallas kernels in interpret mode. Inputs are
made with numpy from a seed and every output is an integer, so equality is
exact. The CUDA kernels themselves are checked on the card
(`chip_smoke.py` and the `cuda`-marked test below).
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import _build
from repro_torch.kernels import bottomup as tbu
from repro_torch.kernels import frontier_fused as tff
from repro_torch.kernels import hub as thub
from repro_torch.kernels import ops
from repro_torch.kernels import topdown as ttd


def _inputs(seed, b, r, w, v, masked=0, p_deg0=0.25, density=0.1):
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, w + 1, (b, r)).astype(np.int32)
    deg[rng.random((b, r)) < p_deg0] = 0           # degree-0 rows
    if masked:
        deg[b - masked:] = 0                       # lanes out of the cohort
    nbrs = rng.integers(-2, v + 2, (r, w)).astype(np.int32)   # clipped ids
    table = (rng.random((b, v)) < density).astype(np.uint8)
    return deg, nbrs, table


def _eq(mine, ref):
    mine = mine.numpy()
    ref = np.asarray(ref)
    assert mine.dtype == ref.dtype, (mine.dtype, ref.dtype)
    np.testing.assert_array_equal(mine, ref)


# (B, R, W, V, masked lanes, slab): ragged R and V, masked lanes, W not a
# multiple of the slab, B = 1.
SHAPES = [(1, 5, 32, 37, 0, 32), (8, 130, 40, 257, 3, 32),
          (3, 9, 96, 100, 1, 32), (2, 64, 33, 1000, 0, 8)]


@pytest.mark.parametrize("b,r,w,v,masked,slab", SHAPES)
def test_bottomup_batch_matches_pallas(b, r, w, v, masked, slab):
    deg, nbrs, fr = _inputs(r * 31 + w, b, r, w, v, masked)
    f1, p1 = ops.bottomup_batch(torch.from_numpy(deg), torch.from_numpy(nbrs),
                                torch.from_numpy(fr), slab=slab)
    f2, p2 = jops.bottomup_batch(jnp.asarray(deg), jnp.asarray(nbrs),
                                 jnp.asarray(fr), slab=slab, interpret=True)
    _eq(f1, f2)
    _eq(p1, p2)
    assert f1.sum() > 0                       # some rows found a parent


def _first_hits(seed, b, r, w, slots):
    """A pull case whose first hits are set: lane l of row i first hits at
    slot `slots[(l + i) % len(slots)]` (None: no hit), with later hits
    after it and a hit past the degree that must not count. Ids are
    distinct (V = R * W + 64), so one row's frontier bits do not reach
    another row; the degree is W or random above the first hit."""
    rng = np.random.default_rng(seed)
    v = r * w + 64
    nbrs = (1 + rng.permutation(r * w)).reshape(r, w).astype(np.int32)
    deg = np.zeros((b, r), np.int32)
    fr = np.zeros((b, v), np.uint8)
    fr[:, r * w + 1:] = rng.random((b, 63)) < 0.5       # not in any row
    for lane in range(b):
        for i in range(r):
            s = slots[(lane + i) % len(slots)]
            lo = 1 if s is None else s + 1
            d = w if rng.random() < 0.5 else int(rng.integers(lo, w + 1))
            deg[lane, i] = d
            if s is not None:
                fr[lane, nbrs[i, s]] = 1
                later = rng.integers(s, w, 3)
                fr[lane, nbrs[i, later]] = 1
            if d < w:
                fr[lane, nbrs[i, d]] = 1                # past the degree
    return deg, nbrs, fr


# (B, R, W, first-hit slots, seed): lanes of one row hitting at different
# slots (slot 0 in one, W - 1 in another), deg == W, W of 33, 40 and 96
# (chunks and groups that do not divide W), B = 16 and B = 3; hub widths
# with first hits past the first chunk (128), past the warp phase (256)
# and at the last slot.
NARROW_SLOTS = [0, -1, None, 1, 3, 4, 16]
HUB_SLOTS = [0, -1, None, 127, 128, 255, 256, 700]
FIRST_HIT_CASES = [(8, 40, 32, NARROW_SLOTS, 1), (3, 17, 33, NARROW_SLOTS, 2),
                   (16, 50, 40, NARROW_SLOTS, 3), (8, 30, 96, NARROW_SLOTS, 4),
                   (1, 20, 32, NARROW_SLOTS, 5), (16, 9, 64, NARROW_SLOTS, 6),
                   (8, 6, 1024, HUB_SLOTS, 7), (16, 5, 300, HUB_SLOTS, 8),
                   (1, 4, 520, HUB_SLOTS, 9), (3, 7, 2048, HUB_SLOTS, 10)]


def _first_hit_case(b, r, w, slots, seed):
    """(deg, nbrs, frontier, first-hit slot per (lane, row)), slot -1 (or
    one past the row) being the row's last."""
    slots = [s if s is None else w - 1 if s == -1 else min(s, w - 1)
             for s in slots]
    first = {(lane, i): slots[(lane + i) % len(slots)]
             for lane in range(b) for i in range(r)}
    return (*_first_hits(seed, b, r, w, slots), first)


@pytest.mark.parametrize("kernel", ["bottomup_batch", "hub_bottomup_batch"])
@pytest.mark.parametrize("b,r,w,slots,seed", FIRST_HIT_CASES)
def test_pull_first_hits_match_pallas(kernel, b, r, w, slots, seed):
    """The two pull scans against the JAX package's Pallas kernels on rows
    whose first hits are set: found and the parent at the lowest hitting
    slot, the degree masking a later hit."""
    deg, nbrs, fr, first = _first_hit_case(b, r, w, slots, seed)
    f1, p1 = getattr(ops, kernel)(torch.from_numpy(deg),
                                  torch.from_numpy(nbrs), torch.from_numpy(fr))
    f2, p2 = getattr(jops, kernel)(jnp.asarray(deg), jnp.asarray(nbrs),
                                   jnp.asarray(fr), interpret=True)
    _eq(f1, f2)
    _eq(p1, p2)
    for (lane, i), s in first.items():
        if s is None:
            assert (f1[lane, i], p1[lane, i]) == (0, 2**31 - 1)
        else:
            assert (f1[lane, i], p1[lane, i]) == (1, nbrs[i, s])


@pytest.mark.parametrize("b,r,w,v,masked,slab", SHAPES)
def test_topdown_batch_matches_pallas(b, r, w, v, masked, slab):
    deg, nbrs, vis = _inputs(r * 17 + w, b, r, w, v, masked, density=0.5)
    f1 = ops.topdown_batch(torch.from_numpy(deg), torch.from_numpy(nbrs),
                           torch.from_numpy(vis))
    f2 = jops.topdown_batch(jnp.asarray(deg), jnp.asarray(nbrs),
                            jnp.asarray(vis), interpret=True)
    _eq(f1, f2)


def test_empty_tiles_return_empty_outputs():
    z = torch.zeros
    for b, r in ((0, 5), (3, 0), (0, 0)):
        found, parent = ops.bottomup_batch(z((b, r), dtype=torch.int32),
                                           z((r, 32), dtype=torch.int32),
                                           z((b, 50), dtype=torch.uint8))
        assert found.shape == parent.shape == (b, 0)
        assert (found.dtype, parent.dtype) == (torch.uint8, torch.int32)
        fresh = ops.topdown_batch(z((b, r), dtype=torch.int32),
                                  z((r, 32), dtype=torch.int32),
                                  z((b, 50), dtype=torch.uint8))
        assert fresh.shape == (b, r, 32) and fresh.dtype == torch.uint8
        jf = jops.topdown_batch(jnp.zeros((b, r), jnp.int32),
                                jnp.zeros((r, 32), jnp.int32),
                                jnp.zeros((b, 50), jnp.uint8), interpret=True)
        assert tuple(jf.shape) == tuple(fresh.shape)
    packed, nf, mf = ops.frontier_fused_batch(z((0, 40), dtype=torch.uint8),
                                              z(40, dtype=torch.int32))
    assert packed.shape == (0, 0) and nf.shape == mf.shape == (0,)
    packed, nf, mf = ops.frontier_fused_batch(z((2, 0), dtype=torch.uint8),
                                              z(0, dtype=torch.int32))
    assert packed.shape == (2, 0) and nf.tolist() == mf.tolist() == [0, 0]


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """A CPU tensor runs the plain version: no nvcc, no library, no launch
    counted."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached kernels._build")
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "function", refuse)
    monkeypatch.setattr(_build, "launch", refuse)
    before = dict(ops.LAUNCHES)
    deg, nbrs, fr = _inputs(0, 2, 20, 32, 64)
    ops.bottomup_batch(torch.from_numpy(deg), torch.from_numpy(nbrs),
                       torch.from_numpy(fr))
    ops.topdown_batch(torch.from_numpy(deg), torch.from_numpy(nbrs),
                      torch.from_numpy(fr))
    ops.frontier_fused_batch(torch.from_numpy(fr),
                             torch.arange(64, dtype=torch.int32))
    ops.hub_bottomup_batch(torch.from_numpy(deg), torch.from_numpy(nbrs),
                           torch.from_numpy(fr))
    d0, t0 = torch.from_numpy(deg[0]), torch.from_numpy(fr[0])
    ops.bottomup(d0, torch.from_numpy(nbrs), t0)
    ops.hub_bottomup(d0, torch.from_numpy(nbrs), t0)
    ops.topdown(d0, torch.from_numpy(nbrs), t0)
    ops.frontier_fused(t0, torch.arange(64, dtype=torch.int32))
    assert ops.LAUNCHES == before


def test_launchers_refuse_cpu_tensors():
    """The CUDA launchers take CUDA tensors only: no silent plain path."""
    deg, nbrs, fr = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 32, 40))
    with pytest.raises(ValueError, match="CUDA"):
        tbu.bottomup_batch_cuda(deg, nbrs, fr)
    with pytest.raises(ValueError, match="CUDA"):
        ttd.topdown_batch_cuda(deg, nbrs, fr)
    with pytest.raises(ValueError, match="CUDA"):
        tff.frontier_fused_batch_cuda(fr, torch.zeros(40, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        thub.hub_bottomup_batch_cuda(deg, nbrs, fr)
    with pytest.raises(ValueError, match="CUDA"):
        ttd.topdown_cuda(deg[0], nbrs, fr[0])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    # library names follow the source hash, so an edited source rebuilds
    paths = {_build.library_path(n) for n in _build.SOURCES}
    assert len(paths) == len(_build.SOURCES)
    assert all(p.parent == tmp_path / "build" for p in paths)


def test_concurrent_builds_run_one_compiler_per_source(monkeypatch, tmp_path):
    """Two threads building at once: each source compiles once, and every
    library lands whole (no two compilers share a temporary file)."""
    calls = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "sleep 0.2\n"
        "while [ \"$1\" != -o ]; do shift; done\n"
        "echo built > \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    threads = [threading.Thread(target=_build.build_all) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls.read_text().splitlines()) == len(_build.SOURCES)
    for n in _build.SOURCES:
        assert _build.library_path(n).read_text() == "built\n"


def _frontier_vs_plain(flags, deg):
    """The packing kernel against its plain version, both stores, batched
    and on lane 0, bitwise (the bitmap as int32)."""
    for packed in (True, False):
        for got, want in (
                (ops.frontier_fused_batch(flags, deg, packed=packed),
                 tff.frontier_fused_batch_plain(flags, deg, packed=packed)),
                (ops.frontier_fused(flags[0], deg, packed=packed),
                 tff.frontier_fused_plain(flags[0], deg, packed=packed))):
            for x, y in zip(got, want):
                if x is None or y is None:
                    assert x is None and y is None and not packed
                    continue
                if x.dtype == torch.uint32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                assert x.shape == y.shape and torch.equal(x, y), \
                    (tuple(flags.shape), flags.stride(), packed)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """On a card: every kernel against its plain version, bitwise, through
    the batched wrappers and the single-lane ones (lane 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    # the last two with rows enough for the packed frontier (R * 16 >= V)
    for b, r, w, v, masked, _ in SHAPES + [(8, 7, 4096, 5000, 2, 32),
                                           (8, 20000, 32, 5000, 2, 32),
                                           (16, 20000, 40, 3000, 3, 32)]:
        deg, nbrs, table = (torch.from_numpy(x).to(dev)
                            for x in _inputs(r + w, b, r, w, v, masked))
        n = dict(ops.LAUNCHES)
        f1, p1 = ops.bottomup_batch(deg, nbrs, table)
        f2, p2 = tbu.bottomup_batch_plain(deg, nbrs, table)
        assert torch.equal(f1, f2) and torch.equal(p1, p2)
        f1, p1 = ops.hub_bottomup_batch(deg, nbrs, table)
        f2, p2 = thub.hub_bottomup_batch_plain(deg, nbrs, table)
        assert torch.equal(f1, f2) and torch.equal(p1, p2)
        assert torch.equal(ops.topdown_batch(deg, nbrs, table),
                           ttd.topdown_batch_plain(deg, nbrs, table))
        rows = torch.randperm(max(r, v), device=dev)[:r].to(torch.int32)
        pc = torch.full((b, v), 2**31 - 1, dtype=torch.int32, device=dev)
        got, want = pc.clone(), pc.clone()
        ops.topdown_push_batch(deg, nbrs, rows, table, got)
        ttd.topdown_push_batch_plain(deg, nbrs, rows, table, want)
        assert torch.equal(got, want)
        got, want = pc[0].clone(), pc[0].clone()
        ops.topdown_push(deg[0], nbrs, rows, table[0], got)
        ttd.topdown_push_plain(deg[0], nbrs, rows, table[0], want)
        assert torch.equal(got, want)
        vdeg = torch.arange(v, dtype=torch.int32, device=dev)
        a = ops.frontier_fused_batch(table, vdeg)
        p = tff.frontier_fused_batch_plain(table, vdeg)
        assert torch.equal(a[0].view(torch.int32), p[0].view(torch.int32))
        assert torch.equal(a[1], p[1]) and torch.equal(a[2], p[2])
        d0, t0 = deg[0], table[0]
        for got, want in (
                (ops.bottomup(d0, nbrs, t0), tbu.bottomup_plain(d0, nbrs, t0)),
                (ops.hub_bottomup(d0, nbrs, t0),
                 thub.hub_bottomup_plain(d0, nbrs, t0)),
                (ops.topdown(d0, nbrs, t0), ttd.topdown_plain(d0, nbrs, t0)),
                (ops.frontier_fused(t0, vdeg),
                 tff.frontier_fused_plain(t0, vdeg))):
            for x, y in zip(got, want):
                if x.dtype == torch.uint32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                assert x.shape == y.shape and torch.equal(x, y)
        assert all(ops.LAUNCHES[k] == n[k] + 1 for k in n
                   if k != "decode_attention")
    # the packing kernel with the bitmap and without, batched and on lane
    # 0: ragged V, B up to 40 with an empty last lane, rows that start one
    # byte in (flags[:, 1:]) with degrees one int32 in, all flags set, and
    # mf at the int32 limit and one past it
    rng = np.random.default_rng(7)
    for b in (1, 3, 8, 16, 40):
        for v in (1, 31, 37, 4096, 10000):
            wide = (rng.random((b, v + 1)) < 0.3).astype(np.uint8)
            wide[b - 1] = 0
            wide = torch.from_numpy(wide).to(dev)
            vd = torch.from_numpy(
                rng.integers(0, 5000, v + 1).astype(np.int32)).to(dev)
            for flags, d in ((wide[:, :v].contiguous(), vd[:v]),
                             (wide[:, 1:], vd[1:]),
                             (torch.ones_like(wide[:, :v]), vd[:v])):
                _frontier_vs_plain(flags, d)
    for total in (2**31 - 1, 2**31):
        d = np.full(4096, total // 4096, np.int64)
        d[0] += total - int(d.sum())
        _frontier_vs_plain(
            torch.ones((2, 4096), dtype=torch.uint8, device=dev),
            torch.from_numpy(d.astype(np.int32)).to(dev))
    # the first-hit cases, through both pull kernels and their one-lane
    # launches
    for case in FIRST_HIT_CASES:
        deg, nbrs, table = (torch.from_numpy(x).to(dev)
                            for x in _first_hit_case(*case)[:3])
        for batch, one, plain in (
                (ops.bottomup_batch, ops.bottomup, tbu.bottomup_batch_plain),
                (ops.hub_bottomup_batch, ops.hub_bottomup,
                 thub.hub_bottomup_batch_plain)):
            f1, p1 = batch(deg, nbrs, table)
            f2, p2 = plain(deg, nbrs, table)
            assert torch.equal(f1, f2) and torch.equal(p1, p2), case
            f1, p1 = one(deg[0], nbrs, table[0])
            assert torch.equal(f1, f2[0]) and torch.equal(p1, p2[0]), case

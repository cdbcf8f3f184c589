"""The port's decode attention against the JAX package's Pallas kernel.

On the CPU, `repro_torch.kernels.ops.decode_attention` runs the plain
PyTorch version; the JAX side runs `decode_attention_pallas` in interpret
mode (through its `ops` wrapper) and its oracle `decode_attention_ref`.
Inputs are made with numpy from a seed. Tolerances: fp32 rtol/atol 3e-5
(the looser of the JAX kernel tests' own, for sums taken in another
order); bf16 rtol 2^-7 and atol 1e-5 per element after casting both to
fp32 (one bf16 step of the value: both sides round the same fp32 sum, up
to its order, and may round a value near a tie apart).

Standard normal q and k give scores near N(0, 1), where 50 tanh(s / 50)
differs from s by about 1e-4: the soft cap is only seen with q scaled by
`CAP_SCALE`, so that scores reach the cap; there the capped and uncapped
outputs differ by far more than the tolerance.

The CUDA kernel is checked against the plain version on the card (the
`cuda`-marked test below, and `chip_smoke.py`); its split of S across
blocks (`split_plan`) is pure Python and is checked here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from hypothesis_fallback import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import ops

F32_TOL = 3e-5
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-5
CAP_SCALE = 30.0


def _inputs(seed, b, s, k, g, h, clen=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, k, g, h)).astype(np.float32)
    kc = rng.standard_normal((b, s, k, h)).astype(np.float32)
    vc = rng.standard_normal((b, s, k, h)).astype(np.float32)
    if clen is None:
        clen = rng.integers(1, s + 1, b)
    return q, kc, vc, np.asarray(clen, np.int32)


def _port(q, kc, vc, clen, cap, dtype=torch.float32):
    return ops.decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kc).to(dtype),
        torch.from_numpy(vc).to(dtype), torch.from_numpy(clen),
        logit_cap=cap)


def _pallas(q, kc, vc, clen, cap, blk=256, dtype=jnp.float32):
    return jops.decode_attention(
        jnp.asarray(q, dtype), jnp.asarray(kc, dtype), jnp.asarray(vc, dtype),
        jnp.asarray(clen), blk=blk, logit_cap=cap, interpret=True)


def _close(mine, ref, tol):
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _close_bf16(mine, ref):
    np.testing.assert_allclose(mine.float().numpy(),
                               np.asarray(ref, np.float32), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


# The JAX kernel tests' sweep, plus gemma2-9b's decode shape at its soft
# cap (S = the serve run's context, 4,200 + 32, not a multiple of blk).
SWEEP = [(2, 1024, 4, 2, 64, 0.0), (3, 700, 2, 5, 32, 50.0),
         (1, 64, 1, 1, 16, 0.0), (2, 4232, 8, 2, 256, 50.0)]


@pytest.mark.parametrize("b,s,k,g,h,cap", SWEEP)
def test_decode_attention_matches_pallas_and_oracle(b, s, k, g, h, cap):
    q, kc, vc, clen = _inputs(b * 100 + s, b, s, k, g, h)
    if s == 4232:
        clen = np.array([s, 4096], np.int32)    # the global and local lengths
    mine = _port(q, kc, vc, clen, cap)
    assert mine.shape == (b, k, g, h) and mine.dtype == torch.float32
    _close(mine, _pallas(q, kc, vc, clen, cap, blk=512), F32_TOL)
    _close(mine, jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        logit_cap=cap), F32_TOL)


@pytest.mark.parametrize("b,s,k,g,h,cap", SWEEP[:3])
def test_decode_attention_bf16_matches_pallas(b, s, k, g, h, cap):
    q, kc, vc, clen = _inputs(b * 7 + s, b, s, k, g, h)
    mine = _port(q, kc, vc, clen, cap, dtype=torch.bfloat16)
    assert mine.dtype == torch.bfloat16
    _close_bf16(mine, _pallas(q, kc, vc, clen, cap, dtype=jnp.bfloat16))


@pytest.mark.parametrize("b,s,k,g,h", [c[:5] for c in SWEEP])
def test_soft_cap_bites_and_matches_pallas(b, s, k, g, h):
    """q scaled so that scores reach the cap of 50: the port's cap-50
    output matches the Pallas kernel and the oracle (fp32) and the kernel
    (bf16), and is far from its own cap-0 output."""
    q, kc, vc, clen = _inputs(b * 31 + s, b, s, k, g, h, clen=[s] * b)
    q = q * CAP_SCALE
    mine = _port(q, kc, vc, clen, 50.0)
    _close(mine, _pallas(q, kc, vc, clen, 50.0, blk=512), F32_TOL)
    _close(mine, jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        logit_cap=50.0), F32_TOL)
    _close_bf16(_port(q, kc, vc, clen, 50.0, dtype=torch.bfloat16),
                _pallas(q, kc, vc, clen, 50.0, blk=512, dtype=jnp.bfloat16))
    uncapped = _port(q, kc, vc, clen, 0.0)
    assert float((mine - uncapped).abs().max()) > 1000 * F32_TOL


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=8, deadline=None)
def test_decode_attention_property(seed):
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 4))
    s = int(rng.integers(4, 300))
    k = int(rng.integers(1, 4))
    g = int(rng.integers(1, 4))
    h = int(rng.choice([8, 16, 32]))
    cap = float(rng.choice([0.0, 50.0]))
    q, kc, vc, clen = _inputs(seed, b, s, k, g, h)
    mine = _port(q, kc, vc, clen, cap)
    _close(mine, _pallas(q, kc, vc, clen, cap, blk=64), F32_TOL)
    _close(mine, jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        logit_cap=cap), F32_TOL)


def test_cache_len_zero_gives_zeros_like_the_kernel():
    """A row with no valid position: zeros in the Pallas kernel and in the
    port; the JAX package's jnp oracle gives the mean of V there instead
    (a softmax over all -1e30 is uniform), which is why the port follows
    the kernel. The model never passes 0: cache_len = min(pos + 1, wc)."""
    q, kc, vc, _ = _inputs(5, 3, 40, 2, 2, 16)
    clen = np.array([0, 17, 0], np.int32)
    mine = _port(q, kc, vc, clen, 50.0)
    pallas = np.asarray(_pallas(q, kc, vc, clen, 50.0, blk=8))
    assert np.all(pallas[[0, 2]] == 0) and np.all(mine[[0, 2]].numpy() == 0)
    _close(mine, pallas, F32_TOL)
    oracle = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen),
        logit_cap=50.0))
    np.testing.assert_allclose(oracle[0], np.broadcast_to(
        vc[0].mean(axis=0)[:, None], oracle[0].shape), rtol=1e-5, atol=1e-5)


def test_cache_len_past_s_and_empty_inputs():
    """cache_len above S reads the whole cache; an empty batch or cache
    returns zeros without a launch."""
    q, kc, vc, _ = _inputs(9, 2, 30, 1, 3, 8)
    full = _port(q, kc, vc, np.array([30, 30], np.int32), 0.0)
    assert torch.equal(_port(q, kc, vc, np.array([99, 30], np.int32), 0.0),
                       full)
    before = dict(ops.LAUNCHES)
    z = ops.decode_attention(torch.zeros(0, 1, 3, 8), torch.zeros(0, 30, 1, 8),
                             torch.zeros(0, 30, 1, 8),
                             torch.zeros(0, dtype=torch.int32))
    assert z.shape == (0, 1, 3, 8)
    z = ops.decode_attention(torch.ones(2, 1, 3, 8), torch.zeros(2, 0, 1, 8),
                             torch.zeros(2, 0, 1, 8),
                             torch.ones(2, dtype=torch.int32))
    assert z.shape == (2, 1, 3, 8) and not z.any()
    assert ops.LAUNCHES == before


def test_launcher_refuses_cpu_tensors_and_plain_counts_nothing():
    q, kc, vc, clen = (torch.from_numpy(x)
                       for x in _inputs(2, 1, 16, 1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_cuda(q, kc, vc, clen)
    with pytest.raises(ValueError, match="takes"):
        tda.decode_attention_cuda(q.double(), kc, vc, clen)
    before = ops.LAUNCHES["decode_attention"]
    ops.decode_attention(q, kc, vc, clen)
    assert ops.LAUNCHES["decode_attention"] == before


H100_SMS = 132
# Blocks of the kernel one H100 SM holds at once (bf16), as the launcher's
# `resident_blocks` reads them from the occupancy calculator there
# (`chip_smoke.py` phase 6 prints them): gemma2-9b (g 2, h 256), yi-9b
# (g 8, h 128), stablelm-3b (g 1, h 80).
H100_RESIDENT = {(8, 2, 256): 2, (4, 8, 128): 2, (32, 1, 80): 4}
# (B, K, S): gemma2-9b's, yi-9b's and stablelm-3b's serve shapes, then
# small and ragged ones.
PLAN_SHAPES = [(4, 8, 4232), (4, 4, 4232), (2, 32, 4232), (1, 1, 1),
               (4, 8, 1), (2, 2, 1000), (1, 2, 333), (3, 2, 700),
               (128, 8, 32768), (1, 1, 100000), (65535, 1, 64)]


@pytest.mark.parametrize("b,k,s", PLAN_SHAPES)
def test_split_plan_covers_s_in_whole_tiles(b, k, s):
    """For any number of blocks an SM holds: every position in exactly one
    split, 1 <= nsplit <= ceil(S / tile) and <= the kernel's limit,
    split_len a whole number of tiles, the splits cover S and none of them
    is empty by shape; the same shapes give the same plan (the launch shape
    depends on nothing else); with enough work, no more blocks than the
    SMs hold at once, so none waits for a second round."""
    tiles = -(-s // tda.TILE)
    for resident in (1, 2, 3, 8):
        nsplit, split_len = tda.split_plan(b, k, s, H100_SMS, resident)
        assert 1 <= nsplit <= min(tiles, tda.MAX_SPLITS)
        assert split_len % tda.TILE == 0 and split_len >= tda.TILE
        assert nsplit * split_len >= s > (nsplit - 1) * split_len
        assert tda.split_plan(b, k, s, H100_SMS, resident) == (nsplit,
                                                                split_len)
        if b * k * tiles >= resident * H100_SMS:
            assert b * k * nsplit <= max(b * k, resident * H100_SMS)


def test_split_plan_fills_the_card_at_the_serve_shapes():
    """gemma2-9b's decode (B 4, K 8, S 4,232, two blocks per SM): 8 splits
    of 544 positions, 256 blocks, nearly two on each of the 132 SMs;
    yi-9b's and stablelm-3b's shapes fill what their SMs hold the same way
    (over three quarters of it, all in one round). S = 4,232 is not a
    multiple of the split length, so the last split is short."""
    assert tda.split_plan(4, 8, 4232, H100_SMS, 2) == (8, 544)
    for (k, g, h), resident in H100_RESIDENT.items():
        b = 2 if k == 32 else 4
        nsplit, split_len = tda.split_plan(b, k, 4232, H100_SMS, resident)
        blocks = b * k * nsplit
        assert 0.75 * resident * H100_SMS < blocks <= resident * H100_SMS
        assert 4232 % split_len != 0
    # fewer SMs, or fewer blocks on each, take fewer splits
    assert tda.split_plan(4, 8, 4232, 66, 2)[0] < 8
    assert tda.split_plan(4, 8, 4232, H100_SMS, 1)[0] < 8


# (B, S, K, g, h, cap) the kernel sweep adds on the card: yi-9b's and
# stablelm-3b's decode shapes, g = 16 (the most one block takes), rows of
# 40 bytes (bf16; no 16-byte copies), S not a multiple of the split length.
CUDA_EXTRA = [(1, 1, 1, 1, 8, 0.0), (2, 100, 3, 9, 100, 50.0),
              (4, 4232, 4, 8, 128, 0.0), (2, 4232, 32, 1, 80, 50.0),
              (1, 333, 2, 16, 256, 50.0), (3, 77, 2, 3, 20, 0.0)]


@pytest.mark.cuda
def test_decode_attention_kernel_matches_plain_on_cuda():
    """On a card: the kernel through `ops` against the plain version on the
    same CUDA tensors, fp32 and bf16, capped and not, for three sets of
    cache_len: the first row 0 and the rest random in 1..S; every row 1
    (every split but the first empty); every row random in 2..S-1 (a
    length that ends inside a split). A second call on the same inputs
    gives the same bits. Then with q scaled to reach the cap, where the
    kernel's cap-50 output matches the plain one and is far from its cap-0
    output. Last, caches that start 2 bytes past a 16-byte boundary. Each
    call also with the lse: the same output unrounded (fp32) and the lse
    against the plain one within the fp32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    tols = {torch.float32: (F32_TOL, F32_TOL),
            torch.bfloat16: (BF16_RTOL, BF16_ATOL)}
    for b, s, k, g, h, cap in SWEEP + CUDA_EXTRA:
        q, kc, vc, clen = _inputs(s + h, b, s, k, g, h)
        clen[0] = 0
        lens_sets = [clen, np.ones(b, np.int32)]
        if s > 2:
            lens_sets.append(np.random.default_rng(s + h).integers(
                2, s, b).astype(np.int32))
        for dtype, (rtol, atol) in tols.items():
            args = [torch.from_numpy(x).to(dev, dtype) for x in (q, kc, vc)]
            for lens_np in lens_sets:
                lens = torch.from_numpy(lens_np).to(dev)
                n = ops.LAUNCHES["decode_attention"]
                got = ops.decode_attention(*args, lens, logit_cap=cap)
                want = tda.decode_attention_plain(*args, lens, logit_cap=cap)
                torch.cuda.synchronize()
                assert ops.LAUNCHES["decode_attention"] == n + 1
                assert got.dtype == dtype
                assert lens_np[0] > 0 or not got[0].any()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=rtol, atol=atol)
                assert torch.equal(ops.decode_attention(*args, lens,
                                                        logit_cap=cap), got)
                # with the lse: the same value unrounded, the lse within
                # the fp32 tolerance (-inf at cache_len 0)
                o32, lse = ops.decode_attention(*args, lens, logit_cap=cap,
                                                return_lse=True)
                _, want_lse = tda.decode_attention_plain(
                    *args, lens, logit_cap=cap, return_lse=True)
                assert o32.dtype == torch.float32
                assert torch.equal(o32.to(dtype), got)
                empty = (lens <= 0)[:, None, None].expand_as(lse)
                assert bool(torch.isneginf(lse[empty]).all())
                torch.testing.assert_close(lse[~empty], want_lse[~empty],
                                           rtol=F32_TOL, atol=F32_TOL)
            if s > 1:
                args[0] = args[0] * CAP_SCALE
                lens.fill_(s)
                got = ops.decode_attention(*args, lens, logit_cap=50.0)
                want = tda.decode_attention_plain(*args, lens, logit_cap=50.0)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=rtol, atol=atol)
                uncapped = ops.decode_attention(*args, lens)
                assert float((got.float() - uncapped.float()).abs().max()) \
                    > 1000 * F32_TOL
    b, s, k, g, h = 2, 300, 2, 2, 64
    q, kc, vc, _ = _inputs(7, b, s, k, g, h)
    buf = torch.zeros(2 * kc.size + 2, dtype=torch.bfloat16, device=dev)
    kt = buf[1:1 + kc.size].view(kc.shape)
    vt = buf[1 + kc.size:1 + 2 * kc.size].view(vc.shape)
    kt.copy_(torch.from_numpy(kc)), vt.copy_(torch.from_numpy(vc))
    args = (torch.from_numpy(q).to(dev, torch.bfloat16), kt, vt,
            torch.tensor([s, 123], dtype=torch.int32, device=dev))
    torch.testing.assert_close(
        ops.decode_attention(*args, logit_cap=50.0).float(),
        tda.decode_attention_plain(*args, logit_cap=50.0).float(),
        rtol=BF16_RTOL, atol=BF16_ATOL)

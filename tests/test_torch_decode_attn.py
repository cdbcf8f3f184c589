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
`cuda`-marked test below, and `chip_smoke.py`).
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


@pytest.mark.cuda
def test_decode_attention_kernel_matches_plain_on_cuda():
    """On a card: the kernel through `ops` against the plain version on the
    same CUDA tensors, fp32 and bf16, capped and not, cache_len 0 to S;
    then with q scaled to reach the cap, where the kernel's cap-50 output
    matches the plain one and is far from its cap-0 output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    dev = torch.device("cuda")
    tols = {torch.float32: (F32_TOL, F32_TOL),
            torch.bfloat16: (BF16_RTOL, BF16_ATOL)}
    for b, s, k, g, h, cap in SWEEP + [(1, 1, 1, 1, 8, 0.0),
                                       (2, 100, 3, 9, 100, 50.0)]:
        q, kc, vc, clen = _inputs(s + h, b, s, k, g, h)
        clen[0] = 0
        for dtype, (rtol, atol) in tols.items():
            args = [torch.from_numpy(x).to(dev, dtype) for x in (q, kc, vc)]
            lens = torch.from_numpy(clen).to(dev)
            n = ops.LAUNCHES["decode_attention"]
            got = ops.decode_attention(*args, lens, logit_cap=cap)
            want = tda.decode_attention_plain(*args, lens, logit_cap=cap)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["decode_attention"] == n + 1
            assert got.dtype == dtype and not got[0].any()
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                       atol=atol)
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

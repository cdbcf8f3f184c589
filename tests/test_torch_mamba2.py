"""The port's Mamba-2 SSD mixer (`repro_torch.models.mamba2`) against the
JAX package's.

mamba2-2.7b and hymba-1.5b smoke configs in fp32, with `ssd_chunk` 8 so
that a 21-token sequence spans three chunks and a padded tail of 3. The
JAX weights (`repro.models.mamba2.init_ssm`) cross over as numpy arrays,
with `a_log`, `dt_bias`, `d_skip`, `conv_b` and the norm scale replaced by
random values (the reference initialises them to constants). Tolerance
1e-5 absolute: fp32 sums in another order, and the port contracts the
within-chunk and state einsums two operands at a time in a fixed order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import mamba2 as JM
from repro_torch.configs import base as tbase
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

TOL = 1e-5
ARCHS = ["mamba2_2_7b", "hymba_1_5b"]


def _configs(arch, **kw):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(tbase.smoke_config(arch), dtype="float32",
                                **kw))


def _weights(jcfg, tcfg, seed):
    rng = np.random.default_rng(seed)
    tree = {k: np.array(v, np.float32) for k, v in JM.init_ssm(
        jax.random.PRNGKey(seed), jcfg, jnp.float32).items()}
    for k in ("a_log", "dt_bias", "conv_b", "norm"):
        tree[k] = (0.5 * rng.standard_normal(tree[k].shape)).astype(
            np.float32)
    tree["d_skip"] = (1 + 0.5 * rng.standard_normal(
        tree["d_skip"].shape)).astype(np.float32)
    mod = M.init_ssm(tcfg, torch.float32)
    for name, p in mod.named_parameters():
        p.copy_(torch.from_numpy(tree[name]))
    return {k: jnp.asarray(v) for k, v in tree.items()}, mod


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("s", [21, 16, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_matches_jax(arch, s):
    """Several chunks with a padded tail (21), whole chunks (16), and one
    short chunk (5); the final state and the conv tail too."""
    jcfg, tcfg = _configs(arch, ssd_chunk=8)
    jp, mod = _weights(jcfg, tcfg, 1)
    x = _x(tcfg, 2, s, 2)
    jy, (jst, jtail) = JM.ssm_forward(jp, jnp.asarray(x), jcfg,
                                      return_final_state=True)
    y, (st, tail) = M.ssm_forward(mod, torch.from_numpy(x), tcfg,
                                  return_final_state=True)
    assert y.shape == x.shape and st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0, atol=TOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), rtol=0,
                               atol=TOL)
    plain = M.ssm_forward(mod, torch.from_numpy(x), tcfg)
    assert torch.equal(plain, y)
    # the tail owns its storage (a view would pin the whole projection)
    assert tail.untyped_storage().nbytes() == tail.numel() * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_steps_match_jax(arch):
    """Four recurrent steps from a random state and conv tail, each side
    feeding back its own cache."""
    jcfg, tcfg = _configs(arch)
    jp, mod = _weights(jcfg, tcfg, 3)
    rng = np.random.default_rng(4)
    di, h, p, n, ch = M._dims(tcfg)
    jcache = {"state": rng.standard_normal((2, h, p, n)).astype(np.float32),
              "conv": rng.standard_normal(
                  (2, tcfg.conv_width - 1, ch)).astype(np.float32)}
    cache = {k: torch.from_numpy(v.copy()) for k, v in jcache.items()}
    jcache = {k: jnp.asarray(v) for k, v in jcache.items()}
    for i in range(4):
        x = _x(tcfg, 2, 1, 10 + i)
        jy, jcache = JM.ssm_decode_step(jp, jnp.asarray(x), jcache, jcfg)
        before = {k: v.clone() for k, v in cache.items()}
        y, cache2 = M.ssm_decode_step(mod, torch.from_numpy(x), cache, tcfg)
        assert all(torch.equal(cache[k], before[k]) for k in cache)
        cache = cache2
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=TOL, err_msg=f"step {i}")
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=0,
                                       atol=TOL, err_msg=f"{k} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_state_hands_off_to_decode(arch):
    """The port's own chunked forward over S + 1 tokens ends where its
    forward over S tokens, then one recurrent step, does."""
    jcfg, tcfg = _configs(arch, ssd_chunk=8)
    _, mod = _weights(jcfg, tcfg, 5)
    x = torch.from_numpy(_x(tcfg, 2, 20, 6))
    full, (st_full, _) = M.ssm_forward(mod, x, tcfg, return_final_state=True)
    _, (st, tail) = M.ssm_forward(mod, x[:, :19], tcfg,
                                  return_final_state=True)
    y, cache = M.ssm_decode_step(mod, x[:, 19:], {"state": st, "conv": tail},
                                 tcfg)
    np.testing.assert_allclose(y.numpy(), full[:, 19:].numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(cache["state"].numpy(), st_full.numpy(),
                               rtol=0, atol=TOL)


def test_conv_and_gated_norm_match_jax():
    rng = np.random.default_rng(7)
    xc, w, b = (rng.standard_normal(s).astype(np.float32)
                for s in ((2, 9, 6), (4, 6), (6,)))
    np.testing.assert_allclose(
        M._causal_conv(*map(torch.from_numpy, (xc, w, b))).numpy(),
        np.asarray(JM._causal_conv(*map(jnp.asarray, (xc, w, b)))),
        rtol=0, atol=TOL)
    y, z, scale = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 9, 6), (2, 9, 6), (6,)))
    np.testing.assert_allclose(
        M._gated_norm(*map(torch.from_numpy, (y, z, scale)), 1e-6).numpy(),
        np.asarray(JM._gated_norm(*map(jnp.asarray, (y, z, scale)), 1e-6)),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_and_cache_shapes_dtypes_match_jax(arch):
    """bf16 weights, with `a_log`, `d_skip`, `dt_bias` and the cache's
    state in fp32 as the JAX package keeps them; the reference's scales."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _configs(arch))
    assert M._dims(tcfg) == JM._dims(jcfg)
    want = JM.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = M.init_ssm(tcfg, L.dtype_of(tcfg), None,
                     torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in got.named_parameters()) == sorted(want)
    for name, p in got.named_parameters():
        ref = np.asarray(want[name], np.float32)
        assert tuple(p.shape) == ref.shape, name
        assert str(p.dtype).removeprefix("torch.") == str(want[name].dtype)
        np.testing.assert_allclose(float(p.float().std()), float(ref.std()),
                                   rtol=0.15, atol=1e-6, err_msg=name)
        if not ref.std():
            np.testing.assert_array_equal(p.float().numpy(), ref)
    jc = JM.init_ssm_cache(jcfg, 3, jnp.bfloat16)
    tc = M.init_ssm_cache(tcfg, 3, torch.bfloat16)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype)

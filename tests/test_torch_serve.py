"""The port's LLM serving path against the JAX package's, at smoke size.

The JAX params (made by `repro.models.model.init_params`, with the norm
scales replaced by random values so that `1 + scale` is exercised) cross
over as numpy arrays (`interop.params_from_arrays`). gemma2-9b smoke
(local/global alternation, ring caches, both soft caps) and yi-9b smoke
(the plain dense stack) run in fp32: prefill of a 24-token prompt (longer
than gemma2 smoke's window of 16, so its local caches are rolled), then 8
greedy decode steps, each overwriting the oldest ring entry. Tolerances:
logits 1e-4 and caches 1e-5 absolute (fp32 sums in another order; logits
are ~0.6 at most here), greedy tokens equal. A bf16 run of gemma2 smoke
holds the logits within 5e-2 of the largest |logit| (bf16 rounds at the
same points on both sides, but the rounding of the matmuls' accumulations
differs). On the CPU the decode attention is the kernel's plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import serve_step as JS
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import serve_step as S

B, PROMPT, STEPS = 2, 24, 8
CTX = PROMPT + STEPS
LOGIT_TOL, CACHE_TOL, LAYER_TOL = 1e-4, 1e-5, 1e-5


def _configs(arch, dtype):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype=dtype),
            dataclasses.replace(tbase.smoke_config(arch), dtype=dtype))


def _tree(cfg, seed):
    """The JAX param pytree as float32 numpy, norm scales random."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JM.init_params(cfg, jax.random.PRNGKey(seed)))
    n, d = cfg.n_layers, cfg.d_model
    for key in ("ln1", "ln2"):
        tree["layers"][key] = (0.5 * rng.standard_normal((n, d))).astype(
            np.float32)
    tree["final_norm"] = (0.5 * rng.standard_normal(d)).astype(np.float32)
    return tree


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


class Run:
    """One config's prefill and decode steps on both sides."""

    def __init__(self, arch, dtype):
        self.jcfg, self.cfg = _configs(arch, dtype)
        self.tree = _tree(self.jcfg, 1)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        self.jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), self.tree)
        self.params = interop.params_from_arrays(self.cfg, self.tree)
        rng = np.random.default_rng(2)
        self.prompt = rng.integers(0, self.cfg.vocab, (B, PROMPT),
                                   dtype=np.int32)
        jcfg = self.jcfg
        self.jprefill = jax.jit(lambda p, i: JD.prefill(jcfg, p, i, CTX))
        self.jstep = jax.jit(
            lambda p, c, t, q: JD.decode_step(jcfg, p, c, t, q))

    def prefill(self):
        jl, jc = self.jprefill(self.jparams,
                               {"tokens": jnp.asarray(self.prompt)})
        tl, tc = D.prefill(self.cfg, self.params,
                           {"tokens": torch.from_numpy(self.prompt)}, CTX)
        return (jl, jc), (tl, tc)


@pytest.fixture(scope="module", params=["gemma2_9b", "yi_9b"])
def run(request):
    return Run(request.param, "float32")


def test_prefill_matches_jax(run):
    (jl, jc), (tl, tc) = run.prefill()
    assert tl.shape == (B, run.cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_TOL)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=0,
                                   atol=CACHE_TOL, err_msg=k)


def test_decode_steps_match_jax(run):
    """8 steps, each side feeding its own greedy token: equal tokens,
    logits and caches within tolerance; the port's cache is written in
    place, so the prefill cache is cloned first to show it moved."""
    (jl, jc), (tl, tc) = run.prefill()
    before = {k: v.clone() for k, v in tc.items()}
    jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    ttok = tl.argmax(-1).to(torch.int32)[:, None]
    for i in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = run.jstep(run.jparams, jc, jnp.asarray(jtok),
                           jnp.asarray(pos))
        tl, tc2 = D.decode_step(run.cfg, run.params, tc, ttok,
                                torch.from_numpy(pos))
        assert tc2 is tc
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        ttok = tl.argmax(-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    for k in jc:
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=0,
                                   atol=CACHE_TOL, err_msg=k)
        assert not torch.equal(tc[k], before[k]), k


def test_greedy_generate_matches_jax(run):
    want = np.asarray(JS.greedy_generate(run.jcfg, run.jparams,
                                         jnp.asarray(run.prompt), 5, CTX))
    got = S.greedy_generate(run.cfg, run.params,
                            torch.from_numpy(run.prompt), 5, CTX)
    assert got.dtype == torch.int32 and got.shape == (B, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_logits_match_jax():
    run = Run("gemma2_9b", "bfloat16")
    (jl, jc), (tl, tc) = run.prefill()
    assert tc["k_local"].dtype == torch.bfloat16
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for i in range(3):
        scale = float(np.abs(_np(jl)).max())
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=5e-2 * scale, err_msg=f"step {i}")
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = run.jstep(run.jparams, jc, jnp.asarray(tok),
                           jnp.asarray(pos))
        tl, tc = D.decode_step(run.cfg, run.params, tc,
                               torch.from_numpy(tok), torch.from_numpy(pos))
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]


# ---------------------------------------------------------------- layers --

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_rope_softcap_match_jax():
    rng = np.random.default_rng(3)
    x, scale = _rand(rng, 2, 5, 3, 16), _rand(rng, 16)
    np.testing.assert_allclose(
        _np(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=LAYER_TOL, atol=LAYER_TOL)
    pos = rng.integers(0, 5000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        rtol=LAYER_TOL, atol=LAYER_TOL)
    big = 100 * x
    for cap in (0.0, 30.0):
        np.testing.assert_allclose(
            _np(L.softcap(torch.from_numpy(big), cap)),
            np.asarray(JL.softcap(jnp.asarray(big), cap)),
            rtol=LAYER_TOL, atol=LAYER_TOL)


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 7, 50.0), (False, 0, 50.0), (True, 17, 0.0)])
def test_flash_attention_matches_jax(causal, window, cap):
    """Chunks of 8 over 30 queries and 37 keys: several q and k blocks, a
    ragged last block, and blocks the causal or window masks skip."""
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 30, 4, 16), _rand(rng, 2, 37, 2, 16), \
        _rand(rng, 2, 37, 2, 16)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_chunk=8,
              k_chunk=8)
    got = L.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    want = JL.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=LAYER_TOL,
                               atol=LAYER_TOL)


# ------------------------------------------------------------ init, errors --

def test_init_params_shapes_and_scales_match_jax():
    jcfg, cfg = _configs("gemma2_9b", "float32")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = tree["layers"] if parts[0] == "layers" else tree
        for part in parts[2:] if parts[0] == "layers" else parts:
            node = node[part]
        want = node[int(parts[1])] if parts[0] == "layers" else node
        assert tuple(p.shape) == want.shape, name
        assert p.dtype == torch.float32 and not p.requires_grad
        np.testing.assert_allclose(float(p.std()) if p.any() else 0.0,
                                   float(want.std()), rtol=0.15, err_msg=name)
    cache = D.init_cache(cfg, 3, 40)
    jcache = JD.init_cache(jcfg, 3, 40)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def test_unported_families_and_archs_raise():
    with pytest.raises(KeyError, match="ROADMAP.md"):
        tbase.get_config("qwen3-moe-235b-a22b")
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.smoke_config("no-such-arch")
    assert tbase.get_config("gemma2-9b").n_layers == 42
    moe = dataclasses.replace(tbase.smoke_config("yi_9b"), family="moe")
    for fn in (lambda: M.init_params(moe, torch.Generator()),
               lambda: D.init_cache(moe, 1, 8)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn()


def test_cache_from_arrays_round_trips(run):
    """The JAX package's prefill cache carried across: equal on arrival,
    and two decode steps of the port from it give the JAX logits."""
    jl, jc = run.jprefill(run.jparams, {"tokens": jnp.asarray(run.prompt)})
    cache = interop.cache_from_arrays(
        run.cfg, {k: np.asarray(v) for k, v in jc.items()})
    for k, v in cache.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(_np(v), _np(jc[k]), err_msg=k)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for i in range(2):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = run.jstep(run.jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, cache = D.decode_step(run.cfg, run.params, cache,
                                  torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]

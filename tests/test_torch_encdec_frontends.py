"""The port's encdec family (seamless-m4t), vision frontend stub
(internvl2) and untied embeddings against the JAX package's, at smoke
size.

seamless-m4t-medium smoke (2 encoder + 2 decoder layers, 4 heads) gets
24 decoder tokens and 20 frame embeddings for its encoder (the audio
stub); internvl2-1b smoke (2 layers, GQA 2:1) gets 24 patch embeddings in
place of tokens (the vision stub). The JAX params (`init_params`, every
norm scale replaced by random values, `lnx` and `enc_norm` included)
cross over as numpy arrays (`interop.params_from_arrays`: `enc` and `dec`
stacks, `enc_norm`, `embed.unembed`). The embeddings take the model's
dtype: the JAX package's layer scan refuses a carry whose dtype changes,
so an fp32 model cannot take the bf16 embeddings its launcher draws; the
port can, and `test_bf16_embeddings_in_fp32_model_match_jax_layers` holds
that case against the JAX layer functions applied one by one.

Tolerances: fp32 logits and hidden states 1e-4, caches 1e-5 absolute
(fp32 sums in another order), greedy tokens equal; bf16 within 5e-2 of
the largest |value|, as `tests/test_torch_families.py`'s bf16 test (bf16
rounds at the same points, the products' accumulations differ). On the
CPU the decode attention is the kernel's plain version.

The JAX package RoPEs seamless's cross-attention query at prefill (its
full-sequence attention) but not in `decode_step`; the port keeps both
(`test_cross_query_rope_asymmetry_kept`).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.launch import serve as JSERVE
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.models import decode as D
from repro_torch.models import model as M

B, PROMPT, ENC, STEPS = 2, 24, 20, 8
CTX = PROMPT + STEPS
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
BF16_REL = 5e-2
ARCHS = ["seamless_m4t_medium", "internvl2_1b"]
RANDOM_LEAVES = ("ln1", "ln2", "lnx", "final_norm", "enc_norm")


def _configs(arch, dtype, **kw):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(tbase.smoke_config(arch), dtype=dtype, **kw))


_jax_init = jax.jit(JM.init_params, static_argnums=0)


def _tree(params, seed):
    """A JAX param pytree as float32 numpy; the norm scales random."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.array(v, np.float32)
            if k in RANDOM_LEAVES:
                v = (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            out[k] = v
        return out
    return walk(params)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, dtype, msg=""):
    """fp32: within `LOGIT_TOL`; bf16: within 5e-2 of the largest |want|."""
    want = _np(want)
    atol = LOGIT_TOL if dtype == "float32" else \
        BF16_REL * float(np.abs(want).max())
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol,
                               err_msg=msg)


class Run:
    """One config's weights and prompt on both sides."""

    def __init__(self, arch, dtype, **kw):
        self.dtype = dtype
        self.jcfg, self.cfg = _configs(arch, dtype, **kw)
        self.tree = _tree(_jax_init(self.jcfg, jax.random.PRNGKey(1)), 1)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        self.jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), self.tree)
        self.params = interop.params_from_arrays(self.cfg, self.tree)
        rng = np.random.default_rng(2)
        d = self.cfg.d_model
        self.inputs = {"tokens": rng.integers(0, self.cfg.vocab, (B, PROMPT),
                                              dtype=np.int32)}
        if self.cfg.frontend == "vision":
            self.inputs = {"embeds": rng.standard_normal(
                (B, PROMPT, d)).astype(np.float32)}
        if self.cfg.family == "encdec":
            self.inputs["enc_embeds"] = rng.standard_normal(
                (B, ENC, d)).astype(np.float32)
        jcfg = self.jcfg
        self.jprefill = jax.jit(lambda p, i: JD.prefill(jcfg, p, i, CTX))
        self.jstep = jax.jit(
            lambda p, c, t, q: JD.decode_step(jcfg, p, c, t, q))
        self.jhidden = jax.jit(lambda p, i: JM.forward_hidden(
            jcfg, p, i, collect_cache=True))

    def jinputs(self):
        jdt = jnp.bfloat16 if self.dtype == "bfloat16" else jnp.float32
        return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, jdt)
                for k, v in self.inputs.items()}

    def tinputs(self):
        dt = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
        return {k: torch.from_numpy(v) if k == "tokens" else
                torch.from_numpy(v).to(dt) for k, v in self.inputs.items()}

    def prefill(self):
        jl, jc = self.jprefill(self.jparams, self.jinputs())
        tl, tc = D.prefill(self.cfg, self.params, self.tinputs(), CTX)
        return (jl, jc), (tl, tc)


@pytest.fixture(scope="module",
                params=[(a, dt) for a in ARCHS
                        for dt in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    return Run(*request.param)


def test_forward_hidden_matches_jax(run):
    jh, jcaches = run.jhidden(run.jparams, run.jinputs())
    th, tcaches = M.forward_hidden(run.cfg, run.params, run.tinputs(),
                                   collect_cache=True)
    assert th.shape == (B, PROMPT, run.cfg.d_model)
    assert str(th.dtype).removeprefix("torch.") == str(jh.dtype)
    _close(th, jh, run.dtype)
    jleaves = jax.tree_util.tree_leaves(jcaches)
    tleaves = jax.tree_util.tree_leaves(tcaches)
    n = 4 if run.cfg.family == "encdec" else 2
    assert len(tleaves) == len(jleaves) == n
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert tuple(t.shape) == tuple(j.shape), i
        if run.dtype == "float32":
            np.testing.assert_allclose(_np(t), _np(j), rtol=0,
                                       atol=CACHE_TOL, err_msg=str(i))
        else:
            _close(t, j, run.dtype, f"cache leaf {i}")


def test_prefill_logits_and_caches_match_jax(run):
    (jl, jc), (tl, tc) = run.prefill()
    assert tl.shape == (B, run.cfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl, run.dtype)
    assert sorted(tc) == sorted(jc)
    if run.cfg.family == "encdec":
        assert sorted(tc) == ["k_cross", "k_self", "v_cross", "v_self"]
        assert tc["k_cross"].shape[2] == ENC and tc["k_self"].shape[2] == CTX
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype), k
        if run.dtype == "float32":
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=0,
                                       atol=CACHE_TOL, err_msg=k)
        else:
            _close(tc[k], jc[k], run.dtype, k)


def test_two_decode_steps_from_jax_cache(run):
    """The JAX package's prefill cache carried across (equal on arrival),
    then two decode steps on each side from it: logits within tolerance,
    the self caches written alike, the cross caches untouched."""
    jl, jc = run.jprefill(run.jparams, run.jinputs())
    cache = interop.cache_from_arrays(
        run.cfg, {k: np.asarray(v.astype(jnp.float32))
                  for k, v in jc.items()})
    for k, v in cache.items():
        assert str(v.dtype).removeprefix("torch.") == str(jc[k].dtype), k
        np.testing.assert_array_equal(_np(v), _np(jc[k]), err_msg=k)
    before = {k: v.clone() for k, v in cache.items()}
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for i in range(2):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = run.jstep(run.jparams, jc, jnp.asarray(tok),
                           jnp.asarray(pos))
        tl, cache2 = D.decode_step(run.cfg, run.params, cache,
                                   torch.from_numpy(tok),
                                   torch.from_numpy(pos))
        assert cache2 is cache
        _close(tl, jl, run.dtype, f"step {i}")
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for k in jc:
        _close(cache[k], jc[k], run.dtype, k)
        moved = not torch.equal(cache[k], before[k])
        assert moved == (not k.endswith("_cross")), k


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_jax(arch):
    """fp32, each side from its own prefill, 8 greedy steps feeding its own
    token: equal tokens, logits 1e-4, every cache key 1e-5 at the end."""
    run = Run(arch, "float32")
    (jl, jc), (tl, tc) = run.prefill()
    jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    ttok = tl.argmax(-1).to(torch.int32)[:, None]
    for i in range(STEPS):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = run.jstep(run.jparams, jc, jnp.asarray(jtok),
                           jnp.asarray(pos))
        tl, tc = D.decode_step(run.cfg, run.params, tc, ttok,
                               torch.from_numpy(pos))
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"step {i}")
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        ttok = tl.argmax(-1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    for k in jc:
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), rtol=0,
                                   atol=CACHE_TOL, err_msg=k)


def test_cross_query_rope_asymmetry_kept():
    """seamless: the decode step's logits at position p differ from the
    full forward's at p (the forward RoPEs the cross query, the step does
    not) on both sides alike, and the port's step equals the JAX step."""
    run = Run("seamless_m4t_medium", "float32")
    toks = run.inputs["tokens"]
    enc = run.inputs["enc_embeds"]
    jfull, _ = JM.forward(run.jcfg, run.jparams,
                          {"tokens": jnp.asarray(toks),
                           "enc_embeds": jnp.asarray(enc)})
    tfull, _ = M.forward(run.cfg, run.params,
                         {"tokens": torch.from_numpy(toks),
                          "enc_embeds": torch.from_numpy(enc)})
    np.testing.assert_allclose(_np(tfull), _np(jfull), rtol=0,
                               atol=LOGIT_TOL)
    pre = {"tokens": toks[:, :-1], "enc_embeds": enc}
    _, jc = JD.prefill(run.jcfg, run.jparams,
                       {k: jnp.asarray(v) for k, v in pre.items()}, PROMPT)
    _, tc = D.prefill(run.cfg, run.params,
                      {k: torch.from_numpy(v) for k, v in pre.items()},
                      PROMPT)
    pos = np.full((B,), PROMPT - 1, np.int32)
    jstep, _ = JD.decode_step(run.jcfg, run.jparams, jc,
                              jnp.asarray(toks[:, -1:]), jnp.asarray(pos))
    tstep, _ = D.decode_step(run.cfg, run.params, tc,
                             torch.from_numpy(toks[:, -1:]),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tstep), _np(jstep), rtol=0,
                               atol=LOGIT_TOL)
    for step, full in ((_np(jstep), _np(jfull)), (_np(tstep), _np(tfull))):
        assert np.abs(step - full[:, -1]).max() > 100 * LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(arch, dtype):
    jcfg, cfg = _configs(arch, dtype)
    for enc_len in (0, 11):
        cache = D.init_cache(cfg, 3, 40, enc_len)
        jcache = JD.init_cache(jcfg, 3, 40, enc_len)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in cache.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
        assert not any(bool(v.any()) for v in cache.values())
    if cfg.family == "encdec":
        assert D.init_cache(cfg, 3, 40)["k_cross"].shape[2] == 40
        assert D.init_cache(cfg, 3, 40, enc_len=11)["k_cross"].shape[2] == 11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untied_embeddings_match_jax(dtype):
    """yi-9b smoke with `tie_embeddings=False`: the unembedding is its own
    [D, V] weight (std D^-0.5), carried as `embed.unembed`; prefill logits
    and two decode steps equal the JAX package's."""
    run = Run("yi_9b", dtype, tie_embeddings=False)
    w = run.params.embed.unembed
    assert tuple(w.shape) == (run.cfg.d_model, run.cfg.vocab)
    np.testing.assert_array_equal(_np(w), _np(torch.from_numpy(
        run.tree["embed"]["unembed"]).to(w.dtype)))
    (jl, jc), (tl, tc) = run.prefill()
    _close(tl, jl, dtype)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    for i in range(2):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = run.jstep(run.jparams, jc, jnp.asarray(tok),
                           jnp.asarray(pos))
        tl, tc = D.decode_step(run.cfg, run.params, tc,
                               torch.from_numpy(tok), torch.from_numpy(pos))
        _close(tl, jl, dtype, f"step {i}")
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    tied = M.init_params(dataclasses.replace(run.cfg, tie_embeddings=True),
                         torch.Generator().manual_seed(0))
    assert "embed.unembed" not in dict(tied.named_parameters())


def test_untied_init_scale_matches_jax():
    jcfg, cfg = _configs("yi_9b", "float32", tie_embeddings=False)
    want = np.asarray(_jax_init(jcfg, jax.random.PRNGKey(0))
                      ["embed"]["unembed"])
    got = M.init_params(cfg, torch.Generator().manual_seed(0)).embed.unembed
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(float(got.std()), float(want.std()),
                               rtol=0.05)
    np.testing.assert_allclose(float(got.std()), cfg.d_model ** -0.5,
                               rtol=0.05)


def test_bf16_embeddings_in_fp32_model_match_jax_layers():
    """The launcher's bf16 embeddings into fp32 models: the first norm
    rounds to bf16 and the products promote to fp32, as the JAX layer
    functions do when applied one by one (its scan refuses the carry's
    change of dtype). internvl2: the prefill logits; seamless: the
    encoder's memory."""
    rng = np.random.default_rng(5)
    for arch in ARCHS:
        run = Run(arch, "float32")
        emb = rng.standard_normal((B, PROMPT, run.cfg.d_model))
        jemb = jnp.asarray(emb, jnp.bfloat16)
        temb = torch.from_numpy(emb).to(torch.bfloat16)
        np.testing.assert_array_equal(_np(temb), _np(jemb))
        stack = "layers" if run.cfg.family == "dense" else "enc"
        causal = run.cfg.family == "dense"
        pos = jnp.arange(PROMPT, dtype=jnp.int32)[None, :]
        x = jemb
        for i in range(np.shape(run.tree[stack]["ln1"])[0]):
            lp = jax.tree.map(lambda a: a[i], run.jparams[stack])
            x, _ = JM._dense_layer(run.jcfg, lp, x, pos, window=0,
                                   causal=causal)
        if causal:
            x = JL.rms_norm(x, run.jparams["final_norm"], run.jcfg.norm_eps)
            want = JL.unembed(run.jparams["embed"], x[:, -1:], run.jcfg)[:, -1]
            got, cache = D.prefill(run.cfg, run.params, {"embeds": temb},
                                   CTX)
            assert cache["k"].dtype == torch.float32
        else:
            want = JL.rms_norm(x, run.jparams["enc_norm"], run.jcfg.norm_eps)
            got = M.encode(run.cfg, run.params, temb)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=LOGIT_TOL, err_msg=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_prompt_equals_jax_launcher(arch, monkeypatch, capsys):
    """`serve.main` runs on the CPU; its prompt (`serve.prompt_inputs`)
    equals, bit for bit, the inputs the JAX package's `launch/serve.py`
    hands its prefill for the same seed (caught there before any
    compile)."""
    caught = {}

    class Caught(Exception):
        pass

    def jit(fn):
        def call(params, inputs):
            caught.update(inputs)
            raise Caught
        return call
    monkeypatch.setattr(JSERVE, "jax",
                        types.SimpleNamespace(random=jax.random, jit=jit))
    argv = ["--arch", arch.replace("_", "-"), "--smoke", "--batch", "3",
            "--prompt-len", "20", "--gen", "4", "--seed", "7"]
    with pytest.raises(Caught):
        JSERVE.main(argv)
    cfg = tbase.smoke_config(arch)
    got = serve.prompt_inputs(cfg, 3, 20, 7, "cpu")
    assert sorted(got) == sorted(caught)
    for k, v in got.items():
        want = np.asarray(caught[k])
        assert str(v.dtype).removeprefix("torch.") == str(want.dtype), k
        np.testing.assert_array_equal(_np(v), want.astype(np.float32),
                                      err_msg=k)
    tokens = serve.main(argv + ["--device", "cpu"])
    assert tokens.shape == (3, 4)
    assert ((0 <= tokens) & (tokens < cfg.vocab)).all()
    assert f"[serve] {cfg.name} on cpu" in capsys.readouterr().out

"""The port's moe, ssm and hybrid serving families against the JAX
package's, at smoke size.

qwen3-moe (every layer MoE, top-2), llama4-maverick (dense/MoE pairs,
top-1), mamba2 (SSD only) and hymba (sliding-window attention beside the
SSD mixer) smoke configs. The JAX params (`repro.models.model.init_params`,
with every norm scale and the SSM's `a_log`, `dt_bias`, `d_skip` and
`conv_b` replaced by random values) cross over as numpy arrays
(`interop.params_from_arrays`, which interleaves llama4's two stacks).
In fp32: prefill of a 24-token prompt (longer than hymba smoke's window of
16, so its ring is rolled), then 8 greedy decode steps; logits within
1e-4 and every cache key within 1e-5 absolute (fp32 sums in another
order), greedy tokens equal. MoE decode at batch 2 has a capacity of 1 a
step, so it drops assignments on both sides alike. A bf16 run of hymba
holds the logits within 5e-2 of the largest |logit|, as the dense bf16
test does (its `state` cache stays fp32). The port's own prefill + decode
reproduce its full forward (no MoE drops: capacity factor 8). On the CPU
the decode attention is the kernel's plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import decode as JD
from repro.models import model as JM
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.models import decode as D
from repro_torch.models import model as M

B, PROMPT, STEPS = 2, 24, 8
CTX = PROMPT + STEPS
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
FAMILIES = ["qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b",
            "mamba2_2_7b", "hymba_1_5b"]
RANDOM_LEAVES = ("ln1", "ln2", "final_norm", "norm", "a_log", "dt_bias",
                 "conv_b")


def _configs(arch, dtype, **kw):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(tbase.smoke_config(arch), dtype=dtype, **kw))


_jax_init = jax.jit(JM.init_params, static_argnums=0)


def _tree(params, seed):
    """A JAX param pytree as float32 numpy; the constant leaves random."""
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
            elif k == "d_skip":
                v = (1 + 0.5 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            out[k] = v
        return out
    return walk(params)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


class Run:
    """One config's prefill and decode steps on both sides."""

    def __init__(self, arch, dtype):
        self.jcfg, self.cfg = _configs(arch, dtype)
        ref = _jax_init(self.jcfg, jax.random.PRNGKey(1))
        self.tree = _tree(ref, 1)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        # the JAX package keeps the router and the SSM's a_log, d_skip and
        # dt_bias in fp32 whatever the model's dtype
        self.jparams = jax.tree.map(
            lambda a, r: jnp.asarray(a, r.dtype if r.dtype == jnp.float32
                                     else jdt), self.tree, ref)
        self.params = interop.params_from_arrays(self.cfg, self.tree)
        self.prompt = np.random.default_rng(2).integers(
            0, self.cfg.vocab, (B, PROMPT), dtype=np.int32)
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


@pytest.fixture(scope="module", params=FAMILIES)
def run(request):
    return Run(request.param, "float32")


def test_prefill_matches_jax(run):
    (jl, jc), (tl, tc) = run.prefill()
    assert tl.shape == (B, run.cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=LOGIT_TOL)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == tuple(jc[k].shape), k
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype), k
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


def test_cache_from_arrays_round_trips(run):
    """The JAX package's prefill cache carried across: equal on arrival
    (the SSM state in fp32), and two decode steps of the port from it give
    the JAX logits."""
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


def test_bf16_logits_match_jax():
    """hymba smoke in bf16: the fp32 SSM parameters and state stay fp32 on
    both sides; logits within 5e-2 of the largest |logit| over 3 steps."""
    run = Run("hymba_1_5b", "bfloat16")
    assert run.params.layers[0].ssm.a_log.dtype == torch.float32
    assert run.params.layers[0].ssm.in_proj.dtype == torch.bfloat16
    (jl, jc), (tl, tc) = run.prefill()
    assert tc["state"].dtype == torch.float32
    assert tc["k"].dtype == tc["conv"].dtype == torch.bfloat16
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_consistent_with_forward(arch):
    """The port's prefill + one decode step reproduce its own full-forward
    logits (cache correctness: ring buffers, SSM state handoff)."""
    _, cfg = _configs(arch, "float32", capacity_factor=8.0)
    params = M.init_params(cfg, torch.Generator().manual_seed(1))
    s = 40
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, s), dtype=np.int32))
    full, _ = M.forward(cfg, params, {"tokens": toks})
    pre, cache = D.prefill(cfg, params, {"tokens": toks[:, :s - 1]}, s + 4)
    np.testing.assert_allclose(pre.numpy(), full[:, s - 2].numpy(), rtol=0,
                               atol=LOGIT_TOL)
    step, _ = D.decode_step(cfg, params, cache, toks[:, s - 1:],
                            torch.full((B,), s - 1, dtype=torch.int32))
    np.testing.assert_allclose(step.numpy(), full[:, s - 1].numpy(), rtol=0,
                               atol=LOGIT_TOL)


def _ref_leaf(cfg, tree, name):
    """The JAX leaf of the port's parameter `name`."""
    parts = name.split(".")
    if parts[0] not in ("layers", "enc"):
        node = tree
        for part in parts:
            node = node[part]
        return node
    i = int(parts[1])
    if parts[0] == "enc":
        node = tree["enc"]
    elif cfg.family == "encdec":
        node = tree["dec"]
    elif cfg.alt_dense_moe:
        node, i = tree["layers_dense" if i % 2 == 0 else "layers_moe"], i // 2
    else:
        node = tree["layers"]
    for part in parts[2:]:
        node = node[part]
    return node[i]


@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_init_params_shapes_and_scales_match_jax(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    tree = _jax_init(jcfg, jax.random.PRNGKey(0))
    n_ref = len(jax.tree_util.tree_leaves(tree))
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    named = list(model.named_parameters())
    # every reference leaf, once per layer of its stack
    assert len(named) == sum(
        np.asarray(a).shape[0]
        if path[0].key.startswith(("layers", "enc", "dec"))
        and path[0].key != "enc_norm" else 1
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0])
    assert n_ref <= len(named)
    for name, p in named:
        want = np.asarray(_ref_leaf(cfg, tree, name))
        assert tuple(p.shape) == want.shape, name
        assert str(p.dtype).removeprefix("torch.") == str(want.dtype), name
        assert not p.requires_grad
        want = want.astype(np.float32)
        np.testing.assert_allclose(float(p.float().std()), float(want.std()),
                                   rtol=0.15, atol=1e-6, err_msg=name)
    cache = D.init_cache(cfg, 3, 40)
    jcache = JD.init_cache(jcfg, 3, 40)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}


@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_ported_configs_equal_jax(arch):
    for fn in ("get_config", "smoke_config"):
        assert dataclasses.asdict(getattr(tbase, fn)(arch)) == \
            dataclasses.asdict(getattr(jbase, fn)(arch)), (arch, fn)


def test_archs_are_the_jax_packages():
    """The port registers the JAX package's ten architectures, in its
    order, each with a config module of its own."""
    assert tbase.ARCHS == jbase.ARCHS and len(set(tbase.ARCHS)) == 10
    assert {tbase.get_config(a).family for a in tbase.ARCHS} == {
        "dense", "moe", "ssm", "hybrid", "encdec"}
    assert {tbase.get_config(a).frontend for a in tbase.ARCHS} == {
        "none", "vision", "audio"}


@pytest.mark.parametrize("arch", FAMILIES + ["yi_34b", "internvl2_1b",
                                             "seamless_m4t_medium"])
def test_serve_main_runs_each_family_on_the_cpu(arch, capsys):
    tokens = serve.main(["--arch", arch.replace("_", "-"), "--smoke",
                         "--device", "cpu", "--batch", "2", "--prompt-len",
                         "20", "--gen", "4"])
    assert tokens.shape == (2, 4)
    cfg = tbase.smoke_config(arch)
    assert ((0 <= tokens) & (tokens < cfg.vocab)).all()
    assert f"[serve] {cfg.name} on cpu" in capsys.readouterr().out

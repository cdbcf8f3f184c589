"""The port's training slice against the JAX package, on the CPU: the input
cells, the parameter shapes, the synthetic data, the chunked loss and every
parameter's gradient.

The JAX params of each smoke config (fp32 unless said; every norm scale
and the SSM's `a_log`, `dt_bias`, `d_skip` and `conv_b` replaced by random
values, so that no factor is a constant 0 or 1) cross over as numpy arrays
(`interop.params_from_arrays`); the batches are `data.synthetic`'s, bit
for bit the same on both sides. Tolerances: the loss within 1e-5
relative; each parameter's gradient within rtol 1e-4 and an atol of 1e-5
of the JAX gradient's largest |entry|. fp32 sums in another order put
entries that cancel 0.3-1.3e-6 of that maximum apart (qwen3-moe's wk the
most), so 1e-6 would test the rounding; a wrong gradient is off by O(1).
llama4 routes top-1, so its gate is p / p = 1 and the router's gradient
is zero up to rounding on both sides: it is held to that (below 1e-6 of
the largest gradient entry of the model) instead. The
SSM families run with an SSD chunk of 12 on 32 positions (three chunks,
the last padded), so the inter-chunk recurrence and the padded tail are
differentiated too. Optimizer, train step, checkpoint and launcher tests
are in `tests/test_torch_checkpoint.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs import shapes as JS
from repro.data import synthetic as JSYN
from repro.models import model as JM
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import shapes as TS
from repro_torch.data import synthetic as TSYN
from repro_torch.models import model as M

B, S = 2, 32
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
SSD_CHUNK = 12
RANDOM_LEAVES = ("ln1", "ln2", "lnx", "final_norm", "enc_norm", "norm",
                 "a_log", "dt_bias", "conv_b")


def _configs(arch, dtype="float32", **kw):
    if jbase.smoke_config(arch).ssm_state:
        kw.setdefault("ssd_chunk", SSD_CHUNK)
    return (dataclasses.replace(jbase.smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(tbase.smoke_config(arch), dtype=dtype, **kw))


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


def carried(arch, seed=0, **kw):
    """(jcfg, cfg, the numpy tree, JAX params, the port's Model)."""
    jcfg, cfg = _configs(arch, **kw)
    tree = _tree(JM.init_params(jcfg, jax.random.PRNGKey(seed)), seed)
    return (jcfg, cfg, tree, jax.tree.map(jnp.asarray, tree),
            interop.params_from_arrays(cfg, tree))


def batches(cfg, step=0, batch=B, seq=S):
    """The same step's batch as JAX arrays and as tensors."""
    b = TSYN.batch_for_config(cfg, step, batch, seq)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _np(x):
    return np.asarray(x.detach().float().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


# ------------------------------------------------------ cells and shapes --

@pytest.mark.parametrize("arch", jbase.ARCHS)
@pytest.mark.parametrize("cell", list(JS.SHAPES))
def test_input_specs_match_jax(arch, cell):
    for smoke in (False, True):
        for get in (jbase.get_config, jbase.smoke_config):
            jcfg = get(arch)
            cfg = (tbase.get_config if get is jbase.get_config
                   else tbase.smoke_config)(arch)
            want = JS.input_specs(jcfg, cell, smoke=smoke)
            got = TS.input_specs(cfg, cell, smoke=smoke)
            assert list(got) == list(want)
            for k, spec in want.items():
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(spec.shape), k
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(spec.dtype), k
            assert TS.cell_applicable(cfg, cell) == \
                JS.cell_applicable(jcfg, cell)
    assert TS.SHAPES[cell] == TS.ShapeCell(*dataclasses.astuple(
        JS.SHAPES[cell]))


def _zero_stride(spec):
    """An array of the spec's shape and dtype that holds no memory."""
    return np.broadcast_to(np.zeros((), spec.dtype), spec.shape)


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_param_shapes_match_jax(arch):
    """Every parameter of `param_shapes` (on the meta device) has the JAX
    abstract init's shape (its L axes split) and dtype, and the two count
    the same number of weights, at full width and at smoke size."""
    for jcfg, cfg in ((jbase.get_config(arch), tbase.get_config(arch)),
                      (jbase.smoke_config(arch), tbase.smoke_config(arch))):
        jshapes = JM.param_shapes(jcfg)
        model = M.param_shapes(cfg)
        assert all(p.device.type == "meta" for p in model.parameters())
        want = interop.arrays_by_name(
            cfg, jax.tree.map(_zero_stride, jshapes), model)
        for name, p in model.named_parameters():
            assert str(p.dtype).removeprefix("torch.") == \
                str(want[name].dtype), name
        assert sum(p.numel() for p in model.parameters()) == \
            sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))


# ----------------------------------------------------------------- data --

@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_batch_for_config_bit_for_bit(arch):
    cfg, jcfg = tbase.smoke_config(arch), jbase.smoke_config(arch)
    for step, batch, seq, seed in ((0, 2, 8, 0), (7, 4, 33, 3)):
        got = TSYN.batch_for_config(cfg, step, batch, seq, seed)
        want = JSYN.batch_for_config(jcfg, step, batch, seq, seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert sorted(got) == sorted(TS.input_specs(cfg, "train_4k", True))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_token_stream_shards_bit_for_bit(n_shards):
    for shard in range(n_shards):
        kw = dict(vocab=100, global_batch=8, seq_len=16, seed=1,
                  n_shards=n_shards, shard=shard)
        t, j = TSYN.TokenStream(**kw), JSYN.TokenStream(**kw)
        assert t.shard_batch == j.shard_batch == 8 // n_shards
        for step in (0, 5):
            for k, v in j.batch_at(step).items():
                np.testing.assert_array_equal(t.batch_at(step)[k], v)
            for k, v in j.embeds_at(step, 12).items():
                np.testing.assert_array_equal(t.embeds_at(step, 12)[k], v)
    a = TSYN.TokenStream(100, 8, 16, seed=1, n_shards=2, shard=0).batch_at(5)
    b = TSYN.TokenStream(100, 8, 16, seed=1, n_shards=2, shard=1).batch_at(5)
    assert not np.array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError):
        TSYN.TokenStream(100, 7, 16, n_shards=2).shard_batch


# ---------------------------------------------------- loss and gradients --

_grad_fns = {}


def jax_value_and_grad(jcfg, loss_chunk):
    key = (jcfg, loss_chunk)
    if key not in _grad_fns:
        _grad_fns[key] = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(jcfg, p, b, loss_chunk=loss_chunk)))
    return _grad_fns[key]


def value_and_grad(fn, params):
    """fn(params) and its gradient for every parameter, by name (zeros for
    one it does not reach, as `jax.grad` gives)."""
    params.requires_grad_(True)
    names, plist = zip(*params.named_parameters())
    value = fn(params)
    grads = torch.autograd.grad(value, plist, allow_unused=True,
                                materialize_grads=True)
    params.requires_grad_(False)
    return value.detach(), dict(zip(names, grads))


def port_value_and_grad(cfg, params, batch, loss_chunk):
    return value_and_grad(lambda p: M.loss_fn(cfg, p, batch, loss_chunk),
                          params)


def assert_grads_match(cfg, params, grads, jgrads):
    want = interop.arrays_by_name(cfg, jax.tree.map(np.asarray, jgrads),
                                  params)
    assert sorted(grads) == sorted(want)
    scale = max(float(np.abs(np.asarray(w, np.float32)).max())
                for w in want.values())
    for name, g in grads.items():
        w = np.asarray(want[name], np.float32)
        if cfg.top_k == 1 and name.endswith(".router"):
            assert max(float(np.abs(w).max()),
                       float(g.abs().max())) < 1e-6 * scale, name
            continue
        np.testing.assert_allclose(
            _np(g), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


# (arch, loss_chunk): 8 cuts S = 32 into four chunks; 12 does not divide
# S, so the whole sequence is one chunk, as in the reference
LOSS_CASES = [(a, 8) for a in jbase.ARCHS] + \
    [("stablelm_3b", 12), ("gemma2_9b", 12), ("internvl2_1b", 12)]


@pytest.mark.parametrize("arch,loss_chunk", LOSS_CASES,
                         ids=[f"{a}-chunk{c}" for a, c in LOSS_CASES])
def test_loss_and_grads_match_jax(arch, loss_chunk):
    jcfg, cfg, _, jparams, params = carried(arch)
    jb, tb = batches(cfg)
    jl, jg = jax_value_and_grad(jcfg, loss_chunk)(jparams, jb)
    loss, grads = port_value_and_grad(cfg, params, tb, loss_chunk)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_grads_match(cfg, params, grads, jg)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_ssm_families_backpropagate(arch):
    """The SSD's products are out of place under autograd (in place they
    overwrote a factor backward needs, and `backward` raised); without
    autograd the serving path keeps the in-place form, with the same
    bits."""
    _, cfg, _, _, params = carried(arch)
    _, tb = batches(cfg)
    params.requires_grad_(True)
    x, _ = M.forward_hidden(cfg, params, tb)
    x.float().square().sum().backward()
    for name, p in params.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
    assert float(params.layers[0].ssm.a_log.grad.abs().sum()) > 0
    with torch.no_grad():
        y, _ = M.forward_hidden(cfg, params, tb)
    np.testing.assert_array_equal(_np(y), _np(x))


@pytest.mark.parametrize("arch", jbase.ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch):
    """`forward_hidden` with every layer checkpointed against without: the
    same hidden states, and the same gradients of a fixed projection of
    them."""
    _, cfg, _, _, params = carried(arch)
    _, tb = batches(cfg)
    w = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))

    def fn(remat):
        return lambda p: (M.forward_hidden(cfg, p, tb, remat=remat)[0]
                          .float() * w).sum()
    l0, g0 = value_and_grad(fn(False), params)
    l1, g1 = value_and_grad(fn(True), params)
    assert float(l0) == float(l1)
    for name in g0:
        np.testing.assert_allclose(_np(g1[name]), _np(g0[name]), rtol=1e-6,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("arch", ["stablelm_3b", "hymba_1_5b",
                                  "seamless_m4t_medium"])
def test_forward_hidden_keeps_caches_only_when_asked(arch):
    _, cfg, _, _, params = carried(arch)
    _, tb = batches(cfg)
    with torch.no_grad():
        h0, none = M.forward_hidden(cfg, params, tb)
        h1, caches = M.forward_hidden(cfg, params, tb, collect_cache=True)
    assert none is None and caches is not None
    np.testing.assert_array_equal(_np(h0), _np(h1))
    assert all(not p.requires_grad for p in params.parameters())


def test_bf16_loss_matches_jax():
    """stablelm smoke in its own dtype (bf16): loss within 2e-2 relative
    (bf16 activations rounded at the same points)."""
    jcfg, cfg = _configs("stablelm_3b", "bfloat16")
    tree = _tree(JM.init_params(jcfg, jax.random.PRNGKey(0)), 0)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    params = interop.params_from_arrays(cfg, tree)
    jb, tb = batches(cfg)
    jl = JM.loss_fn(jcfg, jparams, jb, loss_chunk=8)
    tl = M.loss_fn(cfg, params, tb, 8)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)

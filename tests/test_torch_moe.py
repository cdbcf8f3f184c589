"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's.

The JAX expert weights (`repro.models.moe.init_moe`) cross over as numpy
arrays; the tokens are standard normal numpy from a seed. qwen3-moe smoke
(8 experts, top-2) and llama4 smoke (8 experts, top-1) in fp32, with a
capacity factor of 0.5 (about half the assignments dropped: the sentinel
slot E*C must swallow them and never wrap into the last expert) and of 8
(none dropped). Tolerance 1e-5 absolute: fp32 sums in another order
(outputs are ~0.5 at most here). `capacity` is integer arithmetic and
must equal the reference over a grid.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import moe as JMOE
from repro_torch.configs import base as tbase
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

TOL = 1e-5


def _configs(arch, **kw):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(tbase.smoke_config(arch), dtype="float32",
                                **kw))


def _experts(jcfg, tcfg, seed):
    """The JAX expert tree (numpy fp32) and the port's module holding it."""
    tree = {k: np.array(v, np.float32) for k, v in JMOE.init_moe(
        jax.random.PRNGKey(seed), jcfg, jnp.float32).items()}
    mod = MOE.init_moe(tcfg, torch.float32)
    for name, p in mod.named_parameters():
        p.copy_(torch.from_numpy(tree[name]))
    return tree, mod


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "llama4_maverick_400b_a17b"])
def test_capacity_matches_jax(arch, factor):
    jcfg, tcfg = _configs(arch, capacity_factor=factor)
    for tokens in (1, 2, 3, 7, 8, 48, 100, 4 * 4200):
        assert MOE.capacity(tcfg, tokens) == JMOE.capacity(jcfg, tokens)


@pytest.mark.parametrize("factor", [0.5, 8.0])
@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "llama4_maverick_400b_a17b"])
def test_moe_ffn_matches_jax(arch, factor):
    jcfg, tcfg = _configs(arch, capacity_factor=factor)
    tree, mod = _experts(jcfg, tcfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    want = np.asarray(JMOE.moe_ffn({k: jnp.asarray(v) for k, v in
                                    tree.items()}, jnp.asarray(x), jcfg))
    got = MOE.moe_ffn(mod, torch.from_numpy(x), tcfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # the drops are real at factor 0.5 and absent at 8
    *_, keep = MOE.route(mod, torch.from_numpy(x).reshape(48, -1), tcfg)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (factor < 1), dropped


def test_route_sorts_stably_and_fills_each_expert_in_order():
    """The dispatch's bookkeeping on its own: assignments sorted by expert
    with token order kept inside an expert, each expert's kept slots
    consecutive from e*C, every dropped one on the sentinel E*C."""
    _, tcfg = _configs("qwen3_moe_235b_a22b", capacity_factor=0.5)
    _, mod = _experts(*_configs("qwen3_moe_235b_a22b"), 5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (40, tcfg.d_model)).astype(np.float32))
    gates, order, e_sorted, tok_sorted, slot, keep = MOE.route(mod, x, tcfg)
    e, c = tcfg.n_experts, MOE.capacity(tcfg, 40)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert bool((e_sorted[1:] >= e_sorted[:-1]).all())
    for ex in range(e):
        toks = tok_sorted[e_sorted == ex]
        assert bool((toks[1:] >= toks[:-1]).all())
        mine = slot[(e_sorted == ex) & keep]
        np.testing.assert_array_equal(mine.numpy(),
                                      ex * c + np.arange(len(mine)))
    assert bool((slot[~keep] == e * c).all()) and int((~keep).sum()) > 0


def test_init_moe_shapes_dtypes_and_scales_match_jax():
    """bf16 experts, an fp32 router (as the JAX package keeps it), and each
    expert drawn on its own with the reference's scale."""
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in
                  _configs("llama4_maverick_400b_a17b"))
    want = JMOE.init_moe(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = MOE.init_moe(tcfg, L.dtype_of(tcfg), None,
                       torch.Generator().manual_seed(0))
    for name, p in got.named_parameters():
        ref = np.asarray(want[name], np.float32)
        assert tuple(p.shape) == ref.shape, name
        assert str(p.dtype).removeprefix("torch.") == str(want[name].dtype)
        assert not p.requires_grad
        np.testing.assert_allclose(float(p.float().std()), float(ref.std()),
                                   rtol=0.1, err_msg=name)
    # the stacks are drawn one expert at a time: no two experts equal
    assert not torch.equal(got.wg[0], got.wg[1])


def test_stacked_weight_draws_one_entry_at_a_time():
    """Entry i of a stack equals the i-th of n separate draws from the same
    generator (so the fp32 temporary is one entry), cast to the dtype."""
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    stack = L.stacked_weight(3, (4, 5), 0.5, torch.bfloat16, None, g1)
    for i in range(3):
        want = (torch.randn((4, 5), generator=g2) * 0.5).to(torch.bfloat16)
        assert torch.equal(stack[i], want)
    empty = L.stacked_weight(3, (4, 5), 0.5, torch.float32)
    assert empty.shape == (3, 4, 5) and not empty.requires_grad


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b",
                                  "llama4_maverick_400b_a17b"])
def test_combine_sums_in_a_fixed_order(arch):
    """bf16, capacity factor 0.5, half the tokens repeats of one row (so
    they route alike and their experts overflow): the combine is, bit for
    bit, each token's kept contributions (expert output times gate, in
    bf16) added one at a time to zero in top-k order."""
    _, tcfg = _configs(arch, capacity_factor=0.5)
    _, mod = _experts(*_configs(arch), 8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((40, tcfg.d_model)).astype(np.float32)
    x[20:] = x[0]
    x = torch.from_numpy(x)
    gates, order, _, tok_sorted, slot, keep = MOE.route(mod, x, tcfg)
    assert int((~keep).sum()) > 0
    e, c, k = tcfg.n_experts, MOE.capacity(tcfg, 40), tcfg.top_k
    out = torch.from_numpy(rng.standard_normal(
        (e * c, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    got = MOE._combine(out, gates, order, slot, keep, 40)
    # sorted position of assignment (token t, choice j) = t * k + j
    where = {int(a): i for i, a in enumerate(order)}
    want = torch.zeros((40, tcfg.d_model), dtype=torch.bfloat16)
    for t in range(40):
        for j in range(k):
            i = where[t * k + j]
            assert int(tok_sorted[i]) == t
            contrib = out[slot[i]] if keep[i] else torch.zeros_like(out[0])
            want[t] = want[t] + contrib * gates[t, j].to(torch.bfloat16)
    assert torch.equal(got, want)

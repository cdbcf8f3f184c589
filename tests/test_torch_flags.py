"""The port's model flags (`models/flags.py`) and the layer remat, against
the JAX package on the CPU.

* `forward_hidden` and `forward` take the reference's keywords and
  defaults (`remat=True`); a `forward(remat=True)` training step gives
  `remat=False`'s loss and gradients; under `no_grad` (prefill) nothing
  is checkpointed.
* `REMAT_POLICY="dots"` gives "full"'s loss and gradients and recomputes
  fewer matrix products in backward.
* `LOSS_CHUNK` and `FLASH_CHUNK` give the JAX package's loss and
  gradients with the same flags set there, and are read.
* the MoE layer dispatches through `moe_ffn_a2a`.
Every flag is set through `monkeypatch`, in both packages, so it is
restored after the test.
"""
import inspect

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import flags as JFLAGS
from repro.models import model as JM
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from test_torch_train import (assert_grads_match, batches, carried,
                              value_and_grad)

LOSS_RTOL = 1e-5


@pytest.mark.parametrize("name", ["forward_hidden", "forward"])
def test_signatures_match_jax(name):
    mine = inspect.signature(getattr(M, name)).parameters
    ref = inspect.signature(getattr(JM, name)).parameters
    assert [(p.name, p.kind, p.default) for p in mine.values()] == \
        [(p.name, p.kind, p.default) for p in ref.values()]
    assert mine["remat"].default is True


def _ce(cfg, tb, remat):
    """Mean next-token cross-entropy through `forward`'s full logits."""
    def fn(p):
        logits, _ = M.forward(cfg, p, tb, remat=remat)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), tb["labels"].long()
            .reshape(-1))
    return fn


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen3_moe_235b_a22b",
                                  "hymba_1_5b"])
def test_forward_remat_trains_as_without(arch, monkeypatch):
    _, cfg, _, _, params = carried(arch)
    _, tb = batches(cfg)
    calls = []
    real = M.checkpoint
    monkeypatch.setattr(M, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    l0, g0 = value_and_grad(_ce(cfg, tb, False), params)
    assert calls == []
    l1, g1 = value_and_grad(_ce(cfg, tb, True), params)
    assert len(calls) == cfg.n_layers
    assert float(l0) == float(l1)
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    with torch.no_grad():          # serving: nothing to recompute
        M.forward_hidden(cfg, params, tb, collect_cache=True)
    assert len(calls) == cfg.n_layers


class _Products(TorchDispatchMode):
    """Counts the unbatched matrix products run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.addmm.default) or (
                func is aten.bmm.default and args[0].shape[0] == 1):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _loss_grads_products(cfg, params, tb):
    params.requires_grad_(True)
    names, plist = zip(*params.named_parameters())
    loss = M.loss_fn(cfg, params, tb, loss_chunk=8)
    with _Products() as count:
        grads = torch.autograd.grad(loss, plist, allow_unused=True,
                                    materialize_grads=True)
    params.requires_grad_(False)
    return float(loss.detach()), dict(zip(names, grads)), count.n


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen3_moe_235b_a22b"])
def test_dots_policy_matches_full_with_less_recompute(arch, monkeypatch):
    _, cfg, _, _, params = carried(arch)
    _, tb = batches(cfg)
    l_full, g_full, n_full = _loss_grads_products(cfg, params, tb)
    monkeypatch.setattr(flags, "REMAT_POLICY", "dots")
    l_dots, g_dots, n_dots = _loss_grads_products(cfg, params, tb)
    assert l_full == l_dots
    for name in g_full:
        np.testing.assert_allclose(g_dots[name].numpy(),
                                   g_full[name].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=name)
    assert n_dots < n_full, (n_dots, n_full)
    monkeypatch.setattr(flags, "REMAT_POLICY", "most")
    with pytest.raises(ValueError, match="REMAT_POLICY"):
        _loss_grads_products(cfg, params, tb)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma2_9b"])
def test_chunk_flags_match_jax(arch, monkeypatch):
    jcfg, cfg, _, jparams, params = carried(arch)
    jb, tb = batches(cfg)
    with torch.no_grad():
        nll = _count_calls(monkeypatch, M, "_chunk_nll")
        caps = _count_calls(monkeypatch, L, "softcap")
        M.loss_fn(cfg, params, tb)
        base = (len(nll), len(caps))
        for mod in (flags, JFLAGS):
            monkeypatch.setattr(mod, "LOSS_CHUNK", 16)
            monkeypatch.setattr(mod, "FLASH_CHUNK", 8)
        nll.clear()
        caps.clear()
        M.loss_fn(cfg, params, tb)
    # S = 32: two loss chunks where 512 gave one; 8-long attention blocks
    # where 512 gave one a layer
    assert base[0] == 1 and len(nll) == 2
    assert len(caps) > base[1]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(jcfg, p, b)))(jparams, jb)
    loss, grads = value_and_grad(lambda p: M.loss_fn(cfg, p, tb), params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_grads_match(cfg, params, grads, jg)


def test_moe_layer_dispatches_through_a2a(monkeypatch):
    """The MoE layer calls `moe_ffn_a2a`, which off a mesh computes
    `moe_ffn` on the same arguments (the JAX package's default
    `MOE_IMPL`, the port's only dispatch)."""
    _, cfg, _, _, params = carried("qwen3_moe_235b_a22b")
    assert not hasattr(flags, "MOE_IMPL")
    a2a = _count_calls(monkeypatch, MOE, "moe_ffn_a2a")
    plain = _count_calls(monkeypatch, MOE, "moe_ffn")
    x = torch.randn(2, 8, cfg.d_model)
    with torch.no_grad():
        y = params.layers[0].ffn(x, cfg)
        want = MOE.moe_ffn(params.layers[0].moe, x, cfg)
    assert (len(a2a), len(plain)) == (1, 2)
    np.testing.assert_array_equal(y.numpy(), want.numpy())

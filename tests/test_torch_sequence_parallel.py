"""Sequence parallelism in the sharded train and prefill steps, on 4 gloo
CPU ranks: a 2 x 2 (`data`, `model`) mesh running the dry-run's
`sharded_forwards` (`launch/dryrun.py`) on real DTensors, against the
port's unsharded steps and the JAX package's.

Each case is a family's smoke config in fp32 with overrides that take the
sequence-parallel bodies: three query heads and one KV head (they do not
divide `model`, so each rank attends for its block of queries over the
gathered keys and values, with the block's first position as the query
offset) and a vocab of 257 (the CE chunks take the sequence on `model`).
`dense_tp` keeps the heads and vocab that divide (column and row parallel
products with the sequence gathered and reduce-scattered, the
vocab-parallel CE). gemma2 and hymba get a window of 24 on 32 positions,
so the local attention and the prefill ring reach across the shard
boundary; the SSD runs with a chunk of 12 (three chunks, the last padded)
and its heads split over `model` (`mamba2_one_head`: one head, which
does not divide, so each rank scans it whole and keeps its block of the
output); qwen3-moe's capacity factor of 8 drops
nothing, so `moe_ffn_a2a` on the sequence-sharded tokens equals
`moe_ffn`. Attention and CE run in blocks of 8.

Checks, fp32: the prefill's last logits and every cache, and one
`train_step`'s loss and every parameter's gradient (captured where the
step hands them to `apply_updates`), equal the port's unsharded step; the
logits and loss the JAX `prefill` and `loss_fn`, the gradients
`jax.value_and_grad(loss_fn)`'s, on the same numpy weights (`interop`).
Logits and loss within rtol = atol = 1e-5, gradients within 1e-4.
`flash_attention`'s query offset alone: a block of queries attends as
those rows of the whole sequence do, and as the JAX one's `q_offset`.
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
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.data import synthetic as TSYN
from repro_torch.launch import dryrun as DR
from repro_torch.models import flags
from repro_torch.models import layers as L
from repro_torch.parallel import ranks
from repro_torch.parallel import sharding as SH
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.serve_step import make_prefill_step
from test_torch_train import _tree, jax_value_and_grad

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MESH_SHAPE, MESH_NAMES = (2, 2), ("data", "model")
B, S, BLOCK = 2, 32, 8
ODD = {"n_heads": 3, "n_kv": 1, "d_head": 16}
CASES = {
    "dense": ("stablelm-3b", {**ODD, "vocab": 257}),
    "dense_tp": ("stablelm-3b", {}),
    "gemma2": ("gemma2-9b", {**ODD, "sliding_window": 24}),
    "mamba2": ("mamba2-2-7b", {"vocab": 257, "ssd_chunk": 12}),
    "mamba2_one_head": ("mamba2-2-7b", {"ssm_head_dim": 128,
                                        "ssd_chunk": 12}),
    "hymba": ("hymba-1-5b", {**ODD, "vocab": 257, "sliding_window": 24,
                             "ssd_chunk": 12}),
    "seamless": ("seamless-m4t-medium", {**ODD, "vocab": 257}),
    "internvl2": ("internvl2-1b", {**ODD, "vocab": 257}),
    "qwen3_moe": ("qwen3-moe-235b-a22b", {**ODD, "capacity_factor": 8.0}),
}


def _cfgs(case):
    arch, over = CASES[case]
    return (dataclasses.replace(jbase.smoke_config(arch), dtype="float32",
                                **over),
            dataclasses.replace(tbase.smoke_config(arch), dtype="float32",
                                **over))


def _blocks():
    flags.FLASH_CHUNK = flags.LOSS_CHUNK = BLOCK


def _tensors(batch: dict, prefill: bool = False) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if not (prefill and k == "labels")}


def _capture(grads: dict):
    """`train_step`'s `apply_updates`, recording the gradients it is
    handed; the real one restored by the returned function."""
    real = TS.apply_updates

    def apply(params, g, state, cfg):
        grads.update(g)
        return real(params, g, state, cfg)
    TS.apply_updates = apply
    return lambda: setattr(TS, "apply_updates", real)


def _steps(cfg, tree, batch, mesh=None):
    """The prefill's (logits, cache) and a train step's (loss, gradients),
    on DTensors of `mesh` under `sharded_forwards`, or on plain tensors
    (None), as whole numpy arrays."""
    import contextlib
    rules = SH.AxisRules()

    def model():
        m = interop.params_from_arrays(cfg, tree)
        return m if mesh is None else DR.shard_model(m, cfg, mesh, rules)

    def feed(b):
        return b if mesh is None else DR.shard_batch(b, mesh, rules)

    def whole(t):
        return (t if mesh is None else t.full_tensor()).detach().numpy()
    ctx = contextlib.nullcontext if mesh is None else \
        (lambda: DR.on_mesh(mesh, rules))
    with ctx():
        logits, cache = make_prefill_step(cfg, ctx_len=S)(
            model(), feed(_tensors(batch, prefill=True)))
    out = {"logits": whole(logits),
           "cache": {k: whole(v) for k, v in cache.items()}}
    grads = {}
    restore = _capture(grads)
    try:
        params, ocfg = model(), OptConfig()
        with ctx():
            _, _, metrics = TS.make_train_step(cfg, ocfg)(
                params, init_opt_state(params, ocfg), feed(_tensors(batch)))
    finally:
        restore()
    out["loss"] = whole(metrics["loss"])
    out["grads"] = {k: whole(v) for k, v in grads.items()}
    return out


def sp_rank(rank, group, device, arrays):
    """Every case on the 2 x 2 mesh: rank 0 returns the results whole;
    every rank the query offsets its attention blocks took."""
    from torch.distributed.device_mesh import init_device_mesh
    _blocks()
    mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_NAMES)
    offsets = {}
    real = L.flash_attention

    def seen(*a, q_offset=0, **kw):
        offsets[case].add(q_offset)
        return real(*a, q_offset=q_offset, **kw)
    L.flash_attention = seen
    out = {}
    for case, (tree, batch) in arrays.items():
        offsets[case] = set()
        res = _steps(_cfgs(case)[1], tree, batch, mesh)
        out[case] = res if rank == 0 else None
    return {"out": out, "offsets": offsets,
            "model_rank": mesh.get_local_rank("model")}


@pytest.fixture(scope="module")
def arrays():
    out = {}
    for seed, case in enumerate(CASES):
        jcfg, cfg = _cfgs(case)
        out[case] = (_tree(JM.init_params(jcfg, jax.random.PRNGKey(seed)),
                           seed),
                     TSYN.batch_for_config(cfg, 0, B, S))
    return out


@pytest.fixture(scope="module")
def mesh_run(arrays, tmp_path_factory):
    return ranks.run_ranks(sp_rank, 4, str(tmp_path_factory.mktemp("rdv")),
                           args=(arrays,), device="cpu", timeout=600)


@pytest.fixture(scope="module")
def unsharded(arrays):
    saved = flags.FLASH_CHUNK, flags.LOSS_CHUNK
    _blocks()
    try:
        return {case: _steps(_cfgs(case)[1], *arrays[case])
                for case in CASES}
    finally:
        flags.FLASH_CHUNK, flags.LOSS_CHUNK = saved


@pytest.fixture(scope="module")
def jax_ref(arrays):
    """Each case's JAX (logits, loss, gradients by name), computed once."""
    done = {}

    def get(case):
        if case not in done:
            done[case] = _jax(case, arrays)
        return done[case]
    return get


def _jax(case, arrays):
    jcfg, cfg = _cfgs(case)
    tree, batch = arrays[case]
    params = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = JD.prefill(jcfg, params, {k: v for k, v in jb.items()
                                          if k != "labels"}, S)
    loss, grads = jax_value_and_grad(jcfg, 512)(params, jb)
    model = interop.params_from_arrays(cfg, tree)
    return (np.asarray(logits, np.float32), float(loss),
            interop.arrays_by_name(cfg, jax.tree.map(np.asarray, grads),
                                   model))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_equals_unsharded_and_jax(mesh_run, unsharded, jax_ref,
                                          case):
    got, want = mesh_run[0]["out"][case], unsharded[case]
    np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    np.testing.assert_allclose(got["logits"], jax_ref(case)[0], **TOL)
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, v in want["cache"].items():
        np.testing.assert_allclose(got["cache"][k], v, **TOL, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_equals_unsharded_and_jax(mesh_run, unsharded, jax_ref,
                                             case):
    got, want = mesh_run[0]["out"][case], unsharded[case]
    _, jloss, jgrads = jax_ref(case)
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["loss"], jloss, **TOL)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in want["grads"].items():
        assert np.abs(g).max() > 0 or "router" in name, name
        np.testing.assert_allclose(got["grads"][name], g, **GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got["grads"][name], jgrads[name],
                                   **GRAD_TOL, err_msg=name)


def test_odd_heads_attend_by_sequence_block(mesh_run):
    """With three query heads each `model` rank attends for its block of
    the 32 positions (offset 16 on the second); with heads that divide,
    every rank attends for the whole sequence (offset 0)."""
    for res in mesh_run:
        for case, offs in res["offsets"].items():
            if case.startswith("mamba2"):
                assert offs == set(), case
            elif case == "dense_tp":
                assert offs == {0}, case
            else:
                assert offs == {res["model_rank"] * S // 2}, case


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 7, 50.0), (False, 0, 0.0), (True, 17, 0.0)])
def test_flash_attention_query_offset(causal, window, cap):
    """Queries 13-28 of 37, in chunks of 8: the causal mask, the window
    and the skipped key blocks follow the offset."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, logit_cap=cap, q_chunk=8,
              k_chunk=8)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = L.flash_attention(qt[:, 13:29], kt, vt, q_offset=13, **kw)
    whole = L.flash_attention(qt, kt, vt, **kw)[:, 13:29]
    want = JL.flash_attention(jnp.asarray(q[:, 13:29]), jnp.asarray(k),
                              jnp.asarray(v), q_offset=13, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

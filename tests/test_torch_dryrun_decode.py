"""The decode step on sharded caches: the dry-run's decode bodies
(`launch/dryrun.py` `sharded_forwards`), on the fake production mesh and
on a real one, against the port's unsharded step and the JAX package's.

* Every family's smoke config on the fake 16 x 16 mesh: each decode_32k
  cell, and long_500k where `cell_applicable` allows it, is `ok` with
  every per-rank count above 0; gemma2-9b x long_500k at full width,
  whose global cache has its sequence on `data` and its head_dim on
  `model`.
* The 11 cells the JAX package lowers on 16 x 16 (its `lower_cell` and
  `compile`, in one subprocess on 512 host devices): a rank's parameter,
  cache and input bytes from the port's placements, of those the step
  reads, equal the reference's `argument_size_in_bytes`.
* One decode step on 4 gloo CPU ranks, a 2 x 2 (`data`, `model`) mesh,
  in each cache layout `cache_specs` makes there: KV heads on `model`
  (gemma2 smoke), head_dim on `model` (the same with one KV head), the
  sequence on `data` (batch 1: with the KV heads, and with the head_dim,
  on `model`), and the SSM caches (mamba2 and hymba smoke; mamba2 with
  one-wide heads has its state dim on `model`, hymba at batch 1 its
  state's heads on `data`), and decode's MoE (qwen3-moe and llama4
  smoke, the experts on `model`). The logits and every updated cache
  equal the port's unsharded `decode_step`, the logits the JAX
  `decode_step` on the same numpy weights (`interop`), fp32 within rtol =
  atol = 1e-5; where the sequence is sharded, only the ranks whose block
  holds the token's slot change their cache.
* `layers.combine_partials` over random splits of a cache equals the
  plain decode attention on the whole; the plain lse equals
  `jax.nn.logsumexp` of the reference's scores, soft cap and mask
  included.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from conftest import run_in_devices
from repro.configs import base as jbase
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import interop
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, cell_applicable, input_specs
from repro_torch.kernels import decode_attn as DA
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import model as MODEL
from repro_torch.parallel import ranks
from repro_torch.parallel import sharding as SH

TOL = dict(rtol=1e-5, atol=1e-5)
PER_RANK = ("param_bytes_per_rank", "cache_bytes_per_rank",
            "step_peak_bytes_per_rank_est", "flops_per_rank_est",
            "bytes_per_rank_est")

# --------------------------------------------------- the fake 16 x 16 mesh

# a smoke config of each family; the MoE's 8 experts become 16, so that
# they divide the `model` axis
SMOKE = [("stablelm-3b", {}), ("gemma2-9b", {}), ("internvl2-1b", {}),
         ("qwen3-moe-235b-a22b", {"n_experts": 16}),
         ("llama4-maverick-400b-a17b", {"n_experts": 16}),
         ("mamba2-2-7b", {}), ("hymba-1-5b", {}),
         ("seamless-m4t-medium", {})]
SMOKE_CELLS = [(a, over, s) for a, over in SMOKE
               for s in ("decode_32k", "long_500k")
               if cell_applicable(smoke_config(a), s)[0]]


@pytest.mark.parametrize("arch,over,shape", SMOKE_CELLS,
                         ids=[f"{a}-{s}" for a, _, s in SMOKE_CELLS])
def test_smoke_decode_cells_run(arch, over, shape):
    cfg = dataclasses.replace(smoke_config(arch), **over)
    rec = DR.run_cell(arch, shape, False, cfg=cfg)
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    for key in PER_RANK:
        assert rec[key] > 0, key
    coll = rec["collective_bytes_per_rank_est"]
    assert coll and all(v > 0 for v in coll.values()), coll
    assert rec["bytes_per_rank_est"] == rec["step_peak_bytes_per_rank_est"] \
        + rec["param_bytes_per_rank"] + rec["cache_bytes_per_rank"]


def test_gemma2_long_500k_at_full_width():
    """Batch 1: the global layers' cache [21, 1, 524,288, 8, 256] has its
    sequence on `data` and its head_dim on `model` (8 KV heads do not
    divide 16), so its attention all-reduces partial scores over `model`
    and combines the sequence shards over `data`."""
    cfg = get_config("gemma2-9b")
    cache = D.init_cache(cfg, 1, 524288, device="meta")
    with MESH.production_mesh(multi_pod=False) as mesh:
        specs = SH.cache_specs(cache, mesh, SH.AxisRules())
    assert specs["k_global"] == (None, None, "data", None, "model")
    assert specs["k_local"] == (None, None, "data", None, "model")
    rec = DR.run_cell("gemma2-9b", "long_500k", False)
    assert rec["status"] == "ok"
    # the reference's argument bytes less its tokens and positions
    assert rec["param_bytes_per_rank"] + rec["cache_bytes_per_rank"] == \
        500_132_864
    coll = rec["collective_bytes_per_rank_est"]
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    assert rec["bytes_per_rank_est"] < 80e9


# the cells the JAX package lowers on 16 x 16 (its decode with explicit
# mesh axes fails only in the MoE's sharding constraints)
LOWERED = [(a, "decode_32k") for a in (
    "stablelm-3b", "yi-9b", "yi-34b", "gemma2-9b", "internvl2-1b",
    "mamba2-2-7b", "hymba-1-5b", "seamless-m4t-medium")] + [
    (a, "long_500k") for a in ("gemma2-9b", "mamba2-2-7b", "hymba-1-5b")]

JAX_ARGS = """
from repro.launch import dryrun as JDR
for arch, shape in CELLS:
    _, _, _, lowered = JDR.lower_cell(arch, shape, False)
    mem = lowered.compile().memory_analysis()
    print("ARGS", arch, shape, int(mem.argument_size_in_bytes), flush=True)
"""


@pytest.fixture(scope="module")
def jax_argument_bytes():
    out = run_in_devices(f"CELLS = {LOWERED!r}\n" + JAX_ARGS, 512,
                         timeout=600)
    rows = [line.split() for line in out.splitlines()
            if line.startswith("ARGS ")]
    return {(a, s): int(n) for _, a, s, n in rows}


class _Reads(TorchDispatchMode):
    """The storages the ops run under it read."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.seen.update(t.untyped_storage().data_ptr() for t in
                         torch.utils._pytree.tree_leaves((args, kwargs))
                         if isinstance(t, torch.Tensor))
        return func(*args, **kwargs)


def _unread(arch):
    """What a decode step never reads, found by running one at smoke size:
    parameter names (layer indices as `*`) and inputs."""
    cfg = smoke_config(arch)
    model = MODEL.init_params(cfg, torch.Generator().manual_seed(0))
    inputs = {"tokens": torch.zeros((2, 1), dtype=torch.int32),
              "positions": torch.full((2,), 3, dtype=torch.int32)}
    with _Reads() as reads:
        D.decode_step(cfg, model, D.init_cache(cfg, 2, 8), **inputs)
    return ({_pattern(n) for n, p in model.named_parameters()
             if p.untyped_storage().data_ptr() not in reads.seen},
            {k for k, t in inputs.items()
             if t.untyped_storage().data_ptr() not in reads.seen})


def _pattern(name: str) -> str:
    return re.sub(r"\.\d+\.", ".*.", name)


@pytest.mark.parametrize("arch,shape", LOWERED,
                         ids=[f"{a}-{s}" for a, s in LOWERED])
def test_held_bytes_equal_the_references_arguments(jax_argument_bytes, arch,
                                                   shape):
    """The reference's jit drops the arguments its step never reads
    (`keep_unused=False`): at decode the encoder's weights and the
    cross-attention's key and value projections (seamless: the cross
    caches hold their products), and the positions of an attention-free
    model (mamba2). Of what the port's
    step reads (the same, found by running it), a rank's bytes are the
    reference's to the byte."""
    cfg = get_config(arch)
    params, ins = _unread(arch)
    assert params == ({p for p in map(_pattern, dict(
        MODEL.param_shapes(cfg).named_parameters()))
        if p.startswith("enc") or p.endswith(("xattn.wk", "xattn.wv"))}
        if cfg.family == "encdec" else set())
    assert ins == ({"positions"} if cfg.family == "ssm" else set())
    with MESH.production_mesh(multi_pod=False) as mesh:
        rules, ocfg = DR._setup(SH.AxisRules(), False, arch)
        full = MODEL.param_shapes(cfg)
        held = DR.held_bytes(cfg, full, shape, mesh, rules, ocfg)
        named = dict(full.named_parameters())
        specs = SH.param_specs(cfg, {n: tuple(p.shape) for n, p in
                                     named.items()}, mesh, rules)
        unread = {n: p for n, p in named.items() if _pattern(n) in params}
        inputs = {k: v for k, v in input_specs(cfg, shape).items()
                  if k in ("tokens", "positions") and k not in ins}
        in_bytes = DR._bytes_per_rank(
            inputs, SH.batch_specs(inputs, mesh, rules), mesh)
        skipped = DR._bytes_per_rank(unread, specs, mesh)
    assert held["param_bytes_per_rank"] - skipped + \
        held["cache_bytes_per_rank"] + in_bytes == \
        jax_argument_bytes[arch, shape]


# --------------------------------------------------- a real 2 x 2 mesh

MESH_SHAPE, MESH_NAMES = (2, 2), ("data", "model")
CTX = 64
# name: (arch, config overrides, batch, the positions of each step, each
# step from the same cache)
CASES = {
    "kv_heads": ("gemma2-9b", {}, 2, [[40, 9]]),
    "head_dim": ("gemma2-9b", {"n_kv": 1}, 2, [[40, 9]]),
    "sequence": ("gemma2-9b", {}, 1, [[40], [9]]),
    "sequence_head_dim": ("gemma2-9b", {"n_kv": 1}, 1, [[40], [9]]),
    "ssm_mamba2": ("mamba2-2-7b", {}, 2, [[40, 9]]),
    # one-wide SSM heads: `model` takes the state dim N, as hymba-1.5b's
    # P = 50 leaves it on 16 ranks (the read-out a partial sum)
    "ssm_state_dim": ("mamba2-2-7b", {"ssm_head_dim": 1}, 2, [[40, 9]]),
    "ssm_hymba": ("hymba-1-5b", {}, 2, [[40, 9]]),
    "ssm_hymba_batch1": ("hymba-1-5b", {}, 1, [[40], [9]]),
    # decode's MoE (`_sharded_moe_ffn`): the 8 experts on `model`, 4 a rank
    "moe_qwen3": ("qwen3-moe-235b-a22b", {}, 2, [[40, 9]]),
    "moe_llama4": ("llama4-maverick-400b-a17b", {}, 2, [[40, 9]]),
}


def _cfgs(case):
    arch, over, _, _ = CASES[case]
    return (dataclasses.replace(jbase.smoke_config(arch), dtype="float32",
                                **over),
            dataclasses.replace(smoke_config(arch), dtype="float32", **over))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _case_arrays(case, seed):
    """The case's weights (the JAX package's init, norms made random),
    a random cache of CTX positions and the tokens, as numpy."""
    jcfg, cfg = _cfgs(case)
    _, _, b, _ = CASES[case]
    rng = np.random.default_rng(seed)
    tree = _flat(JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    for k in tree:
        if k.rsplit("/", 1)[-1] in ("ln1", "ln2", "lnx", "final_norm",
                                    "norm"):
            tree[k] = (0.5 * rng.standard_normal(tree[k].shape)).astype(
                np.float32)
    cache = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
             for k, v in D.init_cache(cfg, b, CTX, device="meta").items()}
    tokens = rng.integers(0, cfg.vocab, (b, 1), dtype=np.int32)
    return tree, cache, tokens


def decode_rank(rank, group, device, arrays):
    """Each case's steps on DTensors of the 2 x 2 mesh under the dry-run's
    `sharded_forwards`: rank 0 returns the logits and caches whole; every
    rank whether each cache key's local block changed."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_NAMES)
    rules = SH.AxisRules()
    out = {}
    for case, (tree, cache_np, tokens) in arrays.items():
        _, cfg = _cfgs(case)
        model = DR.shard_model(interop.params_from_arrays(cfg, _nest(tree)),
                               cfg, mesh, rules)
        steps = []
        for pos in CASES[case][3]:
            cache = DR.shard_cache(interop.cache_from_arrays(cfg, cache_np),
                                   mesh, rules)
            before = {k: v.to_local().clone() for k, v in cache.items()}
            inputs = {"tokens": torch.from_numpy(tokens),
                      "positions": torch.tensor(pos, dtype=torch.int32)}
            specs = SH.batch_specs(inputs, mesh, rules)
            inputs = {k: SH.distribute(v, mesh, specs[k])
                      for k, v in inputs.items()}
            with SH.activate(mesh, rules), implicit_replication(), \
                    DR.sharded_forwards():
                logits, cache = D.decode_step(cfg, model, cache,
                                              inputs["tokens"],
                                              inputs["positions"])
            # (gathers: every rank takes part)
            whole = {k: v.full_tensor().numpy() for k, v in cache.items()}
            logits = logits.full_tensor().numpy()
            steps.append(dict(
                logits=logits if rank == 0 else None,
                cache=whole if rank == 0 else None,
                changed={k: not torch.equal(before[k], v.to_local())
                         for k, v in cache.items()},
                specs=SH.cache_specs(cache, mesh, rules),
                data_rank=mesh.get_local_rank("data")))
        out[case] = steps
    return out


@pytest.fixture(scope="module")
def arrays():
    return {case: _case_arrays(case, seed)
            for seed, case in enumerate(CASES)}


@pytest.fixture(scope="module")
def mesh_run(arrays, tmp_path_factory):
    return ranks.run_ranks(decode_rank, 4,
                           str(tmp_path_factory.mktemp("rdv")),
                           args=(arrays,), device="cpu", timeout=600)


def _unsharded(case, arrays, pos):
    """The port's decode step on whole tensors: (logits, cache)."""
    tree, cache_np, tokens = arrays[case]
    _, cfg = _cfgs(case)
    model = interop.params_from_arrays(cfg, _nest(tree))
    logits, cache = D.decode_step(cfg, model,
                                  interop.cache_from_arrays(cfg, cache_np),
                                  torch.from_numpy(tokens),
                                  torch.tensor(pos, dtype=torch.int32))
    return logits.numpy(), {k: v.numpy() for k, v in cache.items()}


def _jax(case, arrays, pos):
    tree, cache_np, tokens = arrays[case]
    jcfg, _ = _cfgs(case)
    logits, _ = JD.decode_step(
        jcfg, jax.tree.map(jnp.asarray, _nest(tree)),
        {k: jnp.asarray(v) for k, v in cache_np.items()},
        jnp.asarray(tokens), jnp.asarray(pos, jnp.int32))
    return np.asarray(logits, np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_equals_unsharded_and_jax(mesh_run, arrays, case):
    for step, pos in enumerate(CASES[case][3]):
        got = mesh_run[0][case][step]
        logits, cache = _unsharded(case, arrays, pos)
        np.testing.assert_allclose(got["logits"], logits, **TOL)
        np.testing.assert_allclose(got["logits"], _jax(case, arrays, pos),
                                   **TOL)
        assert sorted(got["cache"]) == sorted(cache)
        for k, v in cache.items():
            np.testing.assert_allclose(got["cache"][k], v, **TOL,
                                       err_msg=k)
            assert not np.array_equal(v, arrays[case][1][k]), k


def _layout(case):
    """The mesh axes of the case's attention and SSM caches' dims."""
    _, cfg = _cfgs(case)
    _, _, b, _ = CASES[case]
    cache = D.init_cache(cfg, b, CTX, device="meta")
    with MESH.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_NAMES)
        return SH.cache_specs(cache, mesh, SH.AxisRules())


def test_the_cases_cover_the_layouts():
    """On the 2 x 2 mesh the cases place their caches as named."""
    specs = {case: _layout(case) for case in CASES}
    assert specs["kv_heads"]["k_global"] == (None, ("data",), None,
                                             "model", None)
    assert specs["head_dim"]["k_global"] == (None, ("data",), None, None,
                                             "model")
    assert specs["sequence"]["k_global"] == (None, None, "data", "model",
                                             None)
    assert specs["sequence_head_dim"]["k_local"] == (None, None, "data",
                                                     None, "model")
    assert specs["ssm_mamba2"]["state"] == (None, ("data",), None,
                                            "model", None)
    assert specs["ssm_state_dim"]["state"] == (None, ("data",), None,
                                               None, "model")
    assert specs["ssm_hymba_batch1"]["state"] == (None, None, "data",
                                                  "model", None)
    assert specs["ssm_hymba_batch1"]["k"] == (None, None, "data", "model",
                                              None)


@pytest.mark.parametrize("case", ["sequence", "sequence_head_dim",
                                  "ssm_hymba_batch1"])
def test_sequence_write_touches_only_the_owners_block(mesh_run, case):
    """Each KV cache whose sequence is on `data`: the ranks whose block
    holds the slot (position % window for a ring, else the position)
    change it, the others keep it bit for bit."""
    _, cfg = _cfgs(case)
    n = MESH_SHAPE[0]
    for step, (pos,) in enumerate(CASES[case][3]):
        seen = 0
        for rank_out in mesh_run:
            got = rank_out[case][step]
            for key, spec in got["specs"].items():
                if len(spec) < 5 or spec[2] != "data" or key == "state":
                    continue
                wc = min(CTX, cfg.sliding_window) if (
                    "local" in key or key == "k" or key == "v") and \
                    cfg.sliding_window else CTX
                slot = pos % wc if wc < CTX else min(pos, CTX - 1)
                owner = slot // (wc // n)
                assert got["changed"][key] == (got["data_rank"] == owner), \
                    (key, step, got["data_rank"])
                seen += 1
        assert seen


# ------------------------------------------------- the lse and the combine

def _attn_inputs(seed, b, s, k, g, h):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, k, g, h)).astype(np.float32)
    kc = rng.standard_normal((b, s, k, h)).astype(np.float32)
    vc = rng.standard_normal((b, s, k, h)).astype(np.float32)
    return q, kc, vc, rng


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("seed", range(3))
def test_combine_partials_equals_the_whole_cache(seed, cap):
    """Random cuts of S into 1-5 shards; each shard attends with its own
    cache_len (0 past the row's length) and gives its lse: the combine
    equals the plain attention over the whole cache, a shard with nothing
    valid gives lse -inf and weighs nothing."""
    b, s, k, g, h = 3, 97, 2, 3, 16
    q, kc, vc, rng = _attn_inputs(seed, b, s, k, g, h)
    if cap:
        q = q * 30.0
    clen = np.array([s, 1, int(rng.integers(2, s))], np.int32)
    cuts = np.sort(rng.choice(np.arange(1, s), int(rng.integers(0, 5)),
                              replace=False))
    bounds = [0, *cuts.tolist(), s]
    qt, kt, vt = map(torch.from_numpy, (q, kc, vc))
    lens = torch.from_numpy(clen)
    outs, lses = [], []
    for a, z in zip(bounds[:-1], bounds[1:]):
        o, lse = DA.decode_attention_plain(
            qt, kt[:, a:z], vt[:, a:z],
            (lens - a).clamp(0, z - a).to(torch.int32), logit_cap=cap,
            return_lse=True)
        assert o.dtype == lse.dtype == torch.float32
        assert bool(torch.isneginf(lse[lens <= a]).all())
        outs.append(o)
        lses.append(lse)
    got = L.combine_partials(torch.stack(outs), torch.stack(lses))
    want = DA.decode_attention_plain(qt, kt, vt, lens, logit_cap=cap)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_plain_lse_equals_logsumexp_of_the_references_scores(cap):
    """`src/repro/models/layers.py` decode_attention's scores (scaled,
    soft-capped, masked to -1e30 from cache_len on): their logsumexp is the
    plain form's lse, on rows with a valid position; a row with none has
    lse -inf and output 0 (the reference's jnp form gives the mean of V
    there)."""
    b, s, k, g, h = 3, 50, 2, 2, 16
    q, kc, vc, _ = _attn_inputs(7, b, s, k, g, h)
    q = q * (30.0 if cap else 1.0)
    clen = np.array([s, 17, 0], np.int32)
    scores = jnp.einsum("bkgh,bskh->bkgs", jnp.asarray(q),
                        jnp.asarray(kc)) * h ** -0.5
    scores = JL.softcap(scores, cap)
    valid = jnp.arange(s)[None] < jnp.asarray(clen)[:, None]
    scores = jnp.where(valid[:, None, None], scores, JL.NEG_INF)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1))
    out, lse = DA.decode_attention_plain(
        *map(torch.from_numpy, (q, kc, vc, clen)), logit_cap=cap,
        return_lse=True)
    np.testing.assert_allclose(lse[:2].numpy(), want[:2], **TOL)
    assert bool(torch.isneginf(lse[2]).all()) and not bool(out[2].any())


def test_layers_lse_comes_by_head_and_empty_inputs_give_minus_inf():
    """`layers.decode_attention(return_lse=True)`: out [B, 1, H, h] and
    lse [B, 1, H] in fp32, the heads in q's order (kv head, then its
    group); an empty cache gives zeros and -inf without a launch."""
    b, s, k, g, h = 2, 20, 2, 3, 8
    q, kc, vc, _ = _attn_inputs(3, b, s, k, g, h)
    qt = torch.from_numpy(q).reshape(b, 1, k * g, h).to(torch.bfloat16)
    kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (kc, vc))
    lens = torch.tensor([s, 5], dtype=torch.int32)
    out, lse = L.decode_attention(qt, kt, vt, lens, return_lse=True)
    assert out.shape == (b, 1, k * g, h) and lse.shape == (b, 1, k * g)
    assert out.dtype == lse.dtype == torch.float32
    o2, l2 = DA.decode_attention_plain(qt.reshape(b, k, g, h), kt, vt, lens,
                                       return_lse=True)
    assert torch.equal(out.reshape(b, k, g, h), o2)
    assert torch.equal(lse.reshape(b, k, g), l2)
    assert torch.equal(L.decode_attention(qt, kt, vt, lens),
                       o2.to(torch.bfloat16).reshape(b, 1, k * g, h))
    z, zl = L.decode_attention(qt, kt[:, :0], vt[:, :0], lens,
                               return_lse=True)
    assert not bool(z.any()) and bool(torch.isneginf(zl).all())


def test_a_layout_no_body_takes_raises():
    """A Partial placement, and a cache dim sharded over two mesh axes
    where a body communicates, are refused by name."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Shard
    with MESH.fake_world(4):
        mesh = init_device_mesh("cpu", MESH_SHAPE, mesh_dim_names=MESH_NAMES)
        t = DTensor.from_local(torch.zeros(2, 4), mesh,
                               [Partial(), Shard(1)], run_check=False)
        with pytest.raises(ValueError, match="not taken"):
            DR._spec_of(t)
        t = DTensor.from_local(torch.zeros(2, 4), mesh,
                               [Shard(1), Shard(1)], run_check=False)
        assert DR._spec_of(t) == (None, ("data", "model"))
        with pytest.raises(ValueError, match="one axis"):
            DR._axis(("data", "model"), "sequence")

"""The port's sharding rules (`parallel/sharding.py`) and meshes
(`launch/mesh.py`) against the JAX package's: every parameter, input and
cache spec equal, leaf by leaf, for every arch on the 16 x 16 and
2 x 16 x 16 production meshes; the constraints are no-ops off a mesh; the
fake world of the production meshes never outlives its helper."""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import shapes as JS
from repro.configs.base import ARCHS, get_config as jget
from repro.models import decode as JD
from repro.models import model as JMODEL
from repro.parallel import sharding as JSH
from repro_torch import interop
from repro_torch.configs import shapes as TS
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as MESH
from repro_torch.models import decode as D
from repro_torch.models import model as MODEL
from repro_torch.parallel import sharding as SH
from test_sharding import mk_mesh

MESHES = [(False, (16, 16), ("data", "model")),
          (True, (2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["16x16", "2x16x16"]


def _norm(spec) -> tuple:
    """A spec's entries, a 1-tuple read as its name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jax_by_name(cfg, tree, model) -> dict:
    """The JAX spec of each of `model`'s parameters (`interop`'s name map;
    a stacked leaf's leading scan entry dropped)."""
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("layers", "enc"):
            node, _ = interop._stack_entry(cfg, tree, parts[0],
                                           int(parts[1]))
            parts, stacked = parts[2:], True
        else:
            node, stacked = tree, False
        for part in parts:
            node = node[part]
        spec = tuple(node)
        if stacked:
            assert spec[0] is None, (name, spec)
            spec = spec[1:]
        out[name] = _norm(spec)
    return out


@pytest.mark.parametrize("multi_pod,shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, multi_pod, shape, axes):
    jcfg, cfg = jget(arch), get_config(arch)
    jspecs = JSH.param_specs(jcfg, JMODEL.param_shapes(jcfg),
                             mk_mesh(shape, axes), JSH.AxisRules())
    model = MODEL.param_shapes(cfg)
    want = _jax_by_name(cfg, jspecs, model)
    with MESH.production_mesh(multi_pod=multi_pod) as mesh:
        got = SH.param_specs(cfg, {n: p.shape for n, p in
                                   model.named_parameters()}, mesh,
                             SH.AxisRules())
    assert set(got) == set(want)
    for name in want:
        assert _norm(got[name]) == want[name], name


@pytest.mark.parametrize("multi_pod,shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, multi_pod, shape, axes):
    jcfg, cfg = jget(arch), get_config(arch)
    jmesh = mk_mesh(shape, axes)
    with MESH.production_mesh(multi_pod=multi_pod) as mesh:
        for cell in TS.SHAPES.values():
            jin = JS.input_specs(jcfg, cell.name)
            want = jax.tree.map(lambda s: _norm(s), JSH.batch_specs(
                jin, jmesh, JSH.AxisRules()),
                is_leaf=lambda x: isinstance(x, P))
            got = SH.batch_specs(TS.input_specs(cfg, cell.name), mesh,
                                 SH.AxisRules())
            assert {k: _norm(v) for k, v in got.items()} == want, cell.name
            if cell.kind != "decode":
                continue
            enc = min(cell.seq_len, 32768)
            jc = JD.cache_shapes(jcfg, cell.global_batch, cell.seq_len,
                                 enc_len=enc)
            want = jax.tree.map(lambda s: _norm(s), JSH.cache_specs(
                jc, jmesh, JSH.AxisRules()),
                is_leaf=lambda x: isinstance(x, P))
            cache = D.init_cache(cfg, cell.global_batch, cell.seq_len,
                                 enc_len=enc, device="meta")
            got = SH.cache_specs(cache, mesh, SH.AxisRules())
            assert {k: _norm(v) for k, v in got.items()} == want, cell.name


def test_tp_actually_used_for_mlp():
    cfg = get_config("yi_9b")
    shapes = {n: p.shape for n, p in
              MODEL.param_shapes(cfg).named_parameters()}
    with MESH.production_mesh() as mesh:
        specs = SH.param_specs(cfg, shapes, mesh, SH.AxisRules())
    assert "model" in specs["layers.0.mlp.wg"]
    assert specs["layers.0.mlp.wg"] == (("data",), "model")


def test_constraints_noop_off_mesh():
    x = torch.ones(4, 8)
    logits = torch.ones(2, 4, 16)
    assert SH.constrain_batch(x) is x
    assert SH.constrain_spec(x, "batch", None) is x
    assert SH.constrain_ce(logits) is logits
    assert SH.constrain(x, None, ("data", None)) is x
    # a plain tensor under an ambient mesh is left alone too
    with MESH.fake_world(4):
        mesh = MESH.make_debug_mesh(2, 2)
        with SH.activate(mesh, SH.AxisRules()):
            assert SH.constrain_batch(x) is x
            assert SH.constrain_spec(x, "batch", None) is x
            assert SH.constrain_ce(logits) is logits
            assert SH.constrain(x, mesh, ("data", None)) is x
        assert SH._ambient() == (None, None)


def test_placements_of_a_tuple_entry():
    with MESH.production_mesh(multi_pod=True) as mesh:
        assert SH.placements((("pod", "data"), "model", None), mesh) == (
            Shard(0), Shard(0), Shard(1))
        assert SH.placements((None, ("data",)), mesh) == (
            Replicate(), Shard(1), Replicate())
        assert SH.placements(("model", None), mesh) == (
            Replicate(), Replicate(), Shard(0))
        with pytest.raises(ValueError, match="order"):
            SH.placements((("data", "pod"),), mesh)
        with pytest.raises(ValueError, match="twice"):
            SH.placements(("data", "data"), mesh)


def test_constrain_redistributes_a_dtensor():
    """On a mesh a constraint moves a DTensor to the spec's placements."""
    with MESH.fake_world(4):
        mesh = MESH.make_debug_mesh(2, 2)
        x = SH.distribute(torch.ones(4, 8), mesh, (None, None))
        with SH.activate(mesh, SH.AxisRules()):
            y = SH.constrain_spec(x, "batch", "tp")
        assert y.placements == (Shard(0), Shard(1))
        assert SH.constrain(y, mesh, (None, None)).placements == (
            Replicate(), Replicate())


@pytest.mark.parametrize("raises", [False, True])
def test_fake_world_is_gone_after_the_helpers(raises):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError) if raises else _nothing():
        with MESH.production_mesh() as mesh:
            assert dist.is_initialized() and dist.get_world_size() == 256
            assert mesh.mesh_dim_names == ("data", "model")
            assert tuple(mesh.shape) == (16, 16)
            if raises:
                raise RuntimeError("inside")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 512"):
        MESH.make_production_mesh(multi_pod=True)
    assert not dist.is_initialized()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

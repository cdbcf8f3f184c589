"""The dry-run's train and prefill cells under sequence parallelism
(`launch/dryrun.py`, `AxisRules()`: the sequence on `model` between
layers), on the fake production meshes, against the JAX package's
lowering.

* Every family's smoke config on the fake 16 x 16 mesh: each prefill_32k
  cell, and the train_4k cells `test_torch_dryrun.py` does not run
  (gemma2's local/global pairs, llama4's dense/MoE pairs), is `ok` with
  `seq_axis` "model" and every per-rank count above 0.
* The JAX package lowers and compiles every smoke train_4k and
  prefill_32k cell on a mesh of `Auto` axes (`jax.sharding.Mesh` on 512
  host devices, in one subprocess, through `scripts/reference_lowering.py`,
  which replaces `repro.launch.dryrun.make_production_mesh` there;
  `jax.make_mesh` builds `Explicit` axes, on which its sharding
  constraints raise). A
  rank's bytes of parameters, moments and inputs from the port's
  placements equal the reference's `argument_size_in_bytes` in each (the
  optimizer's int32 step counter, 4 bytes, is the reference's only other
  argument), on 16 x 16 and for the giant MoEs' FSDP over (pod, data) on
  2 x 16 x 16.
"""
import dataclasses
import json
import pathlib

import pytest
import torch.distributed as dist

from conftest import run_in_devices
from repro_torch.configs.base import smoke_config
from repro_torch.configs.shapes import input_specs
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.models import flags
from repro_torch.models import model as MODEL
from repro_torch.parallel import sharding as SH

# a smoke config of each family; the MoE's 8 experts become 16, so that
# they divide the `model` axis
SMOKE = {"stablelm-3b": {}, "gemma2-9b": {}, "internvl2-1b": {},
         "qwen3-moe-235b-a22b": {"n_experts": 16},
         "llama4-maverick-400b-a17b": {"n_experts": 16},
         "mamba2-2-7b": {}, "hymba-1-5b": {}, "seamless-m4t-medium": {}}
CELLS = [(a, "prefill_32k") for a in SMOKE] + [
    ("gemma2-9b", "train_4k"), ("llama4-maverick-400b-a17b", "train_4k")]
PER_RANK = ("param_bytes_per_rank", "step_peak_bytes_per_rank_est",
            "flops_per_rank_est", "bytes_per_rank_est")


def _cfg(arch):
    return dataclasses.replace(smoke_config(arch), **SMOKE.get(arch, {}))


@pytest.fixture
def one_block(monkeypatch):
    """One attention block and one loss chunk a sequence: the same counts
    of work up to the causal block skipping, with far fewer ops to run."""
    monkeypatch.setattr(flags, "FLASH_CHUNK", 1 << 20)
    monkeypatch.setattr(flags, "LOSS_CHUNK", 1 << 20)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_smoke_cells_run_sequence_parallel(arch, shape, one_block):
    rec = DR.run_cell(arch, shape, False, cfg=_cfg(arch))
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["seq_axis"] == "model"
    assert rec["n_devices"] == 256
    for key in PER_RANK:
        assert rec[key] > 0, key
    assert rec["flops_per_rank_est"] * 256 >= rec["model_flops"]
    coll = rec["collective_bytes_per_rank_est"]
    assert coll.get("all-gather", 0) > 0
    assert rec["bytes_per_rank_est"] == rec["step_peak_bytes_per_rank_est"] \
        + rec["param_bytes_per_rank"] + rec.get("moment_bytes_per_rank", 0)


ARCHS = ["stablelm-3b", "yi-9b", "yi-34b", "gemma2-9b", "internvl2-1b",
         "mamba2-2-7b", "qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
         "hymba-1-5b", "seamless-m4t-medium"]
LOWERED = [(a, s, False) for a in ARCHS for s in ("train_4k",
                                                  "prefill_32k")] + [
    (a, "train_4k", True) for a in ("qwen3-moe-235b-a22b",
                                    "llama4-maverick-400b-a17b")]

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"
JAX_ARGS = """
import dataclasses
import json
import sys
from repro.configs.base import smoke_config
sys.path.insert(0, SCRIPTS)
from reference_lowering import lower

for arch, shape, multi_pod in CELLS:
    cfg = smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=16)
    print("ARGS", json.dumps(lower(arch, shape, multi_pod, cfg)), flush=True)
"""


@pytest.fixture(scope="module")
def jax_argument_bytes():
    out = run_in_devices(f"CELLS = {LOWERED!r}\nSCRIPTS = {str(SCRIPTS)!r}\n"
                         + JAX_ARGS, 512, timeout=900)
    recs = [json.loads(line[5:]) for line in out.splitlines()
            if line.startswith("ARGS ")]
    return {(r["arch"], r["shape"], r["mesh"] == "2x16x16"):
            r.get("arg_bytes", r.get("error")) for r in recs}


@pytest.mark.parametrize("arch,shape,multi_pod", LOWERED,
                         ids=[f"{a}-{s}-{'2x16x16' if m else '16x16'}"
                              for a, s, m in LOWERED])
def test_argument_bytes_equal_the_references(jax_argument_bytes, arch,
                                             shape, multi_pod):
    cfg = _cfg(arch)
    with MESH.production_mesh(multi_pod=multi_pod) as mesh:
        rules, ocfg = DR._setup(SH.AxisRules(), multi_pod, arch)
        held = DR.held_bytes(cfg, MODEL.param_shapes(cfg), shape, mesh,
                             rules, ocfg)
        inputs = input_specs(cfg, shape)
        in_bytes = DR._bytes_per_rank(
            inputs, SH.batch_specs(inputs, mesh, rules), mesh)
    step = 4 if shape == "train_4k" else 0
    assert held["param_bytes_per_rank"] + held.get(
        "moment_bytes_per_rank", 0) + in_bytes + step == \
        jax_argument_bytes[arch, shape, multi_pod]


def test_sequence_bodies_need_one_axis():
    """The sharded bodies sum tensor-parallel partials in the sequence's
    collectives: a sequence on another axis than the tensor-parallel one
    raises instead of summing over the wrong group."""
    with MESH.fake_world(4):
        mesh = MESH.make_debug_mesh(2, 2)
        with SH.activate(mesh, SH.AxisRules()):
            assert DR._ambient()[1].seq_axis == "model"
        with SH.activate(mesh, SH.AxisRules(seq_axis=None)):
            assert DR._ambient()[1].seq_axis is None
        with SH.activate(mesh, SH.AxisRules(seq_axis="data")), \
                pytest.raises(ValueError, match="one axis"):
            DR._ambient()

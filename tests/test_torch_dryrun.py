"""The port's dry-run (`launch/dryrun.py`) against the JAX package's on the
CPU: the parameter counts and model FLOPs of every arch x shape, records
of a smoke config of each family on the fake 16 x 16 mesh, one cell at
full width (stablelm-3b x train_4k), the skipped cell, the CLI's file.

`repro.launch.dryrun` sets `XLA_FLAGS` for 512 host devices when it is
imported; it is imported only after this worker's JAX backend is up, and
the variable is restored at once, so neither this worker nor a process
it starts later sees 512 devices.
"""
import dataclasses
import json
import os

import jax
import pytest
import torch.distributed as dist

from repro.configs.base import ARCHS, get_config as jget
from repro.configs.shapes import SHAPES
from repro.models import model as JMODEL
from repro_torch.configs.base import get_config, smoke_config
from repro_torch.launch import dryrun as DR
from repro_torch.models import flags
from repro_torch.models import model as MODEL


@pytest.fixture(scope="module")
def jdr():
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_equal_jax(jdr, arch):
    jcfg, cfg = jget(arch), get_config(arch)
    jshapes, model = JMODEL.param_shapes(jcfg), MODEL.param_shapes(cfg)
    assert DR.count_params(model) == jdr.count_params(jshapes)
    assert DR.active_params(cfg, model) == jdr.active_params(jcfg, jshapes)
    for shape in SHAPES:
        assert DR.model_flops(cfg, model, shape) == \
            jdr.model_flops(jcfg, jshapes, shape), shape
    assert DR.n_bodies(cfg) == jdr.n_bodies(jcfg)
    for b in (1, 2):
        assert dataclasses.asdict(DR.probe_cfg(cfg, b)) == \
            dataclasses.asdict(jdr.probe_cfg(jcfg, b))


@pytest.fixture
def one_block(monkeypatch):
    """One attention block and one loss chunk a sequence: the same counts
    of work up to the causal block skipping, with far fewer ops to run."""
    monkeypatch.setattr(flags, "FLASH_CHUNK", 1 << 20)
    monkeypatch.setattr(flags, "LOSS_CHUNK", 1 << 20)


# a smoke config of each family; the MoE's 8 experts become 16, so that
# they divide the `model` axis and the a2a schedule runs
FAMILIES = [("stablelm-3b", {}), ("qwen3-moe-235b-a22b", {"n_experts": 16}),
            ("hymba-1-5b", {}), ("seamless-m4t-medium", {}),
            ("internvl2-1b", {})]


@pytest.mark.parametrize("arch,over", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_smoke_records_by_family(arch, over, one_block):
    cfg = dataclasses.replace(smoke_config(arch), **over)
    rec = DR.run_cell(arch, "train_4k", False, cfg=cfg)
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_devices"] == 256 and rec["mesh_device"] == "cpu"
    assert rec["seq_axis"] == "model"
    model = MODEL.param_shapes(cfg)
    assert rec["params_total"] == DR.count_params(model)
    assert rec["model_flops"] == DR.model_flops(cfg, model, "train_4k")
    for key in ("param_bytes_per_rank", "grad_bytes_per_rank",
                "moment_bytes_per_rank", "step_peak_bytes_per_rank_est",
                "flops_per_rank_est"):
        assert rec[key] > 0, key
    assert rec["bytes_per_rank_est"] == (
        rec["step_peak_bytes_per_rank_est"] + rec["param_bytes_per_rank"]
        + rec["moment_bytes_per_rank"])
    # every rank computes at least its share of the step
    assert rec["flops_per_rank_est"] * 256 >= rec["model_flops"]
    coll = rec["collective_bytes_per_rank_est"]
    assert coll.get("all-gather", 0) > 0
    if cfg.n_experts:
        # the explicit dispatch and return of `moe_ffn_a2a`
        assert coll["all-to-all"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-2-7b", "hymba-1-5b"])
def test_ssm_train_cells_run(arch, multi_pod, one_block):
    """The SSD's train cells (on `aten.bmm` over strided shards before the
    SSD had its sequence-parallel body) are `ok` on both fake meshes."""
    rec = DR.run_cell(arch, "train_4k", multi_pod, cfg=smoke_config(arch))
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["seq_axis"] == "model"
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["flops_per_rank_est"] * rec["n_devices"] >= \
        rec["model_flops"]
    coll = rec["collective_bytes_per_rank_est"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0


def test_full_width_cell():
    """stablelm-3b x train_4k on the 16 x 16 mesh, at every published
    width (probes of one and two layers)."""
    rec = DR.run_cell("stablelm-3b", "train_4k", False)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["params_total"] == 2_666_498_560
    # bf16 weights sharded over all 256 ranks but for the norm scales
    # (2,560 each: two a layer and the final one), fp32 moments
    norms = 2560 * (2 * 32 + 1)
    per_rank = (rec["params_total"] - norms) // 256 + norms
    assert rec["param_bytes_per_rank"] == 2 * per_rank
    assert rec["moment_bytes_per_rank"] == 8 * per_rank
    assert rec["flops_per_rank_est"] * 256 >= rec["model_flops"]
    assert rec["bytes_per_rank_est"] < 80e9          # fits one H100
    coll = rec["collective_bytes_per_rank_est"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    p1, p2 = rec["probe_bodies"][1], rec["probe_bodies"][2]
    assert p2["flops"] > p1["flops"]


def test_long_500k_skipped_on_full_attention():
    rec = DR.run_cell("yi-9b", "long_500k", True)
    assert rec["status"] == "skipped" and rec["mesh"] == "2x16x16"
    assert "long_500k" in rec["reason"]
    assert not dist.is_initialized()


def test_cli_writes_one_record_a_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    args = ["--arch", "yi-9b", "--shape", "long_500k", "--out",
            str(out)]
    DR.main(args)
    DR.main(args)
    DR.main(args + ["--multi-pod"])
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["mesh"], r["status"]) for r in rows] == [
        ("yi-9b", "16x16", "skipped"), ("yi-9b", "2x16x16",
                                            "skipped")]
    DR.main(args + ["--skip-done"])
    assert "already done" in capsys.readouterr().out
    DR.append_result({"arch": "yi-9b", "shape": "long_500k",
                      "mesh": "16x16", "status": "error", "op": "aten.x"},
                     out)
    rows = json.loads(out.read_text())
    assert len(rows) == 2 and rows[-1]["status"] == "error"
    with pytest.raises(SystemExit):
        DR.main(["--arch", "yi-9b", "--out", str(out)])


def test_error_record_names_the_op():
    try:
        raise RuntimeError("Sharding propagation failed for "
                           "aten.index_put_.default(Spec(...))")
    except RuntimeError as e:
        rec = DR.error_record("yi-9b", "decode_32k", False, e)
    assert rec["op"] == "aten.index_put_.default"
    assert rec["status"] == "error" and "RuntimeError" in rec["error"]


@pytest.mark.parametrize("raises", [False, True])
def test_sharded_forwards_swap_only_inside(raises):
    """The dry-run's DTensor versions of the layers' products replace the
    plain ones only inside `sharded_forwards`, also when its body raises;
    inside, a plain tensor still takes the plain function."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import decode as D
    from repro_torch.models import mamba2 as M
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import sharding as SH
    names = ((L, "lookup"), (L, "project"), (L, "_out"), (L, "_mlp"),
             (L, "flash_attention"), (M, "ssm_forward"),
             (SH, "constrain_batch"), (MODEL, "nll_sum"), (MODEL, "_gold"),
             (D, "last_position"), (D, "_ring_pack"),
             (L, "decode_attention"), (D, "write_kv"), (M, "ssm_recur"),
             (MOE, "moe_ffn"))
    plain = {key: getattr(*key) for key in names}
    x, w = torch.ones(1, 2, 3), torch.ones(3, 4, 5)
    try:
        with DR.sharded_forwards():
            assert all(getattr(*key) is not plain[key] for key in names)
            assert torch.equal(L.project(x, w), plain[L, "project"](x, w))
            if raises:
                raise RuntimeError("inside")
    except RuntimeError:
        assert raises
    assert all(getattr(*key) is plain[key] for key in names)

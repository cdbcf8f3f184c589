"""The port's training state on the CPU: AdamW and its schedule, the train
step (with accumulation), checkpoints, the fault-tolerance helpers and the
launcher's restart, against the JAX package where it has a counterpart.

The optimizer and the train step start from the JAX package's state carried
over as numpy (`interop.params_from_arrays`, `interop.opt_state_from_arrays`),
fp32 unless said. `apply_updates` from the same numpy gradients agrees
within 1e-6 (within one bf16 step with bf16 moments). Three train steps
give the JAX losses within 1e-5 relative. The parameters are compared by
each leaf's update (after - before) within 1e-3 of its norm, not
elementwise: Adam's step g / (sqrt(v) + eps) is ill-conditioned where a
gradient entry is near zero, so rounding-level differences in the
gradient move such entries by up to the learning rate.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.data.synthetic import batch_for_config as jbatch_for_config
from repro.ft import elastic as JFT
from repro.models import model as JM
from repro.train import optimizer as JO
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import interop
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.configs import base as tbase
from repro_torch.ft import elastic as FT
from repro_torch.launch import train as LT
from repro_torch.models import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
B, S = 2, 32
LOSS_RTOL, UPDATE_RTOL = 1e-5, 1e-3
OCFG = O.OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10)


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype=dtype),
            dataclasses.replace(tbase.smoke_config(arch), dtype=dtype))


def carried(arch, seed=0):
    """(jcfg, cfg, JAX params, the port's Model) from one numpy tree."""
    jcfg, cfg = _configs(arch)
    tree = jax.tree.map(lambda a: np.array(a, np.float32),
                        JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            interop.params_from_arrays(cfg, tree))


def by_name(cfg, tree, model):
    return {k: np.asarray(v, np.float32) for k, v in interop.arrays_by_name(
        cfg, jax.tree.map(np.asarray, tree), model).items()}


def snapshot(model):
    return {n: p.detach().float().numpy().copy()
            for n, p in model.named_parameters()}


def batches(cfg, step, batch=B):
    b = jbatch_for_config(cfg, step, batch, S)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def assert_updates_match(before, after, want_after, what=""):
    """Each leaf's update within UPDATE_RTOL of the reference's (in its
    norm; exactly zero where the reference's is)."""
    for n, p0 in before.items():
        du, dw = after[n] - p0, want_after[n] - p0
        scale = float(np.linalg.norm(dw))
        err = float(np.linalg.norm(du - dw))
        assert err <= UPDATE_RTOL * scale, (what, n, err, scale)


# -------------------------------------------------------------- optimizer --

def _jax_opt(ocfg: O.OptConfig):
    return JO.OptConfig(**dataclasses.asdict(ocfg))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 101, 250])
def test_schedule_matches_jax(step):
    """Warmup, the peak, the cosine and the floor, within fp32 rounding."""
    cfg = O.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    got = O.schedule(torch.tensor(step, dtype=torch.int32), cfg)
    want = JO.schedule(jnp.int32(step), _jax_opt(cfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)
    assert float(O.schedule(step, cfg)) == float(got)


def test_schedule_shape():
    cfg = O.OptConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    assert float(O.schedule(0, cfg)) == 0.0
    assert abs(float(O.schedule(10, cfg)) - 1e-3) < 1e-9
    assert float(O.schedule(100, cfg)) <= 1e-3 * cfg.min_lr_ratio + 1e-9
    assert float(O.schedule(500, cfg)) == float(O.schedule(100, cfg))
    assert float(O.schedule(5, cfg)) < float(O.schedule(10, cfg))


def _random_state(jcfg, rng, mdt):
    """Gradients and a mid-run JAX optimizer state (step 3) as numpy
    param-shaped trees."""
    jshapes = JM.param_shapes(jcfg)

    def tree(f):
        return jax.tree.map(lambda s: f(s.shape), jshapes)
    grads = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    m = tree(lambda s: (0.1 * rng.standard_normal(s)).astype(mdt))
    v = tree(lambda s: (0.01 * rng.random(s)).astype(mdt))
    return grads, {"m": m, "v": v, "step": np.int32(3)}


ARCH = "stablelm_3b"


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(moments):
    """From the same numpy params, gradients and mid-run moments: the new
    params, moments, step, grad_norm and lr of one AdamW step."""
    jcfg, cfg, jparams, params = carried(ARCH)
    mdt = jnp.bfloat16 if moments == "bfloat16" else np.float32
    grads, st = _random_state(jcfg, np.random.default_rng(1), mdt)
    ocfg = dataclasses.replace(OCFG, moment_dtype=moments)
    jst = jax.tree.map(jnp.asarray, st)
    jp, jst2, jm = JO.apply_updates(jparams, jax.tree.map(jnp.asarray, grads),
                                    jst, _jax_opt(ocfg))
    state = interop.opt_state_from_arrays(cfg, st)
    mdt_t = torch.bfloat16 if moments == "bfloat16" else torch.float32
    assert all(t.dtype == mdt_t for t in state["m"].values())
    tgrads = {n: torch.from_numpy(np.ascontiguousarray(g))
              for n, g in interop.arrays_by_name(cfg, grads, params).items()}
    params, state, met = O.apply_updates(params, tgrads, state, ocfg)
    assert int(state["step"]) == int(jst2["step"]) == 4
    assert state["step"].dtype == torch.int32
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(met["lr"]), float(jm["lr"]), rtol=1e-6)
    want = by_name(cfg, jp, params)
    for n, p in params.named_parameters():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    # bf16 moments: within one bf16 step of the reference's (both round
    # the same fp32 value, up to its last bits)
    tol = (2 ** -7, 1e-30) if moments == "bfloat16" else (1e-6, 1e-6)
    for key in ("m", "v"):
        want = by_name(cfg, jst2[key], params)
        for n, t in state[key].items():
            assert t.dtype == mdt_t
            np.testing.assert_allclose(t.float().numpy(), want[n], *tol,
                                       err_msg=f"{key}/{n}")


class One(nn.Module):
    def __init__(self, value):
        super().__init__()
        self.w = nn.Parameter(value, requires_grad=False)


def test_adamw_moves_against_gradient():
    cfg = O.OptConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=10,
                      weight_decay=0.0)
    params = One(torch.ones(4))
    state = O.init_opt_state(params, cfg)
    params, state, _ = O.apply_updates(params, {"w": torch.ones(4)}, state,
                                       cfg)
    assert bool((params.w < 1.0).all())
    assert int(state["step"]) == 1


def test_clip_bounds_update():
    cfg = O.OptConfig(peak_lr=1.0, warmup_steps=0, decay_steps=10,
                      clip_norm=1.0, weight_decay=0.0)
    params = One(torch.zeros(1000))
    state = O.init_opt_state(params, cfg)
    grads = {"w": torch.full((1000,), 100.0)}
    assert float(O.global_norm(grads.values())) > 1000
    params, state, m = O.apply_updates(params, grads, state, cfg)
    assert float(m["grad_norm"]) > 1000  # reported pre-clip
    # the clipped gradient's first moment is 0.1 of the clipped entry
    np.testing.assert_allclose(state["m"]["w"].numpy(),
                               0.1 * 100.0 / float(m["grad_norm"]), rtol=1e-6)


def test_bf16_moments():
    cfg = O.OptConfig(moment_dtype="bfloat16")
    params = One(torch.ones(8))
    st = O.init_opt_state(params, cfg)
    assert st["m"]["w"].dtype == torch.bfloat16
    assert st["v"]["w"].dtype == torch.bfloat16
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


# ------------------------------------------------------------- train step --

_jsteps = {}


def jax_step(jcfg, ocfg, accum=1):
    key = (jcfg, accum)
    if key not in _jsteps:
        _jsteps[key] = jax.jit(jmake_train_step(jcfg, _jax_opt(ocfg),
                                                accum_steps=accum))
    return _jsteps[key]


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen3_moe_235b_a22b",
                                  "hymba_1_5b"])
def test_three_train_steps_match_jax(arch):
    jcfg, cfg, jparams, params = carried(arch)
    before = snapshot(params)
    jstate = JO.init_opt_state(jparams, _jax_opt(OCFG))
    state = interop.opt_state_from_arrays(
        cfg, jax.tree.map(np.asarray, jstate))
    jfn, fn = jax_step(jcfg, OCFG), make_train_step(cfg, OCFG)
    for step in range(3):
        jb, tb = batches(cfg, step)
        jparams, jstate, jm = jfn(jparams, jstate, jb)
        params, state, m = fn(params, state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL, err_msg=str(step))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert m["loss"].shape == () and not m["loss"].requires_grad
    assert int(state["step"]) == 3
    assert all(p.requires_grad for p in params.parameters())
    assert_updates_match(before, snapshot(params),
                         by_name(cfg, jparams, params), arch)


def test_accumulation_two_by_two_matches_batch_of_four():
    """accum_steps=2 on a batch of 4 against one batch of 4 (the same
    mean loss and, up to rounding, the same gradients, so the same
    update), and against the JAX package's accumulating step."""
    jcfg, cfg, jparams, params = carried("yi_9b")
    _, _, _, full = carried("yi_9b")
    before = snapshot(params)
    jb, tb = batches(cfg, 0, batch=4)
    jstate = JO.init_opt_state(jparams, _jax_opt(OCFG))
    jparams, _, jm = jax_step(jcfg, OCFG, accum=2)(jparams, jstate, jb)
    params, _, m = make_train_step(cfg, OCFG, accum_steps=2)(
        params, O.init_opt_state(params, OCFG), tb)
    full, _, mf = make_train_step(cfg, OCFG)(
        full, O.init_opt_state(full, OCFG), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"]), float(mf["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(mf["grad_norm"]),
                               rtol=1e-4)
    after = snapshot(params)
    assert_updates_match(before, after, by_name(cfg, jparams, params), "jax")
    assert_updates_match(before, after, snapshot(full), "batch of 4")


def test_loss_decreases_overfit():
    """stablelm smoke in its own dtype (bf16), one batch 12 times."""
    cfg = tbase.smoke_config("stablelm_3b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    ocfg = O.OptConfig(peak_lr=3e-3, warmup_steps=2, decay_steps=50)
    state = O.init_opt_state(params, ocfg)
    _, tb = batches(cfg, 0)
    step = make_train_step(cfg, ocfg)
    losses = []
    for _ in range(12):
        params, state, m = step(params, state, tb)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_trained_model_still_serves():
    """After a train step (weights requiring grad) prefill and decode run
    under no_grad: no graph, the caches written in place."""
    from repro_torch.train.serve_step import greedy_generate
    cfg = dataclasses.replace(tbase.smoke_config("stablelm_3b"),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    params, _, _ = make_train_step(cfg, OCFG)(
        params, O.init_opt_state(params, OCFG), batches(cfg, 0)[1])
    assert all(p.requires_grad for p in params.parameters())
    prompt = torch.zeros((2, 8), dtype=torch.int32)
    toks = greedy_generate(cfg, params, prompt, 4, 16)
    assert toks.shape == (2, 4) and not toks.requires_grad


# ------------------------------------------------------------- checkpoint --

def _tree(x=1.0):
    return {"a": torch.full((3, 2), x), "b": {"c": torch.arange(5)}}


def test_roundtrip(tmp_path):
    t = _tree(2.5)
    CKPT.save(tmp_path, 7, t, metadata={"note": "hi"})
    restored, step, meta = CKPT.restore(tmp_path, _tree())
    assert step == 7 and meta["note"] == "hi"
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["b"]["c"], t["b"]["c"])


def test_model_and_opt_state_roundtrip_bf16(tmp_path):
    """A bf16 model with bf16 moments after a train step: every leaf back
    bit for bit in its dtype, written as int16 bits (no ml_dtypes)."""
    cfg = tbase.smoke_config("qwen3_moe_235b_a22b")      # bf16, fp32 router
    ocfg = dataclasses.replace(OCFG, moment_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    state = O.init_opt_state(params, ocfg)
    params, state, _ = make_train_step(cfg, ocfg)(params, state,
                                                  batches(cfg, 0)[1])
    path = CKPT.save(tmp_path, 1, (params, state), metadata={"arch": "q"})
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["dtypes"]["0/embed.table"] == "bfloat16"
    assert manifest["dtypes"]["0/layers.0.moe.router"] == "float32"
    assert manifest["dtypes"]["1/m/embed.table"] == "bfloat16"
    assert manifest["dtypes"]["1/step"] == "int32"
    assert sorted(manifest["keys"]) == manifest["keys"]
    with np.load(path / "arrays.npz") as z:
        assert z["0/embed.table"].dtype == np.int16
    other = M.init_params(cfg, torch.Generator().manual_seed(1))
    (got, gstate), step, meta = CKPT.restore(
        tmp_path, (other, O.init_opt_state(other, O.OptConfig())))
    assert got is other and step == 1 and meta == {"arch": "q"}
    for (n, p), q in zip(params.named_parameters(), got.parameters()):
        assert q.dtype == p.dtype and torch.equal(q, p), n
    for key in ("m", "v"):
        for n, t in state[key].items():
            assert gstate[key][n].dtype == torch.bfloat16
            assert torch.equal(gstate[key][n], t), (key, n)
    assert gstate["step"].dtype == torch.int32 and int(gstate["step"]) == 1
    assert gstate["step"].shape == ()


def test_latest_pointer_and_gc(tmp_path):
    for s in (1, 2, 3, 4):
        CKPT.save(tmp_path, s, _tree(float(s)), keep=2)
    assert CKPT.latest_step(tmp_path) == 4
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_000000003", "step_000000004"]  # keep-k GC
    restored, step, _ = CKPT.restore(tmp_path, _tree())
    assert step == 4 and float(restored["a"][0, 0]) == 4.0
    restored, step, _ = CKPT.restore(tmp_path, _tree(), step=3)
    assert step == 3 and float(restored["a"][0, 0]) == 3.0


def test_torn_write_falls_back_to_newest_complete(tmp_path):
    CKPT.save(tmp_path, 1, _tree(1.0))
    CKPT.save(tmp_path, 2, _tree(2.0))
    (tmp_path / "step_000000002" / "manifest.json").unlink()
    assert CKPT.latest_step(tmp_path) == 1
    assert CKPT.restore(tmp_path, _tree())[1] == 1
    (tmp_path / "step_000000001" / "manifest.json").unlink()
    assert CKPT.latest_step(tmp_path) is None


def test_shape_mismatch_rejected(tmp_path):
    CKPT.save(tmp_path, 1, _tree())
    bad = {"a": torch.zeros((9, 9)), "b": {"c": torch.arange(5)}}
    with pytest.raises(ValueError):
        CKPT.restore(tmp_path, bad)
    cfg = tbase.smoke_config("yi_9b")
    CKPT.save(tmp_path, 2, M.init_params(cfg, torch.Generator().manual_seed(0)))
    wider = M.param_shapes(dataclasses.replace(cfg, d_model=128)).to_empty(
        device="cpu")
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(tmp_path, wider)


def test_missing_leaf_and_missing_dir(tmp_path):
    CKPT.save(tmp_path, 1, _tree())
    with pytest.raises(KeyError, match="b/d"):
        CKPT.restore(tmp_path, {"a": torch.zeros((3, 2)),
                                "b": {"d": torch.arange(5)}})
    with pytest.raises(FileNotFoundError):
        CKPT.restore(tmp_path / "nope", _tree())


# --------------------------------------------------------- fault tolerance --

@pytest.mark.parametrize("chips,mp,pods", [
    (512, 16, 2), (448, 16, 2), (500, 16, 2), (16, 16, 1), (40, 16, 1),
    (31, 16, 4), (1, 1, 1)])
def test_plan_remesh_matches_jax(chips, mp, pods):
    got = FT.plan_remesh(chips, model_parallel=mp, pods=pods)
    want = JFT.plan_remesh(chips, model_parallel=mp, pods=pods)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_plan_remesh_cases():
    assert FT.plan_remesh(512, 16, 2).shape == (2, 16, 16)
    p = FT.plan_remesh(500, model_parallel=16, pods=2)
    assert p.shape == (2, 15, 16) and p.dropped_chips == 500 - 480
    with pytest.raises(ValueError):
        FT.plan_remesh(8, model_parallel=16)


def test_watchdog():
    w = FT.StepWatchdog(factor=2.0)
    assert w.median is None and not w.is_straggler(100.0)
    for _ in range(5):
        w.record(1.0)
    assert not w.is_straggler(1.5)
    assert w.is_straggler(10.0)
    assert FT.straggler_budget(1.0) == 5.0  # floor
    assert FT.straggler_budget(4.0) == JFT.straggler_budget(4.0) == 8.0


# --------------------------------------------------------------- launcher --

def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    args = ["--arch", "stablelm-3b", "--smoke", "--batch", "2", "--seq",
            "32", "--device", "cpu", "--ckpt-every", "2"]
    whole = LT.main(args + ["--steps", "6", "--ckpt", str(tmp_path / "a")])
    first = LT.main(args + ["--steps", "4", "--ckpt", str(tmp_path / "b")])
    capsys.readouterr()
    rest = LT.main(args + ["--steps", "6", "--ckpt", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out
    assert "step=3 " not in out and "step=4 " in out and "step=5 " in out
    assert len(whole) == 6 and len(first) == 4 and len(rest) == 2
    assert first == whole[:4]
    np.testing.assert_allclose(rest, whole[4:], rtol=1e-6)
    assert CKPT.latest_step(tmp_path / "b") == 6
    with np.load(tmp_path / "b" / "step_000000006" / "arrays.npz") as z:
        assert z["1/step"].shape == () and int(z["1/step"]) == 6


def test_launcher_arch_families_on_cpu(capsys):
    """One step of the ssm family, the vision stub and encdec (the stubs'
    bf16 embeddings in a bf16 model), with accumulation."""
    for arch in ("mamba2-2-7b", "internvl2-1b", "seamless-m4t-medium"):
        losses = LT.main(["--arch", arch, "--smoke", "--steps", "2",
                          "--batch", "4", "--seq", "16", "--accum", "2",
                          "--device", "cpu"])
        assert len(losses) == 2 and np.isfinite(losses).all(), arch
    assert capsys.readouterr().out.count("[train] step=") == 6


def test_checkpoint_restart_integration(tmp_path):
    """Train 6 steps with a checkpoint every 3 in a child process; a
    second run of the same command up to 8 resumes from step 6, not 0."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "stablelm-3b", "--smoke", "--steps", "6", "--batch", "2",
           "--seq", "32", "--ckpt", str(tmp_path), "--ckpt-every", "3",
           "--device", "cpu"]
    r1 = subprocess.run(cmd, env=env, capture_output=True, text=True,
                        timeout=300)
    assert r1.returncode == 0, r1.stderr
    assert "step=5" in r1.stdout and "resumed" not in r1.stdout
    cmd2 = [c if c != "6" else "8" for c in cmd]
    r2 = subprocess.run(cmd2, env=env, capture_output=True, text=True,
                        timeout=300)
    assert r2.returncode == 0, r2.stderr
    assert "resumed from step 6" in r2.stdout
    assert "step=0 " not in r2.stdout
    assert "step=6" in r2.stdout and "step=7" in r2.stdout

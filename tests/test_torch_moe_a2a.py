"""`moe_ffn_a2a`, the explicit all-to-all expert-parallel schedule, on 4
gloo CPU ranks, against `moe_ffn` and against the JAX package's
`moe_ffn_a2a` run on 4 host devices on the same weights and inputs.

Cases (`CASES`), each forward and backward:
* a 2 x 2 (`data`, `model`) mesh at capacity factor 8, where nothing
  drops: equal to the port's `moe_ffn` and to the JAX `moe_ffn_a2a`;
* the same mesh at the config's 1.25, where each rank's capacity (from
  its own token count) drops assignments: equal to the JAX `moe_ffn_a2a`;
* a 2 x 2 x 1 (`pod`, `data`, `model`) mesh whose fsdp spans `pod` and
  `data`, at capacity factor 8: equal to the JAX `moe_ffn`. The JAX
  `moe_ffn_a2a` gathers a dim sharded over (pod, data) one axis at a
  time, major axis first, which leaves its rows out of order there; the
  port gathers minor axis first and gets them in mesh order.
Off a mesh and at decode (S = 1) the a2a entry is `moe_ffn` itself. The
JAX package's `tests/test_moe_a2a.py` holds its shard_map schedule
against its `moe_ffn` the same way."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_in_devices
from repro_torch.configs.base import smoke_config
from repro_torch.launch import mesh as MESH
from repro_torch.models import moe as MOE
from repro_torch.parallel import collectives as C
from repro_torch.parallel import ranks
from repro_torch.parallel import sharding as SH

TOL = dict(rtol=2e-5, atol=2e-5)
WEIGHTS = ("router", "wg", "wi", "wo")
QUANTITIES = ("y", "x") + WEIGHTS
CASES = {
    "data_model_cf8": dict(shape=(2, 2), names=("data", "model"),
                           batch=("data",), fsdp=("data",), cf=8.0, b=2),
    "data_model_cf1.25": dict(shape=(2, 2), names=("data", "model"),
                              batch=("data",), fsdp=("data",), cf=1.25,
                              b=2),
    "pod_data_fsdp_cf8": dict(shape=(2, 2, 1),
                              names=("pod", "data", "model"),
                              batch=("pod", "data"), fsdp=("pod", "data"),
                              cf=8.0, b=4),
}
S = 16


def _cfg(cf: float = 8.0):
    return dataclasses.replace(smoke_config("qwen3_moe_235b_a22b"),
                               dtype="float32", capacity_factor=cf)


def _inputs(cfg, b=2, s=S, seed=0):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    w = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "wg": rng.standard_normal((e, d, f)) * d ** -0.5,
         "wi": rng.standard_normal((e, d, f)) * d ** -0.5,
         "wo": rng.standard_normal((e, f, d)) * f ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    r = rng.standard_normal((b, s, d)).astype(np.float32)
    return w, x, r


def _case_inputs(case: str):
    c = CASES[case]
    return _inputs(_cfg(c["cf"]), b=c["b"])


def _moe(cfg, w, wrap=lambda name, t: t):
    mod = MOE.init_moe(cfg, torch.float32)
    for name in WEIGHTS:
        setattr(mod, name, torch.nn.Parameter(
            wrap(name, torch.from_numpy(w[name]))))
    return mod


def _reference(cfg, w, x, r):
    mod = _moe(cfg, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = MOE.moe_ffn(mod, xt, cfg)
    (y * torch.from_numpy(r)).sum().backward()
    return y.detach().numpy(), {"x": xt.grad.numpy(), **{
        n: getattr(mod, n).grad.numpy() for n in WEIGHTS}}


def a2a_rank(rank, group, device):
    """One rank: every case's y and gradients, whole."""
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for case, c in CASES.items():
        cfg = _cfg(c["cf"])
        w, x, r = _case_inputs(case)
        mesh = init_device_mesh("cpu", c["shape"],
                                mesh_dim_names=c["names"])
        rules = SH.AxisRules(batch_axes=c["batch"], fsdp_axes=c["fsdp"])
        specs = SH.param_specs(cfg, {n: w[n].shape for n in WEIGHTS}, mesh,
                               rules)
        mod = _moe(cfg, w, lambda n, t: SH.distribute(t, mesh, specs[n]))
        xs = (c["batch"], "model", None)
        xd = SH.distribute(torch.from_numpy(x), mesh, xs).requires_grad_(
            True)
        rd = SH.distribute(torch.from_numpy(r), mesh, xs)
        with SH.activate(mesh, rules):
            y = MOE.moe_ffn_a2a(mod, xd, cfg)
        assert tuple(y.placements) == SH.placements(xs, mesh)
        (y * rd).sum().backward()
        grads = {"x": xd.grad, **{n: getattr(mod, n).grad for n in WEIGHTS}}
        out[case] = (y.full_tensor().detach().numpy(),
                     {k: g.full_tensor().numpy() for k, g in grads.items()})
    return out


@pytest.fixture(scope="module")
def a2a_run(tmp_path_factory):
    cfg = _cfg()
    w, x, r = _case_inputs("data_model_cf8")
    outs = ranks.run_ranks(a2a_rank, 4, str(tmp_path_factory.mktemp("rdv")),
                           device="cpu", timeout=300)
    return _reference(cfg, w, x, r), outs


JAX_CODE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs.base import smoke_config
from repro.models import moe as MOE
from repro.parallel import sharding as SH

src, dst = sys.argv[1], sys.argv[2]
data = np.load(src)
out = {}
for case, (shape, names, batch, fsdp, cf) in CASES.items():
    cfg = dataclasses.replace(smoke_config("qwen3_moe_235b_a22b"),
                              dtype="float32", capacity_factor=cf)
    p = {n: jnp.asarray(data[case + "/" + n])
         for n in ("router", "wg", "wi", "wo")}
    x = jnp.asarray(data[case + "/x"])
    r = jnp.asarray(data[case + "/r"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), names)
    rules = SH.AxisRules(batch_axes=batch, fsdp_axes=fsdp)
    for impl in ("a2a", "moe_ffn"):
        fn = MOE.moe_ffn_a2a if impl == "a2a" else MOE.moe_ffn
        loss = lambda p, x: (fn(p, x, cfg) * r).sum()
        with SH.activate(mesh, rules):
            y = jax.jit(lambda p, x: fn(p, x, cfg))(p, x)
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
        key = case + "/" + impl + "/"
        out[key + "y"] = np.asarray(y)
        out[key + "x"] = np.asarray(gx)
        for n, g in gp.items():
            out[key + n] = np.asarray(g)
np.savez(dst, **out)
print("JAX_A2A_DONE")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """{case/impl/quantity: array} of the JAX package's `moe_ffn_a2a`
    ("a2a") and `moe_ffn` on 4 host devices, on each case's mesh."""
    tmp = tmp_path_factory.mktemp("jax_a2a")
    arrays = {}
    for case in CASES:
        w, x, r = _case_inputs(case)
        arrays.update({f"{case}/{n}": v for n, v in w.items()})
        arrays[f"{case}/x"], arrays[f"{case}/r"] = x, r
    np.savez(tmp / "in.npz", **arrays)
    cases = {k: (c["shape"], c["names"], c["batch"], c["fsdp"], c["cf"])
             for k, c in CASES.items()}
    code = (f"CASES = {cases!r}\n" + JAX_CODE).replace(
        "sys.argv[1], sys.argv[2]",
        f"{str(tmp / 'in.npz')!r}, {str(tmp / 'out.npz')!r}")
    assert "JAX_A2A_DONE" in run_in_devices(code, 4, timeout=420)
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("rank", range(4))
def test_a2a_equals_moe_ffn_on_2x2_gloo_ranks(a2a_run, rank):
    (y_ref, _), outs = a2a_run
    np.testing.assert_allclose(outs[rank]["data_model_cf8"][0], y_ref,
                               **TOL)


@pytest.mark.parametrize("name", ("x",) + WEIGHTS)
def test_a2a_gradients_equal_moe_ffn(a2a_run, name):
    (_, g_ref), outs = a2a_run
    for out in outs:
        grads = out["data_model_cf8"][1]
        assert np.isfinite(grads[name]).all()
        np.testing.assert_allclose(grads[name], g_ref[name], **TOL)


def _port(outs, case: str, quantity: str):
    """The quantity from every rank (each holds it whole)."""
    for out in outs:
        y, grads = out[case]
        got = y if quantity == "y" else grads[quantity]
        assert np.isfinite(got).all()
        yield got


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("case", ["data_model_cf8", "data_model_cf1.25"])
def test_a2a_equals_jax_a2a(a2a_run, jax_run, case, quantity):
    """The port's schedule against the reference's, capacity drops and
    the fsdp gather included."""
    want = jax_run[f"{case}/a2a/{quantity}"]
    for got in _port(a2a_run[1], case, quantity):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_a2a_with_fsdp_over_two_axes_equals_jax_moe_ffn(a2a_run, jax_run,
                                                         quantity):
    want = jax_run[f"pod_data_fsdp_cf8/moe_ffn/{quantity}"]
    for got in _port(a2a_run[1], "pod_data_fsdp_cf8", quantity):
        np.testing.assert_allclose(got, want, **TOL)


def test_capacity_drops_at_1_25(a2a_run):
    """At 1.25 each rank's capacity drops assignments of its own tokens,
    so the a2a differs from `moe_ffn` over all tokens: the case above
    holds the drops against the reference, not a no-drop path."""
    c = CASES["data_model_cf1.25"]
    cfg = _cfg(c["cf"])
    w, x, r = _case_inputs("data_model_cf1.25")
    p_data, p_model = c["shape"]
    b_loc, s_loc = c["b"] // p_data, S // p_model
    t = b_loc * s_loc
    cap = int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts) + 1
    dropped = 0
    for i in range(p_data):
        for j in range(p_model):
            block = x[i * b_loc:(i + 1) * b_loc, j * s_loc:(j + 1) * s_loc]
            keep = MOE._route(torch.from_numpy(w["router"]),
                              torch.from_numpy(block).reshape(t, -1), cfg,
                              cap)[-1]
            dropped += int((~keep).sum())
    assert dropped > 0
    y_global, _ = _reference(cfg, w, x, r)
    y = a2a_run[1][0]["data_model_cf1.25"][0]
    assert np.abs(y - y_global).max() > 1e-3


@pytest.mark.parametrize("where", ["off_mesh", "decode"])
def test_a2a_falls_back_to_moe_ffn(where, monkeypatch):
    """Off a mesh, and at S = 1 on one (the sequence does not divide over
    `model`), the a2a entry is `moe_ffn` on the same arguments."""
    cfg = _cfg()
    w, x, _ = _inputs(cfg, s=1 if where == "decode" else 16)
    mod = _moe(cfg, w)
    xt = torch.from_numpy(x)
    calls = []
    real = MOE.moe_ffn
    monkeypatch.setattr(MOE, "moe_ffn", lambda p, xx, c: calls.append(
        (p, xx, c)) or real(p, xx, c))
    if where == "off_mesh":
        y = MOE.moe_ffn_a2a(mod, xt, cfg)
    else:
        with MESH.fake_world(4):
            mesh = MESH.make_debug_mesh(2, 2)
            with SH.activate(mesh, SH.AxisRules()):
                y = MOE.moe_ffn_a2a(mod, xt, cfg)
    assert len(calls) == 1 and calls[0][0] is mod and calls[0][1] is xt
    np.testing.assert_array_equal(y.detach().numpy(),
                                  real(mod, xt, cfg).detach().numpy())


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_staged_gathers_cuda_tensors_through_the_host_on_gloo(backend,
                                                              monkeypatch):
    """gloo's functional all-gather crashes its rank on a CUDA tensor, so
    `collectives.staged` hands the fsdp gather (and the sequence
    collectives) a host copy there, and the tensor itself on any other
    backend or on the CPU."""
    import torch.distributed as dist

    class OnCard:
        is_cuda = True

        def cpu(self):
            return "host copy"
    monkeypatch.setattr(dist, "get_backend", lambda group: backend)
    card, host = OnCard(), torch.ones(2)
    assert C.staged(host, None) is host
    assert C.staged(card, None) == ("host copy" if backend == "gloo"
                                    else card)

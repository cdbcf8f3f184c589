"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU.

* an AST scan of `src/repro_torch/**`, the port's examples and
  `chip_smoke.py` for imports of `jax` or `repro`;
* a subprocess that blocks both on `sys.meta_path`, imports the port and
  runs CPU searches on every path (unsplit, hub split, stepper, `bfs()`,
  the gather formulation), `BFSServer` queries (batched and streamed), a
  session that records its plans in an artifact cache and one that
  pre-warms them, the LLM serving entry point at smoke size for every
  family and both frontend stubs, two training steps of the launcher with
  a checkpoint written and restored (`ml_dtypes` blocked too: bf16 leaves
  are stored as their bits), the sharding specs on the fake multi-pod
  mesh, a dry-run cell, the MoE layer through `moe_ffn_a2a`'s fallback,
  and the quickstart example;
* `Engine(g)`, `BFSServer`, the serving and training entry points and
  both BFS examples with no device ask for CUDA and raise without it, a
  partitioned query and `parallel.ranks` too (a rank's device is never a
  quiet CPU);
* the BFS path (and the interop module) does not import the LLM modules
  (serving, training, data, checkpoints: the port's counterpart of the
  JAX package's DC001 quarantine), and neither the serving nor the
  training path imports the BFS engine;
* on the card (`cuda`-marked, skipped elsewhere): P = 2 gloo ranks share
  the GPU, and their partitioned searches equal the same ranks' CPU
  searches.
"""
import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.engine import Engine

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    sorted((REPO / "examples").glob("*_torch.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


BLOCKED_RUN = r"""
import importlib.abc, pathlib, sys
REPO = pathlib.Path(sys.argv[1])

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from repro_torch.core import graph as G
from repro_torch.engine import Engine
from repro_torch.core.bfs import BFSConfig, bfs
g = G.rmat(8, seed=1)
eng = Engine(g, device="cpu")
res = eng.bfs([0, 5, 9], validate=True)
eng.bfs([0, 5], BFSConfig(hub_split=True, hub_deg=32), validate=True)
eng.bfs([0, 5], backend="stepper", validate=True)
bfs(g, 0, device="cpu")
eng.bfs([0, 5], BFSConfig(backend_kernels=False), validate=True)
from repro_torch.engine import BFSServer
with BFSServer({"g": g}, device="cpu") as server:
    server.submit("g", [0, 5], client="a").result(60).validate(g)
    h = server.submit("g", 9, stream=True, client="b")
    assert len(list(h.stream(60))) == int(h.result(60).num_levels[0]) + 1
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules)
import tempfile
from repro_torch.engine import GraphSession
from repro_torch.runtime import reset_process_caches, runtime_scope
with tempfile.TemporaryDirectory() as d, runtime_scope(cache_dir=d):
    s = GraphSession(G.rmat(8, seed=2), device="cpu")
    Engine(s).bfs([0, 5, 9])
    s.close()
    reset_process_caches()
    s = GraphSession(G.rmat(8, seed=2), device="cpu")
    Engine(s).bfs([0, 5, 9], validate=True)
    assert s.runtime_stats()["loads"] == 3, s.runtime_stats()
    s.close()
print("levels", int(res.num_levels.max()))
from repro_torch.launch import serve
toks = serve.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "20", "--gen", "3"])
assert toks.shape == (2, 3), toks.shape
for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b",
             "mamba2-2-7b", "hymba-1-5b", "internvl2-1b",
             "seamless-m4t-medium"):
    toks = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "2"])
    assert toks.shape == (2, 2), (arch, toks.shape)
import torch
from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.launch import train
with tempfile.TemporaryDirectory() as d:
    losses = train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                         "--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt", d, "--ckpt-every", "2", "--device", "cpu"])
    assert len(losses) == 2, losses
    run = train.train(train.smoke_config("qwen3-moe-235b-a22b"), steps=2,
                      batch=2, seq=16, device=torch.device("cpu"), ckpt=d,
                      log=print)
    assert run.start_step == 2 and run.losses == []
    (params, state), step, meta = CKPT.restore(d, (run.params,
                                                   run.opt_state))
    assert step == 2 and meta["arch"] == "qwen3-moe-smoke", meta
    assert params.embed.table.dtype == torch.bfloat16
    assert int(state["step"]) == 2
from repro_torch.launch import dryrun, mesh as MESH
from repro_torch.models import model as MODEL
from repro_torch.parallel import sharding as SH
assert dryrun.run_cell("stablelm-3b", "long_500k", False)["status"] == \
    "skipped"
with MESH.production_mesh(multi_pod=True) as m:
    cfg = train.smoke_config("stablelm-3b")
    shapes = {n: p.shape for n, p in
              MODEL.param_shapes(cfg).named_parameters()}
    assert SH.param_specs(cfg, shapes, m, SH.AxisRules())
cfg = train.smoke_config("qwen3-moe-235b-a22b")
lp = MODEL.init_params(cfg, torch.Generator().manual_seed(0)).layers[0]
assert lp.ffn(torch.ones(1, 4, cfg.d_model, dtype=torch.bfloat16),
              cfg).shape == (1, 4, cfg.d_model)
import runpy
quick = runpy.run_path(str(REPO / "examples" / "quickstart_torch.py"))
assert quick["main"](tiny=True, device="cpu")
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules)
"""


def test_port_runs_with_jax_and_repro_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(REPO)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("levels")
    for name in ("gemma2-9b", "qwen3-moe", "llama4-maverick", "mamba2-2.7b",
                 "hymba-1.5b"):
        assert f"[serve] {name}-smoke on cpu" in out.stdout, name
    assert "[train] step=1 " in out.stdout
    assert "[train] resumed from step 2" in out.stdout
    assert "parent tree VALID" in out.stdout


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.rmat(6, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(g, device="cuda")
    res = Engine(g, device="cpu").bfs(int(np.argmax(g.degrees)))
    assert res.parent.shape == (1, g.num_vertices)


def test_server_without_device_needs_cuda(monkeypatch):
    from repro_torch.engine import BFSServer, GraphSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.rmat(6, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BFSServer({"g": g})
    with pytest.raises(RuntimeError, match="CUDA"):
        BFSServer({"g": g}, device="cuda")
    from repro_torch.launch import bfs_serve
    with pytest.raises(RuntimeError, match="CUDA"):
        bfs_serve.main(["--graphs", "1", "--scale", "6"])
    server = BFSServer(autostart=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        server.register("g", g)
    server.register("g", GraphSession(g, device="cpu"))
    server.start()
    try:
        assert server.submit("g", 0).result(60).parent.shape == \
            (1, g.num_vertices)
    finally:
        server.close()


def test_partitioned_paths_without_device_need_cuda(monkeypatch, tmp_path):
    from repro_torch.parallel import ranks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.rmat(6, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(g).bfs(0, n_parts=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(g, default_strategy="hub0").bfs(0, backend="stepper",
                                               n_parts=2)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ranks.run_ranks(sharded_parity_rank, 2, str(tmp_path),
                            device=device)
    assert list(tmp_path.iterdir()) == []      # no rank was started


def sharded_parity_rank(rank, group, device):
    """One rank's partitioned searches on `device` against the same
    searches on the CPU, over the same group."""
    from repro_torch.core.hybrid_bfs import HybridConfig
    g = TG.rmat(10, seed=3)
    roots = [int(np.argmax(g.degrees)), 7]
    gpu, cpu = Engine(g, device=device), Engine(g, device="cpu")
    for strategy in ("random", "hub0", "specialized"):
        for hcfg in (HybridConfig(), HybridConfig(exchange="bitmap")):
            for backend in ("sharded", "stepper"):
                a = gpu.bfs(roots, hcfg, backend=backend, n_parts=2,
                            strategy=strategy)
                b = cpu.bfs(roots, hcfg, backend=backend, n_parts=2,
                            strategy=strategy)
                assert np.array_equal(a.parent, b.parent), strategy
                assert np.array_equal(a.level, b.level), strategy
                if backend == "stepper":
                    keys = ("level", "direction", "frontier_size",
                            "frontier_edges")
                    assert [[tuple(r[k] for k in keys) for r in s]
                            for s in a.per_level_stats] == \
                        [[tuple(r[k] for k in keys) for r in s]
                         for s in b.per_level_stats]
    return True


@pytest.mark.cuda
def test_sharded_ranks_on_the_card_match_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    from repro_torch.parallel import ranks
    assert ranks.run_ranks(sharded_parity_rank, 2, str(tmp_path),
                           backend="gloo", timeout=600) == [True, True]


def test_serve_without_device_needs_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("yi-9b", "qwen3-moe-235b-a22b", "mamba2-2-7b",
                 "seamless-m4t-medium"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--smoke"])
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch, "--smoke", "--device", "cuda"])


def test_train_without_device_needs_cuda(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("stablelm-3b", "mamba2-2-7b", "seamless-m4t-medium"):
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", arch, "--smoke", "--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--arch", arch, "--smoke", "--steps", "1",
                        "--device", "cuda"])


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,call", [
    ("quickstart_torch", lambda m: m.main(tiny=True)),
    ("quickstart_torch", lambda m: m.main(tiny=True, device="cuda")),
    ("bfs_demo_torch", lambda m: m.main(["--scale", "6"]))])
def test_examples_without_device_need_cuda(name, call, monkeypatch):
    """Both BFS examples ask for CUDA unless told the CPU, before any
    rank joins a group."""
    mod = _example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        call(mod)


QUARANTINE_RUN = r"""
import sys
import repro_torch.core.bfs, repro_torch.engine, repro_torch.kernels.ops
import repro_torch.interop, repro_torch.core.hybrid_bfs
import repro_torch.parallel.collectives, repro_torch.parallel.ranks
loaded = sorted(m for m in sys.modules if m.startswith((
    "repro_torch.models", "repro_torch.configs", "repro_torch.train",
    "repro_torch.launch", "repro_torch.kernels.decode_attn",
    "repro_torch.data", "repro_torch.checkpoint", "repro_torch.ft")))
print(loaded)
"""

SERVE_QUARANTINE_RUN = r"""
import sys
import repro_torch.launch.serve, repro_torch.launch.train
print(sorted(m for m in sys.modules if m.startswith((
    "repro_torch.engine", "repro_torch.core.bfs"))))
"""


def _loaded(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_bfs_path_does_not_import_the_serving_modules():
    assert _loaded(QUARANTINE_RUN) == "[]"


def test_serving_path_does_not_import_the_bfs_engine():
    assert _loaded(SERVE_QUARANTINE_RUN) == "[]"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA: a nonzero exit and no result line. Alone in a directory
    (no repo around it) it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

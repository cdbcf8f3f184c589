"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU.

* an AST scan of `src/repro_torch/**` and `chip_smoke.py` for imports of
  `jax` or `repro`;
* a subprocess that blocks both on `sys.meta_path`, imports the port and
  runs CPU searches on every path (unsplit, hub split, stepper, `bfs()`)
  and the LLM serving entry point at smoke size;
* `Engine(g)` and the serving entry point with no device ask for CUDA and
  raise without it, a partitioned query and `parallel.ranks` too (a rank's
  device is never a quiet CPU);
* the BFS path (and the interop module) does not import the LLM serving
  modules (the port's counterpart of the JAX package's DC001 quarantine),
  and the serving path does not import the BFS engine;
* on the card (`cuda`-marked, skipped elsewhere): P = 2 gloo ranks share
  the GPU, and their partitioned searches equal the same ranks' CPU
  searches.
"""
import ast
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
    [REPO / "chip_smoke.py"]


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
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
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
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules)
print("levels", int(res.num_levels.max()))
from repro_torch.launch import serve
toks = serve.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "20", "--gen", "3"])
assert toks.shape == (2, 3), toks.shape
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules)
"""


def test_port_runs_with_jax_and_repro_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("levels")
    assert "[serve] gemma2-9b-smoke on cpu" in out.stdout


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = TG.rmat(6, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(g, device="cuda")
    res = Engine(g, device="cpu").bfs(int(np.argmax(g.degrees)))
    assert res.parent.shape == (1, g.num_vertices)


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
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "yi-9b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "yi-9b", "--smoke", "--device", "cuda"])


QUARANTINE_RUN = r"""
import sys
import repro_torch.core.bfs, repro_torch.engine, repro_torch.kernels.ops
import repro_torch.interop, repro_torch.core.hybrid_bfs
import repro_torch.parallel.collectives, repro_torch.parallel.ranks
loaded = sorted(m for m in sys.modules if m.startswith((
    "repro_torch.models", "repro_torch.configs", "repro_torch.train",
    "repro_torch.launch", "repro_torch.kernels.decode_attn")))
print(loaded)
"""

SERVE_QUARANTINE_RUN = r"""
import sys
import repro_torch.launch.serve
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

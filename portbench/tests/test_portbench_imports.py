"""Nothing the benchmark runs imports JAX or the JAX package (`repro`),
compared by each module's whole top-level name (`repro_torch` begins
with `repro`), and nothing reads the JAX package's benchmark folder."""
import ast
import json
import subprocess
import sys

import portbench_tiny

REPO = portbench_tiny.REPO
BLOCKED = ("jax", "jaxlib", "flax", "repro")

# In a fresh interpreter: refuse to import any blocked top-level name,
# import every module of the benchmark, run one traced closed-loop cell
# and one open-loop cell on the CPU, and list what was loaded.
CHILD = r"""
import importlib, importlib.abc, json, pathlib, sys, tempfile
BLOCKED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path[:0] = [%r, %r, %r]
import portbench_tiny
for p in sorted(pathlib.Path(%r).glob("*.py")):
    importlib.import_module("portbench." + p.stem)
from portbench import harness
root = portbench_tiny.tiny_root(pathlib.Path(tempfile.mkdtemp()))
a = portbench_tiny.run_cell(root, "g500-s24.keys", trace=True)
b = portbench_tiny.run_cell(root, "svc-s22.poisson")
print(json.dumps(dict(correct=[a["correct"], b["correct"]],
                      forbidden=harness.forbidden_modules(),
                      top=sorted({n.split(".")[0] for n in sys.modules}))))
"""


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    code = CHILD % (BLOCKED, str(REPO / "src"), str(REPO),
                    str(REPO / "portbench" / "tests"),
                    str(REPO / "portbench"))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"] == [True, True]
    assert out["forbidden"] == []
    assert not set(out["top"]) & set(BLOCKED)
    assert "repro_torch" in out["top"]


def test_forbidden_names_are_compared_whole():
    from portbench import harness
    names = ["repro_torch", "repro_torch.engine", "jaxtyping", "flaxen.x",
             "torch"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.core"]) == ["repro"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib"]


def test_sources_import_neither_jax_nor_repro_nor_benchmarks():
    for path in (REPO / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        bad = [x for x in names if x.split(".")[0] in
               BLOCKED + ("benchmarks",)]
        assert not bad, (path, bad)
        if path.parent.name != "tests":
            assert "benchmarks" not in path.read_text(), path
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    assert all("benchmarks" not in w for w in manifest["command"])

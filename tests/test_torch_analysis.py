"""The port's linter (`repro_torch.analysis`) against the JAX package's.

* every port rule fires on a fixture and stays quiet on a near-identical
  clean one: TH001-TH003 (torch host syncs, rebuild hazards), PK001, PL002
  (clamped ELL gathers), LS001;
* the rules that carry over (PK001, LS001, DC001, SUP001, baseline
  matching) give the same (rule, line, col) on the same source text
  through the JAX linter (path `src/repro/...`) and the port's (path
  `src/repro_torch/...`);
* the port's tree lints clean in-process and through the CLI (exit 0 on
  the tree, 1 on a bad file, the rule catalog), with its baseline;
* linting imports no torch, jax or repro: the CLI runs in a subprocess
  that blocks all three on `sys.meta_path`.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import deadcode as JD
from repro.analysis import lint as JL
from repro_torch.analysis import deadcode as TD
from repro_torch.analysis import lint as TL
from repro_torch.analysis import rules as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(REPO, "src", "repro_torch")
BASELINE = os.path.join(PORT_SRC, "analysis", "baseline.json")

ENGINE = "src/repro_torch/engine/fixture.py"
CORE = "src/repro_torch/core/fixture.py"
KERNELS = "src/repro_torch/kernels/fixture.py"


def _lint(src: str, path: str = ENGINE):
    hot, _cold, _supps = TL.lint_source(textwrap.dedent(src), path)
    return hot


def _rules(findings):
    return [f.rule for f in findings]


# ===========================================================================
# TH001 — explicit host syncs
# ===========================================================================


def test_th001_fires_on_synchronize_event_and_cpu():
    hot = _lint("""
        import torch
        def step(state, ev):
            torch.cuda.synchronize(state.device)
            ev.synchronize()
            return state.parent.cpu()
    """)
    assert _rules(hot).count("TH001") == 3


def test_th001_sanctioned_in_host_sync_and_finalize():
    src = """
        import torch
        def host_sync(payload):
            return torch.cat(payload).cpu()
        class Backend:
            def finalize(self, state):
                torch.cuda.synchronize()
                return state.parent.cpu()
    """
    assert "TH001" not in _rules(_lint(
        src, "src/repro_torch/engine/level_loop.py"))
    # host_sync is sanctioned only in level_loop.py; finalize anywhere
    assert _rules(_lint(src)).count("TH001") == 1


def test_th001_scoped_to_engine_layer():
    hot = _lint("""
        import torch
        def step(state):
            torch.cuda.synchronize()
    """, path=CORE)
    assert "TH001" not in _rules(hot)


def test_th001_suppression_with_reason():
    src = """
        import torch
        def fence(device):
            torch.cuda.synchronize(device)  # repro-ok: TH001 a timing fence
    """
    hot, cold, _ = TL.lint_source(textwrap.dedent(src), ENGINE)
    assert "TH001" not in _rules(hot)
    assert _rules(cold) == ["TH001"]


# ===========================================================================
# TH002 — implicit host syncs
# ===========================================================================


def test_th002_fires_on_scalars_of_torch_values():
    hot = _lint("""
        import numpy as np
        import torch
        def step(deg):
            cum = torch.cumsum(deg, 0)
            total = int(cum[-1])
            frac = float(torch.sum(deg))
            n = cum.item()
            rows = cum.tolist()
            host = np.asarray(cum)
            return cum.numpy(), total, frac, n, rows, host
    """, path=CORE)
    assert _rules(hot).count("TH002") == 6


def test_th002_ignores_host_values_and_unseen_names():
    hot = _lint("""
        import numpy as np
        import torch
        def step(st, pos):
            x = torch.zeros(3)
            n = int(x.shape[0]) + int(torch.cuda.device_count())
            k = int(st.level)               # origin unseen: not flagged
            host = x.cpu().numpy()          # the copy is TH001's, not TH002's
            p = np.asarray(pos)
            return n, k, host, p.tolist(), int(x.numel())
    """, path=CORE)
    assert "TH002" not in _rules(hot)


def test_th002_scoped_to_engine_and_core():
    hot = _lint("""
        import torch
        def f():
            return int(torch.ones(1))
    """, path="src/repro_torch/launch/fixture.py")
    assert "TH002" not in _rules(hot)


# ===========================================================================
# TH003 — rebuild hazards
# ===========================================================================


def test_th003_fires_on_compile_capture_and_build_in_loops():
    hot = _lint("""
        import torch
        from repro_torch.kernels import _build
        def run(fns, steps):
            for f in fns:
                g = torch.compile(f)
                s = torch.jit.script(f)
            while steps:
                graph = torch.cuda.CUDAGraph()
                _build.build_all()
                steps -= 1
    """)
    assert _rules(hot).count("TH003") == 4


def test_th003_clean_when_hoisted_or_deferred():
    hot = _lint("""
        import torch
        def run(f, xs):
            g = torch.compile(f)
            out = []
            for x in xs:
                def later():
                    return torch.compile(f)     # runs only when called
                out.append(g(x))
            return out
    """)
    assert "TH003" not in _rules(hot)


# ===========================================================================
# PK001 — plan-key hygiene
# ===========================================================================


def test_pk001_fires_on_list_and_lambda_keys():
    hot = _lint("""
        def plans(sess, cfg, build):
            sess.executable(("cohort", [cfg], True, 8, "td"), build)
            sess.cached(key=lambda: cfg, build=build)
    """)
    assert _rules(hot).count("PK001") == 2


def test_pk001_clean_on_tuple_keys():
    hot = _lint("""
        def plans(sess, cfg, build):
            sess.executable(("cohort", cfg, True, 8, "td"), build)
            sess.cached(("ell", 32, 2), build, share=True)
    """)
    assert "PK001" not in _rules(hot)


# ===========================================================================
# PL002 — unclamped gathers on ragged ELL tiles
# ===========================================================================


def test_pl002_fires_on_raw_neighbour_indices():
    hot = _lint("""
        import torch
        def pull_plain(deg, nbrs, frontier, lanes):
            flat = nbrs.reshape(-1)
            a = frontier[lanes, nbrs[None]]
            b = frontier.gather(1, nbrs)
            c = torch.index_select(frontier[0], 0, flat)
            return a, b, c
    """, path=KERNELS)
    assert _rules(hot).count("PL002") == 3


def test_pl002_clean_after_clamp():
    hot = _lint("""
        import torch
        def pull_plain(deg, nbrs, frontier, lanes):
            v = frontier.shape[1]
            safe = nbrs.clamp(0, v - 1)
            dst = nbrs.clamp(0, v - 1).reshape(-1).to(torch.int64)
            rows = nbrs[1:3]                       # a slice, not a gather
            return (frontier[lanes, safe[None]], frontier[0][dst],
                    torch.index_select(frontier[0], 0, dst), rows,
                    frontier[:, :nbrs.shape[1]])
    """, path=KERNELS)
    assert "PL002" not in _rules(hot)


def test_pl002_scoped_to_kernels():
    hot = _lint("""
        def f(nbrs, frontier):
            return frontier[nbrs]
    """, path=CORE)
    assert "PL002" not in _rules(hot)


# ===========================================================================
# LS001 — lock-scope discipline
# ===========================================================================

_LS_BAD = """
    import threading
    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0          # __init__ is exempt
        def bump(self):
            with self._lock:
                self.n += 1
        def reset(self):
            self.n = 0          # <- races bump()
"""

_LS_CLEAN = """
    import threading
    class Counter:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0
        def bump(self):
            with self._lock:
                self.n += 1
        def reset(self):
            with self._lock:
                self.n = 0
"""


def test_ls001_fires_on_unguarded_mutation():
    ls = [f for f in _lint(_LS_BAD) if f.rule == "LS001"]
    assert len(ls) == 1 and "both inside and outside" in ls[0].message


def test_ls001_clean_when_all_guarded():
    assert "LS001" not in _rules(_lint(_LS_CLEAN))


# ===========================================================================
# the rules that carry over: the JAX linter and the port's agree
# ===========================================================================

_PARITY = {
    "pk001": ("engine", """
        def plans(sess, cfg, build):
            sess.executable(("cohort", [cfg], 8, "td"), build)
            sess.cached(key={"a": 1}, build=build)
            sess.executable(("cohort", cfg, 8, "bu"), build)
            sess.cached(("x", (lambda: 1)), build)
    """),
    "pk001-clean": ("runtime", """
        def plans(sess, cfg, build):
            return sess.executable(("cohort", cfg, 8, "td"), build)
    """),
    "ls001": ("engine", _LS_BAD),
    "ls001-clean": ("engine", _LS_CLEAN),
    "ls001-suppressed": ("engine", """
        import threading
        class S:
            def __init__(self):
                self._lock = threading.RLock()
            def start(self):
                # repro-ok: LS001 called only from __init__
                self.thread = None
                self.other = 1
    """),
    "sup001": ("engine", """
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
            def go(self):
                self.x = 1  # repro-ok: LS001
                self.y = 2  # repro-ok: LS001 justified here
    """),
}


def _parity_findings(linter, root: str, layer: str, src: str):
    hot, cold, supps = linter.lint_source(textwrap.dedent(src),
                                          f"src/{root}/{layer}/fixture.py")
    keep = {"PK001", "LS001"}
    return ({(f.rule, f.line, f.col) for f in hot if f.rule in keep},
            {(f.rule, f.line, f.col) for f in cold if f.rule in keep},
            {(f.rule, f.line, f.col) for f in supps.malformed})


@pytest.mark.parametrize("case", sorted(_PARITY) + ["dc001", "dc001-lazy",
                                                    "baseline"])
def test_carried_rules_match_the_jax_linter(case, tmp_path):
    if case.startswith("dc001"):
        lazy = case.endswith("lazy")
        body = ("def f():\n    from {p}.models import layers\n"
                "    return layers\n" if lazy else
                "import os\nfrom {p}.models import layers\n")
        got = []
        for pkg, dc in (("repro", JD), ("repro_torch", TD)):
            sources = {f"src/{pkg}/core/fixture.py": body.format(p=pkg),
                       f"src/{pkg}/models/layers.py": ""}
            got.append({(f.rule, f.line, f.col)
                        for f in dc.QuarantineGate().check_project(sources)})
        assert got[0] == got[1] == (set() if lazy else {("DC001", 2, 0)})
        return
    if case == "baseline":
        src = textwrap.dedent("""
            def plans(sess, cfg, build):
                return sess.executable(("cohort", [cfg]), build)
        """)
        got = []
        for pkg, lint in (("repro", JL), ("repro_torch", TL)):
            target = tmp_path / pkg / "src" / pkg / "engine" / "fixture.py"
            target.parent.mkdir(parents=True)
            target.write_text(src)
            root = str(tmp_path / pkg)
            entry = lint.BaselineEntry(
                rule="PK001", path=lint.relpath_for(str(target), root),
                text='return sess.executable(("cohort", [cfg]), build)',
                reason="grandfathered fixture")
            res = lint.run_lint([str(target)], root=root, baseline=[entry])
            assert res.ok and not res.findings
            got.append({(f.rule, f.line, f.col) for f in res.baselined})
        assert got[0] == got[1] == {("PK001", 3, 38)}
        return
    layer, src = _PARITY[case]
    mine = _parity_findings(TL, "repro_torch", layer, src)
    ref = _parity_findings(JL, "repro", layer, src)
    assert mine == ref
    if not case.endswith("clean"):
        assert any(mine), case


def test_suppression_without_reason_is_sup001():
    _hot, _cold, supps = TL.lint_source(
        "import torch\ntorch.cuda.synchronize()  # repro-ok: TH001\n", ENGINE)
    assert [f.rule for f in supps.malformed] == ["SUP001"]


def test_baseline_requires_reasons(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text('{"entries": [{"rule": "TH001", "path": "x.py", '
                 '"text": "y", "reason": ""}]}')
    with pytest.raises(TL.BaselineError):
        TL.load_baseline(str(p))


# ===========================================================================
# the port's tree, the CLI, the catalog
# ===========================================================================


def test_port_tree_lints_clean_with_its_baseline():
    baseline = TL.load_baseline(BASELINE)
    assert all(e.reason for e in baseline)
    res = TL.run_lint([PORT_SRC], root=REPO, baseline=baseline,
                      project_rules=[TD.QuarantineGate()])
    assert res.ok, "\n".join(f.format() for f in res.findings + res.errors)
    # the two explicit syncs and three implicit ones it finds are
    # justified at their sites
    assert {f.rule for f in res.suppressed} >= {"TH001", "TH002", "LS001"}


def test_port_dead_code_report():
    sources = {}
    for fp in TL.iter_python_files([PORT_SRC]):
        with open(fp, encoding="utf-8") as fh:
            sources[TL.relpath_for(fp, REPO)] = fh.read()
    report = TD.dead_code_report(sources)
    from_bfs = set(report.bfs_core) | set(report.shared)
    assert {"repro_torch.engine.server", "repro_torch.core.hybrid_bfs",
            "repro_torch.kernels.bottomup"} <= from_bfs
    # the LLM template stays on its side of the line; the decode launcher
    # is reached only through `ops.decode_attention`'s lazy import
    assert not any(m.startswith(("repro_torch.models", "repro_torch.configs",
                                 "repro_torch.train")) for m in from_bfs)
    assert "repro_torch.kernels.decode_attn" in report.shared
    assert "repro_torch.models.decode" in report.template_only


def test_cli_exits_zero_on_the_port_tree():
    from repro_torch.analysis.cli import main
    assert main([PORT_SRC, "--root", REPO, "--no-bytecode-guard"]) == 0


def test_cli_exits_nonzero_on_bad_file(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "engine" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\n\ndef f(s):\n"
                   "    torch.cuda.synchronize()\n    return s\n")
    from repro_torch.analysis.cli import main
    assert main([str(bad), "--root", str(tmp_path),
                 "--no-bytecode-guard"]) == 1


def test_cli_list_rules_names_the_tpu_only_rules(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--list-rules"]) == 0
    lines = dict(ln.split(None, 1) for ln in
                 capsys.readouterr().out.strip().splitlines())
    assert {"TH001", "TH002", "TH003", "PK001", "PL002", "LS001", "DC001",
            "SUP001", "KC001", "KC002", "KC004", "KC005"} <= set(lines)
    for tpu_only in ("PL001", "KC003", "KC006"):
        assert lines[tpu_only].startswith("TPU only")
        assert "no CUDA counterpart" in lines[tpu_only]
    assert set(lines) == set(TR.rule_catalog())


BLOCKED_LINT = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from repro_torch.analysis.cli import main
root, src = sys.argv[1], sys.argv[2]
codes = [main([src, "--root", root, "--no-bytecode-guard"]),
         main(["--list-rules"]),
         main([src, "--root", root, "--dead-code", "--json"])]
assert not any(m.split(".")[0] in ("torch", "jax", "jaxlib", "repro")
               for m in sys.modules), sorted(sys.modules)
print("codes", codes)
"""


def test_linting_imports_no_torch_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKED_LINT, REPO, PORT_SRC],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "codes [0, 0, 0]"


def test_cli_json_payload(capsys):
    from repro_torch.analysis.cli import main
    assert main([PORT_SRC, "--root", REPO, "--json",
                 "--no-bytecode-guard"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["errors"] == []
    assert payload["suppressed"] >= 5

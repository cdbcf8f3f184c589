"""Import-graph dead-code report and the DC001 quarantine gate.

The port's copy of the JAX package's `analysis/deadcode.py`. The port
carries the LLM-serving template beside the BFS system, as the JAX package
does; this module draws a machine-checked line between the two halves:

* **BFS core**: everything reachable from the BFS entry points
  (``repro_torch.launch.bfs_run``, ``repro_torch.launch.bfs_serve``).
* **Quarantined template**: the LLM modules (``repro_torch.models``,
  ``repro_torch.configs``, ``repro_torch.train``, ``repro_torch.data``,
  ``repro_torch.checkpoint``, ``repro_torch.ft``,
  ``repro_torch.kernels.decode_attn``, and the template launchers
  ``repro_torch.launch.serve`` and ``repro_torch.launch.train``), the
  modules that `tests/test_torch_isolation.py` holds apart from the BFS
  path.

**DC001** fires when a non-quarantined module imports a quarantined one at
module level (eager import). Function-scoped lazy imports are allowed:
they only execute when template functionality is explicitly requested and
cost nothing on the BFS path (`kernels/ops.py` `decode_attention`,
`interop.py`'s weight carriers).

The dead-code *report* (``python -m repro_torch.analysis --dead-code``)
classifies every module as bfs-core / template / shared / unreachable
using reachability from both entrypoint sets.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lint import Finding

PACKAGE = "repro_torch"

BFS_ENTRYPOINTS: Tuple[str, ...] = (
    "repro_torch.launch.bfs_run",
    "repro_torch.launch.bfs_serve",
)

TEMPLATE_ENTRYPOINTS: Tuple[str, ...] = (
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
)

# Modules (by prefix) that belong to the LLM-serving template and must never
# be eagerly imported from BFS-core code.
QUARANTINE_PREFIXES: Tuple[str, ...] = (
    "repro_torch.models",
    "repro_torch.train",
    "repro_torch.data",
    "repro_torch.checkpoint",
    "repro_torch.ft",
    "repro_torch.configs",
    "repro_torch.kernels.decode_attn",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
)


def is_quarantined(module: str) -> bool:
    return any(
        module == p or module.startswith(p + ".") for p in QUARANTINE_PREFIXES
    )


def module_name_for(path: str) -> Optional[str]:
    """'src/repro_torch/engine/server.py' -> 'repro_torch.engine.server'
    (None if not in the port)."""
    norm = path.replace("\\", "/")
    if f"{PACKAGE}/" not in norm or not norm.endswith(".py"):
        return None
    tail = norm[norm.rindex(f"{PACKAGE}/") :][: -len(".py")]
    parts = tail.split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclasses.dataclass(frozen=True)
class ImportEdge:
    src: str  # importing module
    dst: str  # imported module
    line: int
    toplevel: bool  # True when the import executes at module import time


def _resolve_from(module: Optional[str], level: int, src_mod: str) -> Optional[str]:
    if level == 0:
        return module
    # relative import: walk up from the source package
    parts = src_mod.split(".")
    base = parts[: len(parts) - level]
    if not base:
        return None
    return ".".join(base + ([module] if module else []))


def extract_edges(sources: Dict[str, str]) -> List[ImportEdge]:
    """Parse every source and return port-internal import edges."""
    modules = {module_name_for(p) for p in sources}
    modules.discard(None)
    edges: List[ImportEdge] = []
    for path, src in sorted(sources.items()):
        src_mod = module_name_for(path)
        if src_mod is None:
            continue
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue
        toplevel_nodes = set(tree.body)

        def add(dst: Optional[str], node: ast.AST, top: bool) -> None:
            if not dst or not (dst == PACKAGE
                               or dst.startswith(PACKAGE + ".")):
                return
            # resolve to the closest known module (handles
            # `from repro_torch.engine import server` -> repro_torch.engine.server)
            if dst not in modules:
                parent = dst.rsplit(".", 1)[0] if "." in dst else None
                if parent in modules:
                    dst = parent
            edges.append(
                ImportEdge(src=src_mod, dst=dst, line=node.lineno, toplevel=top)
            )

        for node in ast.walk(tree):
            top = node in toplevel_nodes
            if isinstance(node, ast.Import):
                for alias in node.names:
                    add(alias.name, node, top)
            elif isinstance(node, ast.ImportFrom):
                base = _resolve_from(node.module, node.level, src_mod)
                if base is None:
                    continue
                for alias in node.names:
                    cand = f"{base}.{alias.name}"
                    add(cand if cand in modules else base, node, top)
    return edges


def _reachable(roots: Iterable[str], edges: Sequence[ImportEdge]) -> Set[str]:
    adj: Dict[str, Set[str]] = {}
    for e in edges:
        adj.setdefault(e.src, set()).add(e.dst)
        # importing a submodule imports its package __init__ too
        pkg = e.dst.rsplit(".", 1)[0] if "." in e.dst else None
        if pkg:
            adj.setdefault(e.src, set()).add(pkg)
    seen: Set[str] = set()
    stack = [r for r in roots]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(adj.get(m, ()))
    return seen


@dataclasses.dataclass
class DeadCodeReport:
    bfs_core: List[str]
    template_only: List[str]
    shared: List[str]
    unreachable: List[str]

    def to_json(self) -> Dict[str, List[str]]:
        return dataclasses.asdict(self)


def dead_code_report(sources: Dict[str, str]) -> DeadCodeReport:
    edges = extract_edges(sources)
    modules = sorted(
        m for m in (module_name_for(p) for p in sources) if m is not None
    )
    from_bfs = _reachable(BFS_ENTRYPOINTS, edges)
    from_tpl = _reachable(TEMPLATE_ENTRYPOINTS, edges)
    report = DeadCodeReport([], [], [], [])
    for m in modules:
        in_bfs = m in from_bfs
        in_tpl = m in from_tpl
        if in_bfs and in_tpl:
            report.shared.append(m)
        elif in_bfs:
            report.bfs_core.append(m)
        elif in_tpl:
            report.template_only.append(m)
        else:
            report.unreachable.append(m)
    return report


class QuarantineGate:
    """Project rule DC001: no eager core -> template imports."""

    id = "DC001"
    title = "BFS-core module imports a quarantined template module"

    def check_project(self, sources: Dict[str, str]) -> List[Finding]:
        out: List[Finding] = []
        path_by_mod = {
            module_name_for(p): p for p in sources if module_name_for(p)
        }
        for e in extract_edges(sources):
            if not e.toplevel:
                continue  # lazy imports are the sanctioned escape hatch
            if is_quarantined(e.dst) and not is_quarantined(e.src):
                out.append(
                    Finding(
                        rule=self.id,
                        path=path_by_mod.get(e.src, e.src),
                        line=e.line,
                        col=0,
                        message=(
                            f"eager import of quarantined template module "
                            f"'{e.dst}' from BFS-core '{e.src}'; move the "
                            "import inside the function that needs it "
                            "(template code must cost nothing on the BFS "
                            "path)"
                        ),
                    )
                )
        return out

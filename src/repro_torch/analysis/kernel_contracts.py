"""KC rules: static verifier over the port's CUDA kernel contracts.

The port's counterpart of the JAX package's `analysis/kernel_contracts.py`.
For one wrapper call at one concrete shape (a contract of
:mod:`repro_torch.kernels.contracts`) it checks:

* **KC001**: each kernel instance's per-CTA needs (static and dynamic
  shared bytes, threads, the register cap of its launch bounds) are within
  the `smem` budget;
* **KC002**: the launch plan covers its ranges exactly once (a pull's
  grid-stride tiles over every (lane, row), the decode splits over S, the
  packing kernel's words over V and its lane groups) and every grid
  dimension is within the card's limits;
* **KC004**: the gathers' indices are provably in ``[0, V)`` after the
  kernels' clip, by interval reasoning, as the JAX checker bounds them;
* **KC005** (an AST pass): every ``_build.launch(`` in
  ``repro_torch/kernels/`` sits in a launcher that has a registered
  contract, so a new kernel cannot dodge the verifier.

The JAX package's KC003 (Mosaic tiling) and KC006 (index-map arity and
affineness) have no CUDA counterpart: a CUDA launch has neither. Nothing
here falls back to "feasible": an instance the model cannot classify is an
error finding.

Runs these ways, none of which touches a device:

* ``python -m repro_torch.analysis src/repro_torch --kernel-contracts``:
  KC005 over the tree plus KC001/KC002/KC004 over every registered
  launcher's reference instantiation and the reference plans' verdicts;
* :func:`gate_paths` (the CLI's gate over a list of paths) and
  :func:`reference_findings` (the findings of the registered references);
* :func:`contract_report`: one plan's feasibility on one graph shape,
  which `GraphSession.executable()` runs before it builds a tiles plan
  (a `KernelContractWarning`, or `KernelBudgetError` under
  `RuntimeConfig.strict_contracts`).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import smem
from repro_torch.analysis.lint import Finding, load_sources
from repro_torch.kernels import contracts as C

@dataclasses.dataclass(frozen=True)
class ContractFinding:
    """One KC diagnostic against one kernel instantiation."""
    rule: str
    kernel: str
    severity: str                # "error" (the JAX report's key; the port
                                 # has no warning-only rule)
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return f"[{self.kernel}] {self.rule} ({self.severity}) {self.message}"


# ------------------------------------------------------------- the checker --


@dataclasses.dataclass(frozen=True)
class KernelCheck:
    """Verdict for one wrapper call at one shape."""
    kernel: str
    grid: Tuple[Tuple[int, int, int], ...]    # one a launch of the call
    smem: Tuple[smem.SmemReport, ...]         # one a launched instance
    findings: Tuple[ContractFinding, ...]

    @property
    def errors(self) -> Tuple[ContractFinding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> Tuple[ContractFinding, ...]:
        """Warning findings: always empty in the port (no rule warns)."""
        return tuple(f for f in self.findings if f.severity == "warning")

    @property
    def feasible(self) -> bool:
        return not self.errors

    @property
    def peak_bytes(self) -> int:
        return max((r.total_bytes for r in self.smem), default=0)

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "grid": [list(g) for g in self.grid],
            "smem": [r.to_json() for r in self.smem],
            "findings": [f.to_json() for f in self.findings],
            "feasible": self.feasible,
        }


def check_contract(contract: C.KernelContract, *,
                   budget_bytes: Optional[int] = None) -> KernelCheck:
    """Run KC001/KC002/KC004 over one concrete instantiation."""
    findings: List[ContractFinding] = []

    def add(rule: str, message: str) -> None:
        findings.append(ContractFinding(rule=rule, kernel=contract.kernel,
                                        severity="error", message=message))

    # KC001 — each launched instance against the per-CTA budget.
    reports: List[smem.SmemReport] = []
    for launch in contract.launches:
        try:
            rep = smem.smem_report(launch.instance, budget_bytes)
        except smem.SmemModelError as exc:
            add("KC001", f"{launch.instance.symbol}: {exc}")
            continue
        reports.append(rep)
        for problem in rep.problems:
            add("KC001",
                f"{launch.instance.symbol}: {problem}. Shrink the instance "
                f"(lanes a block, splits) or raise "
                f"RuntimeConfig.smem_budget_bytes (REPRO_SMEM_BUDGET) up to "
                f"the card's {smem.DEFAULT_SMEM_BUDGET} B")
    if not contract.launches:
        add("KC001", "the contract launches no kernel instance: the model "
                     "cannot classify the call")

    # KC002 — grids within the card's limits, ranges covered once.
    for launch in contract.launches:
        x, y, z = launch.grid
        for dim, n, most in (("x", x, smem.MAX_GRID_X),
                             ("y", y, smem.MAX_GRID_YZ),
                             ("z", z, smem.MAX_GRID_YZ)):
            if not 1 <= n <= most:
                add("KC002", f"{launch.instance.symbol}: grid {dim} = {n} "
                             f"outside [1, {most}]")
    for cov in contract.coverage:
        if cov.step < 1 or cov.steps < 0 or cov.extent < 0:
            add("KC002", f"{cov.what}: degenerate plan (extent "
                         f"{cov.extent}, step {cov.step}, steps "
                         f"{cov.steps})")
            continue
        covered = cov.step * cov.steps
        if covered < cov.extent:
            add("KC002", f"{cov.what}: {cov.steps} steps of {cov.step} "
                         f"cover {covered} of {cov.extent}; the last "
                         f"{cov.extent - covered} are never touched")
        elif cov.steps and covered - cov.step >= cov.extent:
            add("KC002", f"{cov.what}: {cov.steps} steps of {cov.step} "
                         f"for {cov.extent}: the last step lies wholly past "
                         f"the end")
    for lim in contract.limits:
        if not lim.least <= lim.value <= lim.most:
            add("KC002", f"{lim.what} = {lim.value} outside "
                         f"[{lim.least}, {lim.most}]")

    # KC004 — interval reasoning over declared gathers.
    for gs in contract.gathers:
        if gs.extent < 1:
            add("KC004", f"gather '{gs.index}' -> '{gs.source}': the source "
                         f"is empty (extent {gs.extent})")
            continue
        if gs.clip is None:
            add("KC004", f"gather '{gs.index}' -> '{gs.source}': indices in "
                         f"[{gs.raw_interval[0]}, {gs.raw_interval[1]}] are "
                         f"used unclipped; padded ELL slots and hybrid pad "
                         f"rows hold out-of-range ids: clip first, mask "
                         f"after")
            continue
        lo = min(max(gs.raw_interval[0], gs.clip[0]), gs.clip[1])
        hi = max(min(gs.raw_interval[1], gs.clip[1]), gs.clip[0])
        if lo < 0 or hi > gs.extent - 1:
            add("KC004", f"gather '{gs.index}' -> '{gs.source}': clipped "
                         f"indices [{lo}, {hi}] escape the source's extent "
                         f"[0, {gs.extent - 1}]")
    findings.sort(key=lambda f: f.rule)
    return KernelCheck(kernel=contract.kernel,
                       grid=tuple(la.grid for la in contract.launches),
                       smem=tuple(reports), findings=tuple(findings))


# ---------------------------------------------------------- plan reports --


@dataclasses.dataclass(frozen=True)
class GraphShape:
    """The three numbers a static kernel instantiation needs."""
    num_vertices: int
    num_edges: int               # undirected edge count
    max_degree: int

    @classmethod
    def from_graph(cls, graph) -> "GraphShape":
        degs = graph.degrees
        max_deg = int(max(degs)) if len(degs) else 0
        return cls(num_vertices=int(graph.num_vertices),
                   num_edges=int(graph.num_undirected_edges),
                   max_degree=max_deg)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _coerce_graph_shape(shape) -> GraphShape:
    if isinstance(shape, GraphShape):
        return shape
    if hasattr(shape, "num_vertices") and hasattr(shape, "degrees"):
        return GraphShape.from_graph(shape)
    if isinstance(shape, dict):
        return GraphShape(**shape)
    v, e, d = shape
    return GraphShape(num_vertices=int(v), num_edges=int(e),
                      max_degree=int(d))


_KNOB_DEFAULTS = dict(td_chunk=4096, bu_chunk=512, bu_slab=32,
                      hub_split=0, hub_deg=256, hub_slab=256)


def _extract_plan(plan_key) -> Tuple[Dict[str, int], int, int]:
    """(knobs, batch, n_parts) from a plan key.

    Accepts a `BFSConfig`, a `HybridConfig` (anything with ``.bfs``), a
    plain knob dict, or a session key tuple: the port's cohort plan
    ``("cohort", cfg, use_kernels, bucket, variant)`` (the batch is its
    bucket, ``key[3]``) or the sharded search's ``("sharded", hcfg,
    n_parts, strategy, hub)``. Duck-typed, as the JAX package's is: the
    CLI never imports the config classes.
    """
    knobs = dict(_KNOB_DEFAULTS)
    batch, n_parts = 1, 1

    def absorb(obj) -> bool:
        inner = getattr(obj, "bfs", None)
        if inner is not None and hasattr(inner, "td_chunk"):
            obj = inner
        if hasattr(obj, "td_chunk"):
            for k in knobs:
                val = getattr(obj, k, None)
                if val is not None:
                    knobs[k] = int(val)
            return True
        return False

    if isinstance(plan_key, dict):
        for k in knobs:
            if k in plan_key:
                knobs[k] = int(plan_key[k])
        return knobs, batch, n_parts
    if isinstance(plan_key, tuple):
        head = plan_key[0] if plan_key else None
        if head == "cohort" and len(plan_key) >= 4:
            batch = int(plan_key[3])
        if head == "sharded" and len(plan_key) >= 3:
            n_parts = int(plan_key[2])
        for item in plan_key:
            if absorb(item):
                break
        return knobs, batch, n_parts
    absorb(plan_key)
    return knobs, batch, n_parts


def _bitmap_exchange(plan_key) -> bool:
    """Whether a partitioned plan ORs the frontier as packed words (the
    packing kernel with the bitmap, `HybridConfig(exchange="bitmap")`)."""
    items = plan_key if isinstance(plan_key, tuple) else (plan_key,)
    return any(getattr(it, "exchange", None) == "bitmap" for it in items)


def _row_bound(w: int, shape: GraphShape, v: int, base: int,
               growth: int) -> int:
    """Rows an ELL bucket of width `w` can hold, from the degree floor: a
    row of the base bucket has degree >= 1, one of a wider bucket more
    than w / growth, and the 2E directed endpoints bound their count."""
    floor = 1 if w <= base else w // growth + 1
    return max(1, min(2 * shape.num_edges // floor, v))


def plan_contracts(knobs: Dict[str, int], shape: GraphShape, *,
                   batch: int = 1, n_parts: int = 1, base: int = 32,
                   growth: int = 2, bitmap: bool = False,
                   sms: int = C.H100_SMS) -> List[C.KernelContract]:
    """The wrapper calls a (knobs, graph) plan launches, one contract each.

    Mirrors the port's kernel call sites: a pull per ELL width of the
    ladder (the hub pull on the hub side of a `hub_split` plan, the same
    kernel), a push per width, and one packing call (without the bitmap;
    with it too for a partitioned plan's bitmap exchange). Rows per bucket
    come from the degree floor (`_row_bound`), biased high. A partitioned
    plan (`n_parts` > 1) runs single-lane calls over the padded id space,
    at most V + n_parts - 1 vertices.
    """
    from repro_torch.core import ell as ELL
    v = shape.num_vertices + (n_parts - 1 if n_parts > 1 else 0)
    v = max(v, 1)
    single = n_parts > 1
    b = 1 if single else max(int(batch), 1)
    hub_split = bool(int(knobs.get("hub_split", 0))) and not single
    w_hub = (ELL.hub_width(int(knobs.get("hub_deg", 256)), base, growth)
             if hub_split else None)
    widths = (ELL.bucket_widths(shape.max_degree, base, growth)
              if shape.max_degree > 0 else [])
    contracts: List[C.KernelContract] = []
    for w in widths:
        r = v if single else _row_bound(w, shape, v, base, growth)
        hub = hub_split and w >= w_hub
        pull = ("bottomup" if single else
                "hub_bottomup_batch" if hub else "bottomup_batch")
        contracts.append(C.pull_contract(b, r, w, v, kernel=pull, sms=sms))
        contracts.append(C.push_contract(
            b, r, w, v, sms=sms,
            kernel="topdown_push" if single else "topdown_push_batch"))
    ff = "frontier_fused" if single else "frontier_fused_batch"
    contracts.append(C.fused_contract(b, v, packed=False, kernel=ff, sms=sms))
    if single and bitmap:
        contracts.append(C.fused_contract(b, v, packed=True, kernel=ff,
                                          sms=sms))
    return contracts


@dataclasses.dataclass(frozen=True)
class KernelContractReport:
    """Static feasibility verdict for one plan over one graph shape."""
    plan: str
    graph: GraphShape
    budget_bytes: int
    checks: Tuple[KernelCheck, ...]

    @property
    def feasible(self) -> bool:
        return all(c.feasible for c in self.checks)

    @property
    def findings(self) -> Tuple[ContractFinding, ...]:
        return tuple(f for c in self.checks for f in c.findings)

    @property
    def errors(self) -> Tuple[ContractFinding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def total_bytes(self) -> int:
        return max((c.peak_bytes for c in self.checks), default=0)

    def to_json(self) -> dict:
        return {
            "plan": self.plan,
            "graph": self.graph.to_json(),
            "budget_bytes": self.budget_bytes,
            "feasible": self.feasible,
            "peak_kernel_bytes": self.total_bytes,
            "checks": [c.to_json() for c in self.checks],
        }

    def summary(self) -> str:
        verdict = "fits" if self.feasible else "OVER BUDGET"
        return (f"{self.plan}: {verdict}: peak shared memory a block "
                f"{self.total_bytes} B of {self.budget_bytes} B across "
                f"{len(self.checks)} kernel call(s), "
                f"{len(self.errors)} error(s)")


def contract_report(plan_key, graph_shape, *,
                    budget_bytes: Optional[int] = None,
                    batch: Optional[int] = None,
                    n_parts: Optional[int] = None,
                    base: int = 32, growth: int = 2,
                    sms: int = C.H100_SMS) -> KernelContractReport:
    """Static kernel feasibility of one plan on one graph shape.

    ``plan_key`` is a config object, knob dict, or session key (see
    `_extract_plan`); ``graph_shape`` a `GraphShape`, a `Graph`, or a
    ``(V, E, max_degree)`` triple. Explicit ``batch``/``n_parts`` override
    whatever the key implies. Deterministic and device-free: it imports
    the launchers for their plan functions but never initializes CUDA.
    """
    shape = _coerce_graph_shape(graph_shape)
    knobs, key_batch, key_parts = _extract_plan(plan_key)
    batch = key_batch if batch is None else int(batch)
    n_parts = key_parts if n_parts is None else int(n_parts)
    budget = (smem.DEFAULT_SMEM_BUDGET if budget_bytes is None
              else int(budget_bytes))
    checks = tuple(
        check_contract(con, budget_bytes=budget)
        for con in plan_contracts(knobs, shape, batch=batch, n_parts=n_parts,
                                  base=base, growth=growth,
                                  bitmap=_bitmap_exchange(plan_key),
                                  sms=sms))
    plan_desc = f"batch={batch} n_parts={n_parts}"
    if int(knobs.get("hub_split", 0)):
        plan_desc += f" hub_split=1 hub_deg={knobs['hub_deg']}"
    return KernelContractReport(plan=plan_desc, graph=shape,
                                budget_bytes=budget, checks=checks)


# Reference plans for the CLI's contract report: the JAX package's four,
# under their names, and one the gate must refuse. The JAX package
# documents scale22-single-device as infeasible (its widest ELL tile
# exceeds a TPU core's VMEM); on the H100 it fits: the kernels gather from
# device memory, a block's shared memory does not grow with the graph, and
# chip_smoke.py phase 4 runs that plan. A budget below the 8-lane pull
# instance's static shared memory (18,444 B) is refused: the proof that
# the gate can say no.
DEFAULT_PLANS = (
    ("scale16-default",
     dict(_KNOB_DEFAULTS),
     GraphShape(num_vertices=2 ** 16, num_edges=2 ** 20, max_degree=2048),
     dict(batch=8), True),
    ("scale22-single-device",
     dict(_KNOB_DEFAULTS),
     GraphShape(num_vertices=2 ** 22, num_edges=2 ** 26, max_degree=2 ** 15),
     dict(batch=8), True),
    ("scale22-sharded16-tuned",
     dict(td_chunk=4096, bu_chunk=8, bu_slab=32),
     GraphShape(num_vertices=2 ** 22, num_edges=2 ** 26, max_degree=2 ** 15),
     dict(n_parts=16), True),
    ("scale22-hub-split",
     dict(td_chunk=4096, bu_chunk=512, bu_slab=32,
          hub_split=1, hub_deg=2048, hub_slab=256),
     GraphShape(num_vertices=2 ** 22, num_edges=2 ** 26, max_degree=2 ** 15),
     dict(batch=8), True),
    ("scale16-under-budget",
     dict(_KNOB_DEFAULTS),
     GraphShape(num_vertices=2 ** 16, num_edges=2 ** 20, max_degree=2048),
     dict(batch=8, budget_bytes=16 * 1024), False),
)


def default_plan_reports(budget_bytes: Optional[int] = None) -> dict:
    """The CLI's contract report: `contract_report` of DEFAULT_PLANS (a
    plan with its own budget keeps it)."""
    out = {}
    for name, knobs, shape, extra, _feasible in DEFAULT_PLANS:
        kw = dict(extra)
        kw.setdefault("budget_bytes", budget_bytes)
        out[name] = contract_report(knobs, shape, **kw).to_json()
    return out


# --------------------------------------------------------------- CLI gate --


def _kernels_relpath(module: str) -> str:
    return f"src/repro_torch/kernels/{module}.py"


def reference_findings() -> List[ContractFinding]:
    """KC001/KC002/KC004 over every registered kernel's reference
    instantiation (the JAX package's KC003 is a TPU tiling lint with no
    CUDA counterpart)."""
    out: List[ContractFinding] = []
    for name in C.registered_kernels():
        out.extend(check_contract(C.REGISTRY[name].reference_contract())
                   .findings)
    return out


def _launch_sites(tree: ast.AST) -> List[Tuple[str, int]]:
    """(enclosing function name, line) for each ``_build.launch(`` call."""
    sites: List[Tuple[str, int]] = []

    def walk(node: ast.AST, owner: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, child.name)
                continue
            if isinstance(child, ast.Call):
                func = child.func
                if (isinstance(func, ast.Attribute) and func.attr == "launch"
                        and isinstance(func.value, ast.Name)
                        and func.value.id == "_build"):
                    sites.append((owner or "<module>", child.lineno))
            walk(child, owner)

    walk(tree, None)
    return sites


def registry_gate(sources: Dict[str, str]) -> List[Finding]:
    """KC005: every `_build.launch` site in repro_torch/kernels/ sits in a
    launcher that has a registered contract."""
    out: List[Finding] = []
    for path, src in sorted(sources.items()):
        if "repro_torch/kernels/" not in path:
            continue
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError:
            continue   # the core linter already reports ERR001
        module = path.rsplit("/", 1)[-1][:-len(".py")]
        for owner, line in _launch_sites(tree):
            if f"{module}.{owner}" not in C.REGISTRY:
                out.append(Finding(
                    rule="KC005", path=path, line=line, col=0,
                    message=f"_build.launch in '{module}.{owner}' has no "
                            f"registered kernel contract; add a builder "
                            f"and a registry entry in "
                            f"repro_torch.kernels.contracts so the static "
                            f"verifier covers it"))
    return out


def run_gate(sources: Dict[str, str]) -> Tuple[List[Finding], List[Finding]]:
    """The ``--kernel-contracts`` CLI gate. Returns (errors, warnings), as
    the JAX gate does; the port has no warning-only rule, so the second
    is empty.

    Errors: KC005 sites from the AST scan, every finding of the registered
    references (anchored to the launcher's module file), and a reference
    plan whose verdict is not the one DEFAULT_PLANS documents (a plan
    that should fit and does not, or the refusing plan that fits: the gate
    could not say no).
    """
    errors = registry_gate(sources)
    for name in C.registered_kernels():
        spec = C.REGISTRY[name]
        path = _kernels_relpath(spec.module)
        for cf in check_contract(spec.reference_contract()).findings:
            errors.append(Finding(
                rule=cf.rule, path=path, line=1, col=0,
                message=f"[{cf.kernel} @ reference] {cf.message}"))
    for name, knobs, shape, extra, feasible in DEFAULT_PLANS:
        rep = contract_report(knobs, shape, **extra)
        if rep.feasible != feasible:
            rule = rep.errors[0].rule if rep.errors else "KC001"
            errors.append(Finding(
                rule=rule, path="src/repro_torch/analysis/kernel_contracts.py",
                line=1, col=0,
                message=f"reference plan {name}: {rep.summary()}; expected "
                        f"{'fits' if feasible else 'OVER BUDGET'}"))
    return errors, []


def gate_paths(paths: Sequence[str],
               root: Optional[str] = None) -> Tuple[List[Finding],
                                                    List[Finding]]:
    """Load the sources under `paths` (paths relative to `root`, default
    the working directory) and run the gate (`run_gate`)."""
    return run_gate(load_sources(paths, root or os.getcwd()))

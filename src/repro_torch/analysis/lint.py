"""Lint core: findings, suppressions, baseline, and the file-walking driver.

The port's copy of the JAX package's `analysis/lint.py`; the analyzer is a
thin AST pipeline:

  * :mod:`repro_torch.analysis.rules` contributes per-file AST rules (host
    syncs, rebuild hazards, plan-key hygiene, clamped ELL gathers,
    lock-scope checks).
  * :mod:`repro_torch.analysis.deadcode` contributes whole-tree rules (the
    DC001 quarantine gate) that need the import graph.
  * This module owns the plumbing shared by both: the :class:`Finding`
    record, ``# repro-ok:`` suppression comments, and the checked-in
    baseline file.

It imports no torch: linting a tree costs no device library.

Suppression syntax
------------------
A finding is suppressed by a comment on the same line, or on the line
immediately above (a comment-only line), with the marker of the JAX
package's linter, so one comment serves both::

    torch.cuda.synchronize(device)  # repro-ok: TH001 the level's timing fence

    # repro-ok: LS001 attach-time init, session not yet shared
    self._prewarm_stop = threading.Event()

The reason text after the rule id is MANDATORY.  A suppression without a
reason is itself reported as ``SUP001`` and cannot be suppressed.

Baseline
--------
``src/repro_torch/analysis/baseline.json`` holds grandfathered findings as
``{rule, path, text, reason}`` entries matched by (rule, relative path,
stripped source line).  Every entry must carry a non-empty ``reason``.
The goal state is an *empty* baseline: real findings are fixed or
justified inline at the site.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*repro-ok:\s*(?P<rules>[A-Z]{2,3}\d{3}(?:\s*,\s*[A-Z]{2,3}\d{3})*)(?P<reason>[^#]*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnostic, anchored to a source line."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppressions:
    """Parsed ``# repro-ok:`` directives for one file."""

    # line number -> set of rule ids suppressed at that line
    by_line: Dict[int, Set[str]]
    # malformed directives (missing reason), reported as SUP001
    malformed: List[Finding]
    # directives that matched no finding (line -> rules), for unused reporting
    used: Set[Tuple[int, str]] = dataclasses.field(default_factory=set)

    def covers(self, finding: Finding) -> bool:
        for ln in (finding.line, finding.line - 1):
            rules = self.by_line.get(ln)
            if rules and finding.rule in rules:
                self.used.add((ln, finding.rule))
                return True
        return False


def parse_suppressions(source: str, path: str) -> Suppressions:
    by_line: Dict[int, Set[str]] = {}
    malformed: List[Finding] = []
    for i, raw in enumerate(source.splitlines(), start=1):
        m = SUPPRESS_RE.search(raw)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",")}
        reason = m.group("reason").strip()
        if not reason:
            malformed.append(
                Finding(
                    rule="SUP001",
                    path=path,
                    line=i,
                    col=raw.index("#"),
                    message="suppression without a reason: every '# repro-ok:' "
                    "directive must justify itself ('# repro-ok: RULE why')",
                )
            )
            continue
        by_line.setdefault(i, set()).update(rules)
    return Suppressions(by_line=by_line, malformed=malformed)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    text: str  # stripped source line the finding anchors to
    reason: str


class BaselineError(ValueError):
    pass


def load_baseline(path: str) -> List[BaselineEntry]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    entries = data.get("entries", []) if isinstance(data, dict) else data
    out: List[BaselineEntry] = []
    for e in entries:
        reason = str(e.get("reason", "")).strip()
        if not reason:
            raise BaselineError(
                f"baseline entry for {e.get('rule')} at {e.get('path')} has no "
                "reason: every grandfathered finding must be justified"
            )
        out.append(
            BaselineEntry(
                rule=str(e["rule"]),
                path=str(e["path"]),
                text=str(e.get("text", "")).strip(),
                reason=reason,
            )
        )
    return out


def save_baseline(path: str, findings: Sequence[Finding], sources: Dict[str, str]) -> None:
    entries = []
    for f in findings:
        lines = sources.get(f.path, "").splitlines()
        text = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        entries.append(
            {
                "rule": f.rule,
                "path": f.path,
                "text": text,
                "reason": "TODO: justify or fix",
            }
        )
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"entries": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def _baseline_match(
    finding: Finding, line_text: str, baseline: Sequence[BaselineEntry]
) -> Optional[BaselineEntry]:
    stripped = line_text.strip()
    for e in baseline:
        if e.rule == finding.rule and e.path == finding.path and e.text == stripped:
            return e
    return None


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]  # actionable (not suppressed, not baselined)
    suppressed: List[Finding]
    baselined: List[Finding]
    errors: List[Finding]  # parse failures, malformed suppressions

    @property
    def ok(self) -> bool:
        return not self.findings and not self.errors


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def relpath_for(path: str, root: Optional[str] = None) -> str:
    """Normalized repo-relative posix path used for rule scoping and baselines."""
    root = root or os.getcwd()
    try:
        rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    except ValueError:  # different drive (windows); keep as-is
        rel = path
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


def load_sources(paths: Sequence[str], root: str) -> Dict[str, str]:
    """{repo-relative path: source} of the Python files under `paths`
    (unreadable files skipped): the CLI's and the contract gate's loader."""
    sources: Dict[str, str] = {}
    for fp in iter_python_files(paths):
        try:
            with open(fp, "r", encoding="utf-8") as fh:
                sources[relpath_for(fp, root)] = fh.read()
        except OSError:
            continue
    return sources


def lint_source(
    source: str,
    path: str,
    rules: Optional[Sequence[object]] = None,
) -> Tuple[List[Finding], List[Finding], Suppressions]:
    """Lint one file's source. ``path`` is the normalized relative path used
    for rule scoping. Returns (active findings, suppressed findings, supps)."""
    from repro_torch.analysis import rules as rules_mod

    active_rules = list(rules) if rules is not None else rules_mod.default_rules()
    supps = parse_suppressions(source, path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return (
            [
                Finding(
                    rule="ERR001",
                    path=path,
                    line=exc.lineno or 1,
                    col=exc.offset or 0,
                    message=f"syntax error: {exc.msg}",
                )
            ],
            [],
            supps,
        )
    found: List[Finding] = []
    for rule in active_rules:
        if rule.applies(path):
            found.extend(rule.check(tree, source, path))
    found.sort(key=lambda f: (f.line, f.col, f.rule))
    hot = [f for f in found if not supps.covers(f)]
    cold = [f for f in found if f not in hot]
    return hot, cold, supps


def run_lint(
    paths: Sequence[str],
    *,
    root: Optional[str] = None,
    rules: Optional[Sequence[object]] = None,
    baseline: Optional[Sequence[BaselineEntry]] = None,
    project_rules: Optional[Sequence[object]] = None,
) -> LintResult:
    """Lint every python file under ``paths``.

    ``project_rules`` are whole-tree rules (e.g. the DC001 quarantine gate)
    with a ``check_project(sources) -> List[Finding]`` method, where
    ``sources`` maps normalized relative paths to file contents.
    """
    baseline = list(baseline or [])
    sources: Dict[str, str] = {}
    result = LintResult(findings=[], suppressed=[], baselined=[], errors=[])
    supp_by_path: Dict[str, Suppressions] = {}
    for fp in iter_python_files(paths):
        rel = relpath_for(fp, root)
        try:
            with open(fp, "r", encoding="utf-8") as fh:
                src = fh.read()
        except OSError as exc:
            result.errors.append(
                Finding(rule="ERR002", path=rel, line=1, col=0, message=str(exc))
            )
            continue
        sources[rel] = src
        hot, cold, supps = lint_source(src, rel, rules=rules)
        supp_by_path[rel] = supps
        result.errors.extend(supps.malformed)
        result.suppressed.extend(cold)
        for f in hot:
            if f.rule == "ERR001":
                result.errors.append(f)
                continue
            lines = src.splitlines()
            text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
            if _baseline_match(f, text, baseline) is not None:
                result.baselined.append(f)
            else:
                result.findings.append(f)

    for prule in project_rules or []:
        for f in prule.check_project(sources):
            supps = supp_by_path.get(f.path)
            if supps is not None and supps.covers(f):
                result.suppressed.append(f)
                continue
            lines = sources.get(f.path, "").splitlines()
            text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
            if _baseline_match(f, text, baseline) is not None:
                result.baselined.append(f)
            else:
                result.findings.append(f)

    result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return result

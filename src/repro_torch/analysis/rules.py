"""AST rule catalog of the port's linter.

The port's counterpart of the JAX package's `analysis/rules.py`. Per-file
rules, each with a stable id used in ``# repro-ok:`` suppressions and the
baseline file:

===== ====================================================================
TH001 explicit host sync (``torch.cuda.synchronize``, an event's or a
      stream's ``.synchronize()``, ``.cpu()``) in the engine layer
      outside the sanctioned sites (``level_loop.host_sync``, ``finalize``)
TH002 implicit host sync: ``float()``/``int()``/``bool()``/``np.asarray``
      of a torch value, or its ``.item()``/``.tolist()``/``.numpy()``
TH003 rebuild hazard: ``torch.compile``, ``torch.jit.script``/``trace``,
      ``torch.cuda.CUDAGraph()`` or ``_build.build_all`` inside a
      ``for``/``while`` body
PK001 unhashable plan-key ingredient (list/dict/set/lambda/comprehension)
      passed to ``session.executable(...)`` / ``session.cached(...)``
PL002 unclamped gather on a ragged ELL tile: an advanced index,
      ``gather`` or ``index_select`` whose index is raw ``nbrs`` not
      passed through ``.clamp``
LS001 attribute of a lock-owning class mutated outside any
      ``with self._lock`` scope (outside ``__init__``)
===== ====================================================================

The JAX package's PL001 (Pallas grid/BlockSpec consistency) has no CUDA
counterpart: a CUDA launch has no BlockSpec, and its grid is the kernel
contracts' to prove (KC002). Whole-tree rules (DC001) live in
:mod:`repro_torch.analysis.deadcode`; the KC rules in
:mod:`repro_torch.analysis.kernel_contracts`.

The rules are tuned to this codebase, not general-purpose: scoping is by
path (``repro_torch/engine/``, ``repro_torch/kernels/``), and the dataflow
in TH002 and PL002 is deliberately local and conservative: a name whose
origin the rule cannot see is never flagged. Importing this module imports
no torch.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lint import Finding

_LOCK_CTORS = {
    "Lock",
    "RLock",
    "Condition",
    "make_lock",
    "make_rlock",
    "make_condition",
}

# Attributes (and torch functions) whose value lives on the host: a chain
# through one of them is not a device value.
_HOST_ATTRS = {
    "shape", "dtype", "device", "is_cuda", "ndim", "numel", "dim", "size",
    "stride", "data_ptr", "element_size", "nbytes", "itemsize",
    "is_contiguous", "device_count", "is_available", "get_device_name",
    "get_device_properties", "current_device", "current_stream",
    "cuda_stream", "finfo", "iinfo", "Size", "cpu", "numpy", "item",
    "tolist", "is_initialized", "get_rank", "get_world_size",
}

# KC rules (the `--kernel-contracts` gate): titles kept here so that the
# catalog costs no import of the launchers (and of torch).
KC_RULES = {
    "KC001": "kernel instance's per-CTA shared memory, threads or "
             "registers exceed the smem budget",
    "KC002": "launch plan does not cover its (lane, row), S or V range "
             "exactly once within the grid limits",
    "KC004": "gather indices not provably within [0, V) after the clip",
    "KC005": "_build.launch site without a registered kernel contract",
}
# The JAX package's rules that have no CUDA counterpart here.
TPU_ONLY_RULES = {
    "PL001": "TPU only (Pallas grid/BlockSpec shapes): no CUDA "
             "counterpart; a CUDA launch has no BlockSpec, KC002 proves "
             "its grid",
    "KC003": "TPU only (Mosaic min-tile alignment): no CUDA counterpart",
    "KC006": "TPU only (BlockSpec index-map arity/affineness): no CUDA "
             "counterpart",
}


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None when the chain has a non-name root."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def _chain_attrs(node: ast.AST) -> Tuple[Set[str], Optional[str]]:
    """(every attribute name along an expression chain, its root Name)."""
    attrs: Set[str] = set()
    while True:
        if isinstance(node, ast.Name):
            return attrs, node.id
        if isinstance(node, ast.Attribute):
            attrs.add(node.attr)
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            return attrs, None


def _calls_with_owners(tree: ast.AST) -> Iterator[Tuple[ast.Call, Tuple[str, ...]]]:
    """Every call with the names of the functions that enclose it."""
    def walk(node: ast.AST, owners: Tuple[str, ...]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, owners + (child.name,))
                continue
            if isinstance(child, ast.Call):
                yield child, owners
            yield from walk(child, owners)
    yield from walk(tree, ())


class Rule:
    id: str = ""
    title: str = ""

    def applies(self, path: str) -> bool:
        return True

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        raise NotImplementedError

    def _finding(self, path: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


# ---------------------------------------------------------------------------
# TH001 — explicit host syncs in the engine layer
# ---------------------------------------------------------------------------


class ExplicitHostSync(Rule):
    id = "TH001"
    title = "explicit host sync outside the sanctioned per-level sync"

    def applies(self, path: str) -> bool:
        return "repro_torch/engine/" in path

    @staticmethod
    def _sanctioned(path: str, owners: Tuple[str, ...]) -> bool:
        if "finalize" in owners:
            return True
        return path.endswith("engine/level_loop.py") and "host_sync" in owners

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for node, owners in _calls_with_owners(tree):
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if func.attr not in {"synchronize", "cpu"}:
                continue
            if self._sanctioned(path, owners):
                continue
            chain = _attr_chain(func)
            if func.attr == "cpu":
                what = ".cpu() copies to the host and waits for the device"
            elif chain and chain[:3] == ["torch", "cuda", "synchronize"]:
                what = "torch.cuda.synchronize waits for the whole device"
            else:
                what = (".synchronize() on an event or stream blocks the "
                        "host")
            out.append(
                self._finding(
                    path,
                    node,
                    f"{what} in the engine layer: the only sanctioned "
                    "syncs are level_loop.host_sync (one a level) and "
                    "finalize; justify other sites with "
                    "'# repro-ok: TH001 <why>'",
                )
            )
        return out


# ---------------------------------------------------------------------------
# TH002 — implicit host syncs on torch values
# ---------------------------------------------------------------------------


class ImplicitHostSync(Rule):
    id = "TH002"
    title = "implicit host sync on a torch value"

    def applies(self, path: str) -> bool:
        return "repro_torch/engine/" in path or "repro_torch/core/" in path

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_function(fn, path))
        return out

    @staticmethod
    def _is_device_expr(node: ast.AST, device_names: Set[str]) -> bool:
        """A value whose root is a torch call (or a name assigned one),
        reached through no attribute that lives on the host."""
        if not isinstance(node, (ast.Name, ast.Attribute, ast.Call,
                                 ast.Subscript)):
            return False
        attrs, root = _chain_attrs(node)
        if root is None or attrs & _HOST_ATTRS:
            return False
        if root == "torch":
            return isinstance(node, (ast.Call, ast.Subscript))
        return root in device_names

    def _check_function(self, fn: ast.AST, path: str) -> List[Finding]:
        out: List[Finding] = []
        device: Set[str] = set()
        # one pass seeds the device set from assignments, a second checks
        # the consuming calls against it
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name) and self._is_device_expr(
                        node.value, device):
                    device.add(tgt.id)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in {"float", "int", "bool"}
                and len(node.args) == 1
                and self._is_device_expr(node.args[0], device)
            ):
                out.append(
                    self._finding(
                        path,
                        node,
                        f"{node.func.id}() of a torch value waits for the "
                        "device and copies it to the host; read it in "
                        "level_loop.host_sync with the level's other "
                        "scalars, or keep it on the device",
                    )
                )
                continue
            chain = _attr_chain(node.func)
            if (
                chain
                and chain[0] in {"np", "numpy"}
                and chain[-1] in {"asarray", "array"}
                and node.args
                and self._is_device_expr(node.args[0], device)
            ):
                out.append(
                    self._finding(
                        path,
                        node,
                        f"{'.'.join(chain)} of a torch value is an implicit "
                        "device-to-host copy; make it at the sanctioned "
                        "sync point instead",
                    )
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in {"item", "tolist", "numpy"}
                and self._is_device_expr(node.func.value, device)
            ):
                out.append(
                    self._finding(
                        path,
                        node,
                        f".{node.func.attr}() of a torch value blocks on the "
                        "device; batch the transfer at the sanctioned sync "
                        "point",
                    )
                )
        return out


# ---------------------------------------------------------------------------
# TH003 — rebuild hazards: compiled/captured/built objects inside loops
# ---------------------------------------------------------------------------


class RebuildHazard(Rule):
    id = "TH003"
    title = "compile/capture/kernel build constructed inside a loop"

    _CTORS = (
        ("torch", "compile"),
        ("torch", "jit", "script"),
        ("torch", "jit", "trace"),
        ("torch", "cuda", "CUDAGraph"),
    )

    def applies(self, path: str) -> bool:
        return "repro_torch/" in path

    def _is_ctor(self, chain: List[str]) -> bool:
        if tuple(chain) in self._CTORS:
            return True
        return chain[-1] == "build_all" and (len(chain) == 1
                                             or chain[-2] == "_build")

    def _loop_calls(self, loop: ast.AST) -> Iterator[ast.Call]:
        """Calls lexically inside `loop`, not inside a nested def (which
        runs only when called, which this rule cannot see)."""
        stack = list(ast.iter_child_nodes(loop))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        seen: Set[int] = set()
        for loop in ast.walk(tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in self._loop_calls(loop):
                chain = _attr_chain(node.func)
                if not chain or not self._is_ctor(chain) or id(node) in seen:
                    continue
                seen.add(id(node))
                out.append(
                    self._finding(
                        path,
                        node,
                        f"{'.'.join(chain)} inside a loop rebuilds on every "
                        "iteration; build it once outside the loop and "
                        "reuse it (or cache it via session.executable)",
                    )
                )
        out.sort(key=lambda f: (f.line, f.col))
        return out


# ---------------------------------------------------------------------------
# PK001 — plan-key hygiene
# ---------------------------------------------------------------------------


class PlanKeyHygiene(Rule):
    id = "PK001"
    title = "unhashable plan-key ingredient"

    _SINKS = {"executable", "cached"}
    _BAD = (
        ast.List,
        ast.Dict,
        ast.Set,
        ast.Lambda,
        ast.ListComp,
        ast.SetComp,
        ast.DictComp,
        ast.GeneratorExp,
    )

    def applies(self, path: str) -> bool:
        return "repro_torch/engine/" in path or "repro_torch/runtime/" in path

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            if not (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in self._SINKS
            ):
                continue
            key_exprs: List[ast.AST] = list(node.args[:1])
            key_exprs.extend(kw.value for kw in node.keywords if kw.arg == "key")
            for expr in key_exprs:
                for sub in ast.walk(expr):
                    if isinstance(sub, self._BAD):
                        kind = type(sub).__name__.lower()
                        out.append(
                            self._finding(
                                path,
                                sub,
                                f"plan-key argument to .{node.func.attr}() "
                                f"contains a {kind}: keys must be hashable, "
                                "stable tuples of scalars (closures and "
                                "mutable containers silently defeat the "
                                "plan cache)",
                            )
                        )
                        break
        return out


# ---------------------------------------------------------------------------
# PL002 — unclamped gathers on ragged ELL tiles
# ---------------------------------------------------------------------------


class UnmaskedGather(Rule):
    id = "PL002"
    title = "unclamped gather on a ragged ELL tile"

    _GATHERS = {"gather", "index_select"}
    _CLAMPS = {"clamp", "clamp_", "clip", "clip_"}

    def applies(self, path: str) -> bool:
        return "repro_torch/kernels/" in path

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(self._check_function(fn, path))
        return out

    @classmethod
    def _raw_root(cls, node: ast.AST, raw: Set[str]) -> Optional[str]:
        """The raw neighbour-id name `node` indexes with, unclamped; None
        when it is clamped along the way or not rooted at a raw name."""
        attrs, root = _chain_attrs(node)
        if root not in raw or attrs & (cls._CLAMPS | _HOST_ATTRS):
            return None
        return root

    def _index_exprs(self, node: ast.AST) -> List[ast.AST]:
        """The index expressions a subscript or gather call uses."""
        if isinstance(node, ast.Subscript):
            sl = node.slice
            elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
            return [e for e in elts if not isinstance(e, ast.Slice)]
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in self._GATHERS:
            chain = _attr_chain(node.func)
            args = list(node.args)
            if chain and chain[0] == "torch":
                args = args[1:]            # torch.gather(input, dim, index)
            idx = args[1:2]
            idx += [kw.value for kw in node.keywords if kw.arg == "index"]
            return idx
        return []

    def _check_function(self, fn: ast.AST, path: str) -> List[Finding]:
        raw: Set[str] = {
            a.arg for a in fn.args.args if a.arg.endswith("nbrs")
        }
        if not raw:
            return []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name) and \
                        self._raw_root(node.value, raw) is not None:
                    raw.add(tgt.id)
        out: List[Finding] = []
        for node in ast.walk(fn):
            for idx in self._index_exprs(node):
                for sub in ast.walk(idx):
                    name = self._raw_root(sub, raw) if isinstance(
                        sub, (ast.Name, ast.Attribute, ast.Call,
                              ast.Subscript)) else None
                    if name is None:
                        continue
                    out.append(
                        self._finding(
                            path,
                            node,
                            f"gather indexed by '{name}', raw ELL neighbour "
                            "ids not passed through .clamp: padded slots "
                            "and the partitioned path's pad rows hold "
                            "out-of-range ids, so clamp to [0, V) first "
                            "(safe = nbrs.clamp(0, v - 1)) and mask after",
                        )
                    )
                    break
        return out


# ---------------------------------------------------------------------------
# LS001 — lock-scope discipline in threaded classes
# ---------------------------------------------------------------------------


class LockScope(Rule):
    id = "LS001"
    title = "attribute mutated outside the owning class's lock scope"

    def applies(self, path: str) -> bool:
        return "repro_torch/" in path

    def check(self, tree: ast.AST, source: str, path: str) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(node, path))
        return out

    @staticmethod
    def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
        locks: Set[str] = set()
        for item in cls.body:
            if not (isinstance(item, ast.FunctionDef) and item.name == "__init__"):
                continue
            for node in ast.walk(item):
                if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                    continue
                tgt = node.targets[0]
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                val = node.value
                if isinstance(val, ast.Call):
                    chain = _attr_chain(val.func)
                    if chain and chain[-1] in _LOCK_CTORS:
                        locks.add(tgt.attr)
        return locks

    def _check_class(self, cls: ast.ClassDef, path: str) -> List[Finding]:
        locks = self._lock_attrs(cls)
        if not locks:
            return []

        # (attr, node, guarded) mutation sites per method, excluding __init__
        sites: List[Tuple[str, ast.AST, bool]] = []

        def visit(node: ast.AST, guarded: bool) -> None:
            if isinstance(node, ast.With):
                holds = guarded
                for item in node.items:
                    ce = item.context_expr
                    if (
                        isinstance(ce, ast.Attribute)
                        and isinstance(ce.value, ast.Name)
                        and ce.value.id == "self"
                        and ce.attr in locks
                    ):
                        holds = True
                for child in node.body:
                    visit(child, holds)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    base = tgt
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if (
                        isinstance(base, ast.Attribute)
                        and isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                        and base.attr not in locks
                    ):
                        sites.append((base.attr, node, guarded))
            for child in ast.iter_child_nodes(node):
                visit(child, guarded)

        for item in cls.body:
            if isinstance(item, ast.FunctionDef) and item.name != "__init__":
                visit(item, False)

        guarded_attrs = {a for a, _, g in sites if g}
        out: List[Finding] = []
        for attr, node, guarded in sites:
            if guarded:
                continue
            if attr in guarded_attrs:
                msg = (
                    f"self.{attr} is mutated both inside and outside "
                    f"'with self.<lock>' scopes in {cls.name}; the unguarded "
                    "write races the guarded ones"
                )
            else:
                msg = (
                    f"self.{attr} is mutated without holding any of "
                    f"{cls.name}'s locks ({', '.join(sorted(locks))}); guard "
                    "it or justify with '# repro-ok: LS001 <why>'"
                )
            out.append(self._finding(path, node, msg))
        return out


_RULES: Sequence[Rule] = (
    ExplicitHostSync(),
    ImplicitHostSync(),
    RebuildHazard(),
    PlanKeyHygiene(),
    UnmaskedGather(),
    LockScope(),
)


def default_rules() -> Sequence[Rule]:
    return _RULES


def rule_catalog() -> Dict[str, str]:
    """rule id -> one-line title (includes whole-tree and KC rules, and the
    JAX package's rules that have no CUDA counterpart)."""
    cat = {r.id: r.title for r in _RULES}
    cat["DC001"] = "BFS-core module imports a quarantined template module"
    cat["SUP001"] = "suppression directive without a reason"
    cat.update(KC_RULES)
    cat.update(TPU_ONLY_RULES)
    return cat

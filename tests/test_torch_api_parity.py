"""Every public name of the JAX package has its counterpart in the port.

An `ast` walk of `src/repro/**/*.py` and `src/repro_torch/**/*.py` (it
imports neither package). A public name is a top-level function or class
whose name does not start with "_", or a public method (a function in
the class body, properties included) of such a class. For each public
name of each JAX module, exactly one holds:

* (a) the port's module of the same path defines the same name;
* (b) `COUNTERPARTS` maps it to a port name that exists: "module:name"
  (a method as "Class.method", a class field as "Class.field"), or a bare
  name in the port's module of the same path;
* (c) `JAX_ONLY` says in one line why it exists only for JAX, XLA, Pallas
  or the TPU; the reason names the one it exists for.

A table entry that names nothing in the JAX package, that (a) already
covers, or that both tables hold fails the test, and so does a reason
that reads "not ported" or names none of them.
"""
import ast
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
JAX_PKG = SRC / "repro"
PORT_PKG = SRC / "repro_torch"

# JAX module -> {JAX name: port name}. Two modules map as a whole:
# `kernels/ref.py` (the jnp oracles) to the plain forms of each kernel
# module, `analysis/vmem.py` (the TPU's VMEM model) to `analysis/smem.py`
# (the H100's shared-memory model).
COUNTERPARTS = {
    "analysis/vmem.py": {
        "VmemModelError": "analysis/smem.py:SmemModelError",
        "dtype_bytes": "analysis/smem.py:dtype_bytes",
        "block_bytes": "analysis/smem.py:SharedArray.nbytes",
        "VmemReport": "analysis/smem.py:SmemReport",
        "VmemReport.fits": "analysis/smem.py:SmemReport.fits",
        "VmemReport.utilization": "analysis/smem.py:SmemReport.utilization",
        "VmemReport.to_json": "analysis/smem.py:SmemReport.to_json",
        "vmem_report": "analysis/smem.py:smem_report",
    },
    "kernels/ref.py": {
        "bottomup_ref": "kernels/bottomup.py:bottomup_plain",
        "topdown_ref": "kernels/topdown.py:topdown_plain",
        "frontier_fused_ref": "kernels/frontier_fused.py:frontier_fused_plain",
        "decode_attention_ref":
            "kernels/decode_attn.py:decode_attention_plain",
    },
    # the Pallas wrappers -> the launchers of the Hopper kernels
    # (`kernels/csrc/*.cu`; PERF.md §6, rows 1-9)
    "kernels/bottomup.py": {
        "bottomup_batch_pallas": "bottomup_batch_cuda",             # row 1
        "bottomup_pallas": "kernels/ops.py:bottomup",               # row 5
    },
    "kernels/topdown.py": {
        "topdown_batch_pallas": "topdown_batch_cuda",               # row 2
        "topdown_pallas": "topdown_cuda",                           # row 6
    },
    "kernels/frontier_fused.py": {
        "frontier_fused_batch_pallas": "frontier_fused_batch_cuda",  # row 3
        "frontier_fused_pallas": "kernels/ops.py:frontier_fused",    # row 7
    },
    "kernels/hub.py": {
        "hub_bottomup_batch_pallas": "hub_bottomup_batch_cuda",     # row 4
        "hub_bottomup_pallas": "kernels/ops.py:hub_bottomup",       # row 8
    },
    "kernels/decode_attn.py": {
        "decode_attention_pallas": "decode_attention_cuda",         # row 9
    },
    "kernels/contracts.py": {
        "width_ladder": "core/ell.py:bucket_widths",
        "hub_width": "core/ell.py:hub_width",
        "bottomup_contract": "pull_contract",
        "bottomup_batch_contract": "pull_contract",
        "hub_bottomup_contract": "pull_contract",
        "hub_bottomup_batch_contract": "pull_contract",
        "topdown_contract": "fresh_contract",
        "topdown_batch_contract": "fresh_contract",
        "frontier_fused_contract": "fused_contract",
        "frontier_fused_batch_contract": "fused_contract",
        "decode_attention_contract": "decode_contract",
    },
    "analysis/rules.py": {
        "RetraceHazard": "RebuildHazard",                # TH003
        "RetraceHazard.applies": "RebuildHazard.applies",
        "RetraceHazard.check": "RebuildHazard.check",
    },
    # the port's backends step in one call where the reference computes
    # and exchanges (identity when fused), and read their sync payload
    # from the step's pieces
    "engine/level_loop.py": {
        "SingleStepBackend.compute": "SingleStepBackend.step",
        "SingleStepBackend.exchange": "SingleStepBackend.step",
        "SingleStepBackend.scalars": "core/bfs.py:state_scalars",
        "BSPStepBackend.scalars": "core/hybrid_bfs.py:HybridStepper.scalars",
        "CohortBatchBackend.compute": "CohortBatchBackend.step",
        "CohortBatchBackend.exchange": "CohortBatchBackend.step",
        "CohortBatchBackend.row_extra": "CohortBatchBackend.row",
    },
    # a port plan is built, not traced; a partition is a rank of a group
    "engine/session.py": {
        "GraphSession.mesh_for": "GraphSession.group_for",
        "GraphSession.trace_count": "GraphSession.runtime_stats",
        "GraphSession.total_traces": "GraphSession.total_builds",
    },
    "launch/dryrun.py": {
        "collective_bytes": "Tally",
    },
    "models/decode.py": {
        "cache_shapes": "init_cache",          # init_cache(..., device="meta")
    },
    "models/flags.py": {
        "remat_policy": "remat_context_fn",
    },
    "models/layers.py": {
        "init_attention": "Attention",
        "attention": "Attention.forward",
        "init_mlp": "MLP",
        "mlp": "MLP.forward",
        "init_embed": "Embedding",
        "embed": "Embedding.embed",
        "unembed": "unembed_logits",
    },
    "parallel/sharding.py": {
        "to_shardings": "placements",
    },
}

# JAX module -> {JAX name: why only JAX, XLA, Pallas or the TPU has it}
JAX_ONLY = {
    "analysis/vmem.py": {
        "min_tile": "the Mosaic (sublane, lane) tile of a TPU block",
        "BlockCost": "one Pallas BlockSpec's VMEM buffers (1 or 2, "
                     "pipelined); a CUDA block's are `smem.SharedArray`s",
        "BlockCost.to_json": "the JSON of a Pallas BlockSpec's VMEM cost",
        "cost_block": "prices one Pallas BlockSpec in VMEM",
        "tiling_misalignments": "Mosaic's TPU tiling lints (KC003)",
    },
    "analysis/rules.py": {
        "PallasShapeConsistency": "PL001 lints Pallas grids and BlockSpecs",
        "PallasShapeConsistency.applies": "PL001's Pallas scope",
        "PallasShapeConsistency.check": "PL001's Pallas check",
    },
    "kernels/contracts.py": {
        "require_divisible": "a Pallas grid of n // block steps drops the "
                             "tail; the CUDA launchers take any row count",
        "check_frontier_residency": "a Pallas BlockSpec holds the whole "
                                    "frontier in TPU VMEM",
        "ceil_to": "pads a dim to a Pallas block multiple; the CUDA "
                   "kernels take any row count",
        "BlockContract": "one Pallas BlockSpec, instantiated; a CUDA "
                         "launch's shared arrays are `smem.KernelInstance`",
    },
    "core/bfs.py": {
        "DeviceGraph.tree_flatten": "a JAX pytree hook",
        "DeviceGraph.tree_unflatten": "a JAX pytree hook",
        "BFSState.tree_flatten": "a JAX pytree hook",
        "BFSState.tree_unflatten": "a JAX pytree hook",
        "BatchState.tree_flatten": "a JAX pytree hook",
        "BatchState.tree_unflatten": "a JAX pytree hook",
    },
    "core/hybrid_bfs.py": {
        "default_mesh": "a JAX device mesh; a port partition is a rank of "
                        "a process group (`GraphSession.group_for`)",
    },
    "launch/dryrun.py": {
        "lower_cell": "lowers a cell with XLA on the fake mesh; the port "
                      "runs it on DTensors (`run_cell`)",
        "probe_cell": "corrects XLA's cost analysis, which counts a scan "
                      "body once; the port's `Tally` counts every op",
    },
    "models/flags.py": {
        "scan_unroll": "the unroll of JAX's `lax.scan` over layers",
    },
    "parallel/collectives.py": {
        "shard_map_compat": "`shard_map` across JAX versions",
    },
    "runtime/artifact_cache.py": {
        "aot_serialization_available": "whether this JAX can serialize "
                                       "compiled XLA executables",
        "enable_xla_fallback_cache": "XLA's persistent compilation cache",
    },
}

REASON_NAMES = re.compile(r"JAX|XLA|Pallas|TPU|Mosaic")


def _public(path: pathlib.Path, fields: bool = False) -> list:
    """Public top-level functions and classes of `path`, and their public
    methods as "Class.method"; with `fields`, class-body fields too."""
    out = []
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.append(node.name)
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in node.body:
            names = []
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names = [sub.name]
            elif fields and isinstance(sub, ast.AnnAssign) and isinstance(
                    sub.target, ast.Name):
                names = [sub.target.id]
            elif fields and isinstance(sub, ast.Assign):
                names = [t.id for t in sub.targets if isinstance(t, ast.Name)]
            out += [f"{node.name}.{n}" for n in names if not n.startswith("_")]
    return out


def _modules(pkg: pathlib.Path) -> list:
    return sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py"))


JAX_MODULES = _modules(JAX_PKG)
_PORT_NAMES = {}


def port_names(module: str) -> set:
    if module not in _PORT_NAMES:
        path = PORT_PKG / module
        _PORT_NAMES[module] = (set(_public(path, fields=True))
                               if path.exists() else set())
    return _PORT_NAMES[module]


def _same_named(module: str) -> set:
    """The JAX module's public names that the port's same path defines
    (functions, classes and methods only)."""
    path = PORT_PKG / module
    port = set(_public(path)) if path.exists() else set()
    return set(_public(JAX_PKG / module)) & port


def _target(module: str, value: str):
    mod, _, name = value.rpartition(":")
    return (mod or module), name


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    names = _public(JAX_PKG / module)
    same = _same_named(module)
    mapped = COUNTERPARTS.get(module, {})
    only = JAX_ONLY.get(module, {})
    missing = [n for n in names
               if n not in same and n not in mapped and n not in only]
    assert not missing, (
        f"{module}: no counterpart in src/repro_torch/{module}, no "
        f"COUNTERPARTS entry and no JAX_ONLY reason for {missing}")
    for name in names:
        cases = (name in same) + (name in mapped) + (name in only)
        assert cases == 1, f"{module}:{name} is in {cases} cases, want 1"


@pytest.mark.parametrize("table", ["COUNTERPARTS", "JAX_ONLY"])
def test_no_stale_table_entries(table):
    stale = []
    for module, entries in globals()[table].items():
        path = JAX_PKG / module
        defined = set(_public(path)) if path.exists() else set()
        same = _same_named(module) if path.exists() else set()
        for name in entries:
            if name not in defined:
                stale.append(f"{module}:{name} (the JAX package defines "
                             f"no such public name)")
            elif name in same:
                stale.append(f"{module}:{name} (the port's module defines "
                             f"it under the same name)")
    assert not stale, stale


def test_counterparts_name_what_the_port_defines():
    absent = []
    for module, entries in COUNTERPARTS.items():
        for name, value in entries.items():
            mod, target = _target(module, value)
            if target not in port_names(mod):
                absent.append(f"{module}:{name} -> {mod}:{target}")
    assert not absent, absent


def test_jax_only_reasons_name_jax_xla_pallas_or_the_tpu():
    bad = []
    for module, entries in JAX_ONLY.items():
        for name, reason in entries.items():
            if (not reason.strip() or "\n" in reason
                    or "not ported" in reason.lower()
                    or not REASON_NAMES.search(reason)):
                bad.append(f"{module}:{name}: {reason!r}")
    assert not bad, bad


def test_the_walk_sees_the_whole_jax_package():
    names = [n for m in JAX_MODULES for n in _public(JAX_PKG / m)]
    covered = sum(len(_same_named(m)) for m in JAX_MODULES)
    tables = sum(len(t) for t in COUNTERPARTS.values()) + \
        sum(len(t) for t in JAX_ONLY.values())
    assert len(names) == covered + tables
    assert any(m.startswith("kernels/") for m in JAX_MODULES)
    assert "compressed_psum" in port_names("parallel/collectives.py")

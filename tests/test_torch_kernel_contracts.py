"""The port's kernel contracts and the session's contract gate.

* `_extract_plan` reads the port's plan keys as the JAX package's reads
  its own (same knobs, batch and partitions); `GraphShape.from_graph` is
  equal for one graph built from the same numpy;
* `plan_contracts` lists one pull and one push per ELL width of the real
  tiles, with row bounds at least the real buckets' rows (unsplit and hub
  split);
* KC002: the pull plan's grid-stride tiles cover every (lane, row) once at
  B in {1, 3, 8, 16, 32} (the kernel's walk enumerated); the decode splits
  cover S; the packing kernel's words cover V, its lane groups within the
  grid; each rule fires on a plan that breaks it (KC001, KC002, KC004);
* KC005 fires on a `_build.launch` without a contract; the registry covers
  every launch site of the tree; the reference contracts are clean and the
  refusing reference plan is refused; `gate_paths` (the CLI's loader)
  over `src/repro_torch` finds nothing and over a stray launcher finds
  KC005; `reference_findings` and every `KernelCheck.warnings` are empty;
* the session gate (mirroring the JAX package's tests): warns once, then
  silent; strict refuses twice with nothing cached; the gather formulation
  is skipped; a feasible plan is silent; the sharded plan is gated on gloo
  CPU ranks;
* `REPRO_SMEM_BUDGET` / `REPRO_STRICT_CONTRACTS`;
* on the card (`cuda`-marked): the model's static shared bytes equal
  `cudaFuncGetAttributes`, registers within the launch bounds.
"""
import ast
import collections
import os
import warnings

import pytest
import torch

from repro.analysis import kernel_contracts as JKC
from repro.core import bfs as JB
from repro.core import graph as JG
from repro.core import hybrid_bfs as JH
from repro_torch.analysis import kernel_contracts as KC
from repro_torch.analysis import lint, smem
from repro_torch.core import bfs as TB
from repro_torch.core import ell as TELL
from repro_torch.core import graph as TG
from repro_torch.core import hybrid_bfs as TH
from repro_torch.engine import Engine, GraphSession
from repro_torch.kernels import contracts as C
from repro_torch.kernels import decode_attn, frontier_fused
from repro_torch.runtime import RuntimeConfig, reset_process_caches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS_DIR = os.path.join(REPO, "src", "repro_torch", "kernels")


@pytest.fixture(autouse=True)
def _fresh_registry():
    reset_process_caches()
    yield
    reset_process_caches()


@pytest.fixture(scope="module")
def graph():
    return TG.rmat(8, seed=3)


# ===========================================================================
# plan keys and graph shapes against the JAX package
# ===========================================================================

_KNOBS = [dict(), dict(td_chunk=1024, bu_chunk=64, bu_slab=16),
          dict(hub_split=True, hub_deg=2048, hub_slab=128)]


@pytest.mark.parametrize("knobs", _KNOBS, ids=["default", "chunks", "hub"])
@pytest.mark.parametrize("bucket", [1, 8, 16])
def test_extract_plan_reads_the_port_keys_like_jax(knobs, bucket):
    mine = KC._extract_plan(("cohort", TB.BFSConfig(**knobs), True, bucket,
                             "mixed"))
    ref = JKC._extract_plan(("cohort", JB.BFSConfig(**knobs), bucket,
                             "mixed"))
    assert mine == ref
    assert mine[1] == bucket


@pytest.mark.parametrize("knobs", _KNOBS, ids=["default", "chunks", "hub"])
def test_extract_plan_sharded_config_and_dict_like_jax(knobs):
    mine = KC._extract_plan(("sharded", TH.HybridConfig(
        bfs=TB.BFSConfig(**knobs)), 4, "specialized", 0.5))
    ref = JKC._extract_plan(("sharded", JH.HybridConfig(
        bfs=JB.BFSConfig(**knobs)), 4, "specialized", 0.5))
    assert mine == ref and mine[2] == 4
    assert KC._extract_plan(TB.BFSConfig(**knobs)) == \
        JKC._extract_plan(JB.BFSConfig(**knobs))
    assert KC._extract_plan(dict(knobs)) == JKC._extract_plan(dict(knobs))


def test_graph_shape_from_graph_equals_jax():
    mine = KC.GraphShape.from_graph(TG.rmat(9, seed=2))
    ref = JKC.GraphShape.from_graph(JG.rmat(9, seed=2))
    assert mine.to_json() == ref.to_json()


# ===========================================================================
# plan_contracts against the real ELL tiles
# ===========================================================================


@pytest.mark.parametrize("scale", [9, 10])
def test_plan_contracts_match_the_real_buckets(scale):
    g = TG.rmat(scale, seed=1)
    tiles = TELL.build_graph_ell(g, device="cpu")
    shape = KC.GraphShape.from_graph(g)
    cons = KC.plan_contracts(dict(KC._KNOB_DEFAULTS), shape, batch=8)
    for kernel in ("bottomup_batch", "topdown_push_batch"):
        calls = [dict(c.shape) for c in cons if c.kernel == kernel]
        assert [c["w"] for c in calls] == [t.nbrs.shape[1] for t in tiles]
        for c, t in zip(calls, tiles):
            assert c["r"] >= t.nbrs.shape[0] and c["b"] == 8
            assert c["v"] == g.num_vertices
    assert [c.kernel for c in cons].count("frontier_fused_batch") == 1


def test_plan_contracts_hub_side_matches_the_split():
    g = TG.rmat(10, seed=1)
    tiles = TELL.build_graph_ell(g, device="cpu")
    tail, hub = TELL.split_tiles(tiles, 128)
    knobs = dict(KC._KNOB_DEFAULTS, hub_split=1, hub_deg=128)
    cons = KC.plan_contracts(knobs, KC.GraphShape.from_graph(g), batch=4)
    hub_calls = [dict(c.shape) for c in cons
                 if c.kernel == "hub_bottomup_batch"]
    tail_calls = [dict(c.shape) for c in cons if c.kernel == "bottomup_batch"]
    assert [c["w"] for c in hub_calls] == [t.nbrs.shape[1] for t in hub]
    assert [c["w"] for c in tail_calls] == [t.nbrs.shape[1] for t in tail]
    for c, t in zip(hub_calls, hub):
        assert c["r"] >= t.nbrs.shape[0]


def test_sharded_plan_runs_single_lane_calls():
    shape = KC.GraphShape(2 ** 12, 2 ** 15, 300)
    cons = KC.plan_contracts(dict(KC._KNOB_DEFAULTS), shape, n_parts=4,
                             bitmap=True)
    assert {c.kernel for c in cons} == {"bottomup", "topdown_push",
                                        "frontier_fused"}
    assert all(dict(c.shape)["b"] == 1 for c in cons)
    packed = [la.instance.symbol for c in cons if c.kernel == "frontier_fused"
              for la in c.launches]
    assert packed == ["fused_kernel<1, false>", "fused_kernel<1, true>"]


# ===========================================================================
# KC002 — coverage
# ===========================================================================


def _walk_pull(plan: dict, b: int, r: int) -> collections.Counter:
    """The pull kernel's grid-stride walk (`pull_kernel` in
    csrc/bottomup.cu): every (lane, row) a block's tiles write."""
    rows, lanes, blocks = plan["rows"], plan["lanes"], plan["blocks"]
    lane_tiles = -(-b // lanes)
    tiles = -(-r // rows) * lane_tiles
    seen = collections.Counter()
    for blk in range(blocks):
        for tile in range(blk, tiles, blocks):
            row0, l0 = tile // lane_tiles * rows, tile % lane_tiles * lanes
            for tid in range(rows):
                if row0 + tid < r:
                    for j in range(lanes):
                        if l0 + j < b:
                            seen[(l0 + j, row0 + tid)] += 1
    return seen


@pytest.mark.parametrize("b", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("r,sms,resident", [(1, 132, 4), (37, 132, 3),
                                            (300, 4, 3), (2000, 132, 3),
                                            (1_000_000, 132, 3)])
def test_kc002_pull_tiles_cover_every_lane_row_once(b, r, sms, resident):
    con = C.pull_contract(b, r, 32, 1 << 20, sms=sms, resident=resident)
    check = KC.check_contract(con)
    assert check.feasible, check.findings
    if b * r <= 64_000:
        seen = _walk_pull(dict(con.plan), b, r)
        assert len(seen) == b * r and set(seen.values()) == {1}


@pytest.mark.parametrize("s", [1, 31, 33, 4232, 32768])
def test_kc002_decode_splits_cover_s(s):
    for (b, kk, g, h) in ((4, 8, 2, 256), (4, 4, 8, 128), (4, 32, 1, 80)):
        con = C.decode_contract(b, s, kk, g, h, resident=2)
        assert KC.check_contract(con).feasible
        plan = dict(con.plan)
        assert plan["nsplit"] * plan["split_len"] >= s
        assert (plan["nsplit"] - 1) * plan["split_len"] < s


@pytest.mark.parametrize("b,v", [(1, 1), (3, 33), (8, 65536), (40, 4_194_303)])
def test_kc002_packing_words_cover_v(b, v):
    con = C.fused_contract(b, v, resident=8)
    assert KC.check_contract(con).feasible
    cov = {c.what: c for c in con.coverage}
    assert cov["words"].step * cov["words"].steps * 32 >= v


def test_kc002_fires_on_broken_plans():
    lanes = frontier_fused.lane_block(9)
    too_many = C.fused_contract(lanes * (frontier_fused.MAX_GROUPS + 1), 64)
    msgs = [f.message for f in KC.check_contract(too_many).errors]
    assert any("lane groups" in m for m in msgs)
    assert any("grid y" in m for m in msgs)
    hole = C.KernelContract(
        kernel="fixture", module="fixture",
        launches=(C.Launch(C.push_instance(1), (1, 1, 1)),),
        coverage=(C.Coverage("rows", 100, 8, 12),
                  C.Coverage("lanes", 8, 8, 2)))
    errs = KC.check_contract(hole).errors
    assert [f.rule for f in errs] == ["KC002", "KC002"]
    assert "never touched" in errs[0].message or \
        "never touched" in errs[1].message


def test_kc001_and_kc004_fire():
    under = KC.check_contract(C.pull_contract(8, 4096, 32, 65536),
                              budget_bytes=1024)
    assert not under.feasible and {f.rule for f in under.errors} == {"KC001"}
    wide = smem.KernelInstance("fixture", "fixture", (), threads=2048)
    assert "threads" in smem.smem_report(wide).problems[0]
    for clip in (None, (0, 65536)):
        con = C.KernelContract(
            kernel="fixture", module="fixture",
            launches=(C.Launch(C.push_instance(1), (1, 1, 1)),),
            gathers=(C.GatherSpec("nbrs", "visited", (0, 65536), clip,
                                  65536),))
        assert [f.rule for f in KC.check_contract(con).errors] == ["KC004"]


def test_model_numbers():
    # the sources' declarations and launch bounds, by hand
    # (what cudaFuncGetAttributes reported on the H100: the compiler drops
    # the one-lane pull's and packing kernel's unused arrays, and pads the
    # decode kernel's static int to its dynamic array's 16-byte alignment)
    assert C.pull_instance(1).static_bytes == 1036
    assert C.pull_instance(8).static_bytes == 18444
    assert C.pull_instance(16).static_bytes == 36876
    assert C.pull_instance(1).register_cap == 64
    assert C.pull_instance(8).register_cap == 80
    assert C.push_instance(16).static_bytes == 16384
    assert C.fused_instance(8, True).static_bytes == 2560
    assert C.fused_instance(1, False).static_bytes == 64
    assert C.decode_instance("bfloat16", 2, 256, 8).static_bytes == 16
    for (dtype, g, h), dyn in {("float32", 2, 256): 137504,
                               ("float32", 8, 128): 80992,
                               ("float32", 3, 20): 13984,
                               ("bfloat16", 8, 128): 78944,
                               ("bfloat16", 1, 80): 35280,
                               ("bfloat16", 16, 256): 166080,
                               ("bfloat16", 1, 8): 4272}.items():
        assert decode_attn.shared_layout(dtype, g, h, 64) == dyn
    assert decode_attn.shared_layout("bfloat16", 2, 256, 8) == 105760
    assert smem.register_cap(256) == smem.MAX_REGISTERS_PER_THREAD


# ===========================================================================
# KC005, the registry, the reference contracts and plans
# ===========================================================================


def test_kc005_fires_on_a_launch_without_contract():
    sources = {"src/repro_torch/kernels/newk.py": (
        "from repro_torch.kernels import _build\n\n"
        "def newk_cuda(x):\n"
        "    _build.launch('newk', x.data_ptr(), device=0, stream=0)\n")}
    found = KC.registry_gate(sources)
    assert [(f.rule, f.line) for f in found] == [("KC005", 4)]
    assert "newk.newk_cuda" in found[0].message


def test_registry_covers_every_launch_site():
    sites = set()
    for name in sorted(os.listdir(KERNELS_DIR)):
        if name.endswith(".py"):
            with open(os.path.join(KERNELS_DIR, name)) as fh:
                tree = ast.parse(fh.read())
            sites |= {f"{name[:-3]}.{owner}"
                      for owner, _ in KC._launch_sites(tree)}
    assert sites == set(C.registered_kernels())


def test_reference_contracts_and_plans():
    sources = {}
    for name in os.listdir(KERNELS_DIR):
        if name.endswith(".py"):
            with open(os.path.join(KERNELS_DIR, name)) as fh:
                sources[f"src/repro_torch/kernels/{name}"] = fh.read()
    assert KC.run_gate(sources) == ([], [])
    reports = KC.default_plan_reports()
    assert set(reports) == {p[0] for p in KC.DEFAULT_PLANS}
    assert set(reports) >= set(p[0] for p in JKC.DEFAULT_PLANS)
    for name, _knobs, _shape, _extra, feasible in KC.DEFAULT_PLANS:
        assert reports[name]["feasible"] is feasible, name
    # the JAX package's infeasible plan fits the card; the port's refusing
    # plan is refused by KC001
    assert reports["scale22-single-device"]["feasible"]
    refused = reports["scale16-under-budget"]
    assert {f["rule"] for c in refused["checks"] for f in c["findings"]} \
        == {"KC001"}


def test_gate_paths_over_the_port_is_clean():
    assert KC.gate_paths([os.path.join(REPO, "src", "repro_torch")],
                         root=REPO) == ([], [])
    # the same loader as the CLI's: repo-relative paths, so KC005 scopes
    sources = lint.load_sources([KERNELS_DIR], REPO)
    assert sorted(sources) == sorted(
        f"src/repro_torch/kernels/{n}" for n in os.listdir(KERNELS_DIR)
        if n.endswith(".py"))


def test_gate_paths_fires_on_a_launch_without_contract(tmp_path):
    kernels = tmp_path / "src" / "repro_torch" / "kernels"
    kernels.mkdir(parents=True)
    (kernels / "newk.py").write_text(
        "from repro_torch.kernels import _build\n\n"
        "def newk_cuda(x):\n"
        "    _build.launch('newk', x.data_ptr(), device=0, stream=0)\n")
    errors, warns = KC.gate_paths([str(tmp_path / "src")], root=str(tmp_path))
    assert [(f.rule, f.path, f.line) for f in errors] == \
        [("KC005", "src/repro_torch/kernels/newk.py", 4)]
    assert warns == []


def test_reference_findings_and_warnings_are_empty():
    assert KC.reference_findings() == []
    for name in C.registered_kernels():
        check = KC.check_contract(C.REGISTRY[name].reference_contract())
        assert check.warnings == () and check.errors == ()
    # a failing check's findings are errors, never warnings
    bad = KC.check_contract(C.pull_contract(8, 4096, 32, 65536),
                            budget_bytes=1024)
    assert bad.errors and bad.warnings == ()
    # the JAX package's reference findings are its TPU tiling lints only
    assert {f.rule for f in JKC.reference_findings()} <= {"KC003"}


def test_typed_errors():
    assert issubclass(C.KernelContractError, ValueError)
    assert issubclass(C.GridCoverageError, C.KernelContractError)
    assert issubclass(C.KernelBudgetError, C.KernelContractError)
    assert issubclass(C.KernelContractWarning, UserWarning)
    with pytest.raises(C.GridCoverageError, match="lane groups"):
        C.require_grid("frontier_fused", "lane groups", 65536, 65535,
                       hint="split")
    q = torch.zeros((1, 1, 1, 8), dtype=torch.float16)
    with pytest.raises(C.KernelContractError, match="takes"):
        decode_attn.decode_attention_cuda(q, q, q,
                                          torch.zeros(1, dtype=torch.int32))


# ===========================================================================
# the session gate
# ===========================================================================


def _session(graph, **runtime):
    rt = RuntimeConfig.resolve({}, prewarm=False, **runtime)
    return GraphSession(graph, device="cpu", runtime=rt)


def _build():
    return lambda state: state


KEY = ("cohort", TB.BFSConfig(), True, 8, "td")


def test_session_gate_warns_on_infeasible_plan(graph):
    s = _session(graph, smem_budget_bytes=4096)
    with pytest.warns(C.KernelContractWarning, match="KC001"):
        s.executable(KEY, _build)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.executable(KEY, _build)               # memoized: no second warning
    other = ("cohort", TB.BFSConfig(), True, 8, "bu")
    with pytest.warns(C.KernelContractWarning):  # a new key warns again
        s.executable(other, _build)


def test_session_gate_strict_refuses_and_refuses_again(graph):
    s = _session(graph, smem_budget_bytes=4096, strict_contracts=True)
    for _ in range(2):
        with pytest.raises(C.KernelBudgetError, match="KC001"):
            s.executable(KEY, _build)
    assert KEY not in s._executables and KEY not in s._contract_checked
    assert s.total_builds == 0 and s.runtime_stats()["builds"] == {}


def test_session_gate_skips_the_gather_formulation(graph):
    s = _session(graph, smem_budget_bytes=4096, strict_contracts=True)
    key = ("cohort", TB.BFSConfig(backend_kernels=False), False, 8, "td")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.executable(key, _build)
    assert key not in s._contract_checked


def test_session_gate_feasible_plan_is_silent(graph):
    s = _session(graph, strict_contracts=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.executable(KEY, _build)
    assert KEY in s._contract_checked


def test_engine_gates_its_cohort_plans(graph):
    tight = Engine(graph, device="cpu", runtime=RuntimeConfig(
        strict_contracts=True, smem_budget_bytes=4096))
    with pytest.raises(C.KernelBudgetError):
        tight.bfs([0, 5, 9])
    assert tight.session.total_builds == 0
    # the gather formulation builds no kernel: nothing to gate
    res = tight.bfs([0, 5, 9], TB.BFSConfig(backend_kernels=False),
                    validate=True)
    assert res.parent.shape == (3, graph.num_vertices)
    ok = Engine(graph, device="cpu",
                runtime=RuntimeConfig(strict_contracts=True))
    ok.bfs([0, 5, 9], validate=True)
    assert {k[0] for k in ok.session._contract_checked} == {"cohort"}


def sharded_gate_rank(rank, group, device):
    """One rank: a strict session under a 1 KiB budget refuses the sharded
    search twice, before it builds anything; a strict session at the
    default budget gates the plan and searches."""
    from repro_torch.kernels.contracts import KernelBudgetError
    g = TG.rmat(8, seed=3)
    tight = Engine(g, device=device, runtime=RuntimeConfig(
        strict_contracts=True, smem_budget_bytes=1024))
    refused = 0
    for _ in range(2):
        try:
            tight.bfs(0, backend="sharded", n_parts=2)
        except KernelBudgetError:
            refused += 1
    ok = Engine(g, device=device, runtime=RuntimeConfig(strict_contracts=True))
    res = ok.bfs([0, 5], backend="sharded", n_parts=2, validate=True)
    return (refused, tight.session.runtime_stats()["builds"],
            sorted(k[0] for k in ok.session._contract_checked),
            res.parent.shape)


def test_session_gate_covers_the_sharded_plan_on_gloo_ranks(tmp_path):
    from repro_torch.parallel import ranks
    out = ranks.run_ranks(sharded_gate_rank, 2, str(tmp_path), device="cpu",
                          timeout=240)
    for refused, builds, gated, shape in out:
        assert refused == 2 and builds == {}
        assert gated == ["sharded"] and shape == (2, 256)


# ===========================================================================
# RuntimeConfig
# ===========================================================================


def test_runtime_config_smem_env():
    env = {"REPRO_SMEM_BUDGET": "100KB", "REPRO_STRICT_CONTRACTS": "1"}
    cfg = RuntimeConfig.resolve(env)
    assert cfg.smem_budget_bytes == 100 * 1024 and cfg.strict_contracts
    assert RuntimeConfig.resolve(env, smem_budget_bytes=123) \
        .smem_budget_bytes == 123
    assert RuntimeConfig.resolve(env, strict_contracts=False) \
        .strict_contracts is False


def test_runtime_config_smem_defaults_and_refusals():
    cfg = RuntimeConfig.resolve({})
    assert cfg.smem_budget_bytes == smem.DEFAULT_SMEM_BUDGET == 232_448
    assert cfg.strict_contracts is False
    for bad in (0, -1):
        with pytest.raises(ValueError, match="smem_budget_bytes"):
            RuntimeConfig.resolve({}, smem_budget_bytes=bad)
    with pytest.raises(ValueError):
        RuntimeConfig.resolve({"REPRO_SMEM_BUDGET": "0"})
    with pytest.raises(ValueError, match="REPRO_STRICT_CONTRACTS"):
        RuntimeConfig.resolve({"REPRO_STRICT_CONTRACTS": "maybe"})


# ===========================================================================
# on the card
# ===========================================================================


@pytest.mark.cuda
def test_model_matches_the_compiler_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    import ctypes
    from repro_torch.kernels import _build
    dev = torch.device("cuda", 0)
    _build.build_all()
    insts = ([C.pull_instance(lb) for lb in (1, 8, 16)]
             + [C.pack_instance(lb) for lb in (8, 16)]
             + [C.push_instance(lb) for lb in (1, 8, 16)]
             + [C.fresh_instance()]
             + [C.fused_instance(lb, p) for lb in (1, 2, 4, 8)
                for p in (False, True)]
             + [C.decode_instance(dt, g, h, n) for dt in ("float32",
                                                           "bfloat16")
                for g, h, n in ((2, 256, 8), (8, 128, 4), (1, 80, 64))])
    for inst in insts:
        out = (ctypes.c_int * 6)()
        err = _build.function(f"{inst.library}_attributes", 0)(
            *inst.selectors, ctypes.addressof(out), dev.index)
        assert err == 0, inst
        shared, regs, _local, max_threads, _max_dyn, dynamic = out
        assert shared == inst.static_bytes, (inst.symbol, shared)
        assert dynamic == inst.dynamic_bytes, (inst.symbol, dynamic)
        assert regs <= inst.register_cap, (inst.symbol, regs)
        assert inst.threads <= max_threads, (inst.symbol, max_threads)

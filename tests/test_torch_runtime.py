"""The port's runtime layer against the JAX package's, on the CPU.

Each test mirrors one of `tests/test_runtime.py`:

* `RuntimeConfig`: the cache fields resolve alike (explicit > env >
  default) and refuse alike; parsing reads no device; `replace` as the
  JAX one; `launch_env` is the JAX package's environment without the keys
  only XLA reads (`LD_PRELOAD` only when the library exists);
* fingerprints: `graph_fingerprint` gives the JAX function's hex digest
  for the same graph; plan and kernel fingerprints move with each input;
* the artifact cache: one sequence of stores, loads, a truncated record,
  a garbage entry and an LRU cap gives the JAX cache's counters; a
  truncated plan record and a garbage or symbol-less kernel library are
  evicted and rebuilt (the library by a stand-in `nvcc` that compiles a
  small C file with `gcc`); no cache without a dir;
* sharing: a second session over a rebuilt identical graph materializes
  no plan (the JAX package's second session neither), one with
  `share_plans=False` builds its own; more sessions than cores on their
  own threads build each plan and the tiles once; `registry_stats`
  counts the second session's hits;
* pre-warm: progress, the limit, a stop and join, a pass that dies;
* restart: two child processes on one cache dir (`bfs_serve
  .run_restart_probe`): the warm child builds no cohort plan on its
  query path, pre-warms the whole set, and its trees equal the cold
  child's and the JAX reference's; the launchers' `--cache-dir` and
  `--restart-probe`.

The port's cohort plan set is the three step variants ("td", "bu",
"mixed"), keyed ("cohort", cfg, use_kernels, bucket, variant); its init
and sync payload are plain functions, not plans (the reference has five
executables: init, the three steps, the scalars).
"""
import os
import pickle
import shutil
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core.bfs import BFSConfig as JBFSConfig
from repro.engine import Engine as JEngine
from repro.engine import GraphSession as JSession
from repro.runtime import artifact_cache as JAC
from repro.runtime import config as JCFG
from repro.runtime import fingerprint as JFP
from repro.runtime import registry_reset as jax_registry_reset
from repro.runtime import runtime_scope as jax_runtime_scope
from repro_torch.core import graph as TG
from repro_torch.core.bfs import BFSConfig
from repro_torch.engine import BFSServer, Engine, GraphSession
from repro_torch.kernels import _build
from repro_torch.runtime import (RuntimeConfig, artifact_cache_for,
                                 registry_size, registry_stats,
                                 reset_process_caches,
                                 runtime_scope)
from repro_torch.runtime import artifact_cache as TAC
from repro_torch.runtime import config as TCFG
from repro_torch.runtime import fingerprint as TFP

COHORT_PLANS = 3           # td, bu, mixed
JAX_COHORT_EXECUTABLES = 5
ROOTS = np.arange(8)


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    reset_process_caches()
    yield
    reset_process_caches()


# --------------------------------------------------------- RuntimeConfig --

CACHE_FIELDS = ("cache_dir", "cache_max_bytes", "prewarm", "prewarm_limit",
                "share_plans")
ENVS = [
    {},
    {"REPRO_CACHE_DIR": "/env/dir", "REPRO_PREWARM": "0",
     "REPRO_CACHE_MAX_BYTES": "2MB"},
    {"REPRO_CACHE_DIR": "", "REPRO_PREWARM_LIMIT": "7",
     "REPRO_SHARE_PLANS": "no"},
    {"REPRO_CACHE_MAX_BYTES": "1.5 KB", "REPRO_SHARE_PLANS": "1",
     "REPRO_PREWARM": "yes"},
]
EXPLICIT = [{}, {"cache_dir": "/arg/dir", "prewarm": True},
            {"cache_dir": None, "cache_max_bytes": 4096},
            {"cache_dir": "", "share_plans": False, "prewarm_limit": 0}]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("explicit", EXPLICIT)
def test_config_cache_fields_resolve_like_jax(env, explicit):
    mine = TCFG.RuntimeConfig.resolve(env, **explicit)
    ref = JCFG.RuntimeConfig.resolve(env, **explicit)
    assert [getattr(mine, f) for f in CACHE_FIELDS] == \
        [getattr(ref, f) for f in CACHE_FIELDS]
    assert mine.cache_enabled == ref.cache_enabled


def test_config_precedence_explicit_over_env_over_default(tmp_path):
    env = {"REPRO_CACHE_DIR": "/env/dir", "REPRO_PREWARM": "0",
           "REPRO_CACHE_MAX_BYTES": "2MB"}
    cfg = RuntimeConfig.resolve(env)
    assert (cfg.cache_dir, cfg.prewarm, cfg.cache_max_bytes) == \
        ("/env/dir", False, 2 << 20)
    assert cfg.share_plans is True and cfg.prewarm_limit == 64
    assert RuntimeConfig().cache_max_bytes == 1 << 30
    cfg = RuntimeConfig.resolve(env, cache_dir=str(tmp_path), prewarm=True)
    assert (cfg.cache_dir, cfg.prewarm, cfg.cache_max_bytes) == \
        (str(tmp_path), True, 2 << 20)
    assert RuntimeConfig.resolve(env, cache_dir=None).cache_dir == "/env/dir"
    assert RuntimeConfig.resolve(env, cache_dir="").cache_dir is None


XLA_ONLY_KEYS = {"TF_CPP_MIN_LOG_LEVEL", "XLA_FLAGS"}


def test_launch_env_shape(tmp_path):
    env = RuntimeConfig(cache_dir="/tmp/c").launch_env()
    assert env["REPRO_CACHE_DIR"] == "/tmp/c"
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    assert not XLA_ONLY_KEYS & set(env)
    # LD_PRELOAD only when the library exists on this machine
    missing = RuntimeConfig(tcmalloc_path="/no/such/lib.so").launch_env()
    assert "LD_PRELOAD" not in missing and "REPRO_CACHE_DIR" not in missing
    lib = tmp_path / "libtcmalloc.so.4"
    lib.write_bytes(b"")
    assert RuntimeConfig(tcmalloc_path=str(lib)).launch_env()[
        "LD_PRELOAD"] == str(lib)
    assert RuntimeConfig().tcmalloc_path == JCFG.DEFAULT_TCMALLOC


@pytest.mark.parametrize("explicit", [
    {}, {"cache_dir": "/arg/dir"}, {"cache_dir": ""},
    {"tcmalloc_path": "/no/such/lib.so", "cache_dir": "/c"}])
def test_launch_env_is_the_jax_env_without_the_xla_keys(monkeypatch,
                                                        explicit):
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    want = JCFG.launch_env(**explicit)
    got = TCFG.launch_env(**explicit)
    assert got == {k: v for k, v in want.items() if k not in XLA_ONLY_KEYS}
    assert got == RuntimeConfig.resolve(**explicit).launch_env()


def test_replace_like_jax():
    base = RuntimeConfig.resolve({}, cache_dir="/c")
    new = base.replace(prewarm=False, cache_max_bytes=4096)
    assert (new.cache_dir, new.prewarm, new.cache_max_bytes) == \
        ("/c", False, 4096)
    assert base.prewarm is True          # frozen: the original stays
    ref = JCFG.RuntimeConfig.resolve({}, cache_dir="/c").replace(
        prewarm=False, cache_max_bytes=4096)
    assert [getattr(new, f) for f in CACHE_FIELDS] == \
        [getattr(ref, f) for f in CACHE_FIELDS]
    with pytest.raises(ValueError, match="cache_max_bytes"):
        base.replace(cache_max_bytes=0)


@pytest.mark.parametrize("text", ["1048576", "512MB", "2gb", "1.5 KB", "3K",
                                  "7B", "lots", "MB"])
def test_parse_size_like_jax(text):
    try:
        want = JCFG._parse_size(text, name="x")
    except ValueError as e:
        with pytest.raises(ValueError, match="cannot parse size") as mine:
            TCFG._parse_size(text, name="x")
        assert str(mine.value) == str(e)
        return
    assert TCFG._parse_size(text, name="x") == want


@pytest.mark.parametrize("env,explicit", [
    ({"REPRO_PREWARM": "sometimes"}, {}), ({"REPRO_SHARE_PLANS": "2"}, {}),
    ({"REPRO_CACHE_MAX_BYTES": "lots"}, {}),
    ({"REPRO_PREWARM_LIMIT": "x"}, {}), ({}, {"cache_max_bytes": 0}),
    ({}, {"prewarm_limit": -1})])
def test_config_rejects_like_jax(env, explicit):
    with pytest.raises(ValueError) as mine:
        TCFG.RuntimeConfig.resolve(env, **explicit)
    with pytest.raises(ValueError) as ref:
        JCFG.RuntimeConfig.resolve(env, **explicit)
    assert str(mine.value) == str(ref.value)


def test_config_and_cpu_fingerprints_read_no_device(monkeypatch, tmp_path):
    """Parsing a config, hashing a graph and the CPU environment never ask
    CUDA anything (the JAX package reads its backend lazily too)."""
    def refuse(*a, **k):
        raise AssertionError("CUDA touched")
    for name in ("is_available", "get_device_name", "get_device_capability",
                 "device_count", "init"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    cfg = RuntimeConfig.resolve({"REPRO_CACHE_DIR": str(tmp_path)})
    assert artifact_cache_for(cfg) is not None
    env = TFP.environment_fingerprint("cpu")
    assert env["backend"] == "cpu" and env["device_kind"] == "cpu"
    assert env["torch_version"] == torch.__version__
    TFP.graph_fingerprint(TG.rmat(6, seed=0))


# ---------------------------------------------------------- fingerprints --

GRAPH_CASES = [("rmat", 8, 5), ("rmat", 8, 6), ("rmat", 9, 7), ("path", 40, 0)]


def _both(kind, n, seed):
    if kind == "rmat":
        return TG.rmat(n, seed=seed), JG.rmat(n, seed=seed)
    src, dst = np.arange(n - 1), np.arange(1, n)
    return TG.from_edges(src, dst, n), JG.from_edges(src, dst, n)


@pytest.mark.parametrize("case", GRAPH_CASES, ids=lambda c: f"{c[0]}{c[1]}-{c[2]}")
def test_graph_fingerprint_is_the_jax_digest(case):
    tg, jg = _both(*case)
    assert TFP.graph_fingerprint(tg) == JFP.graph_fingerprint(jg)
    # content, not identity: a rebuilt graph hashes equal, memo stable
    again, _ = _both(*case)
    assert TFP.graph_fingerprint(again) == TFP.graph_fingerprint(tg)
    assert TFP.graph_fingerprint(tg) == TFP.graph_fingerprint(tg)


def test_graph_fingerprint_content_not_identity():
    a, b, c = TG.rmat(8, seed=5), TG.rmat(8, seed=5), TG.rmat(8, seed=6)
    assert TFP.graph_fingerprint(a) == TFP.graph_fingerprint(b)
    assert TFP.graph_fingerprint(a) != TFP.graph_fingerprint(c)


def test_plan_fingerprint_sensitivity():
    env = TFP.environment_fingerprint("cpu")
    key = ("cohort", BFSConfig(), True, 8, "td")
    base = TFP.plan_fingerprint("abc123", key, env)
    assert base == TFP.plan_fingerprint("abc123", key, dict(env))
    for other in (("cohort", BFSConfig(), True, 16, "td"),
                  ("cohort", BFSConfig(heuristic="beamer"), True, 8, "td"),
                  ("cohort", BFSConfig(), False, 8, "td"),
                  ("cohort", BFSConfig(), True, 8, "bu")):
        assert base != TFP.plan_fingerprint("abc123", other, env)
    assert base != TFP.plan_fingerprint("other", key, env)
    for field, value in (("torch_version", "0.0"), ("backend", "cuda"),
                         ("device_kind", "NVIDIA H100 80GB HBM3"),
                         ("capability", "9.0"), ("n_devices", 4)):
        assert base != TFP.plan_fingerprint("abc123", key,
                                            dict(env, **{field: value}))


def test_kernel_fingerprint_names_the_card_it_is_built_for(monkeypatch):
    """The capability is read from the device the library is built for,
    not card 0; a CPU device reads "none", as no CUDA does."""
    seen = []

    def capability(device=None):
        seen.append(device)
        return {"cuda:1": "8.0"}.get(str(device), "9.0")
    monkeypatch.setattr(TFP, "toolkit_version", lambda: "nvcc 12.8")
    monkeypatch.setattr(TFP, "device_capability", capability)
    assert TFP.kernel_fingerprint("bottomup", "cuda:1") != \
        TFP.kernel_fingerprint("bottomup", "cuda:0")
    assert seen == ["cuda:1", "cuda:0"]
    monkeypatch.undo()
    assert TFP.device_capability("cpu") == "none"
    assert TFP.device_capability(torch.device("cpu")) == "none"


def test_kernel_fingerprint_sensitivity(monkeypatch):
    monkeypatch.setattr(TFP, "toolkit_version", lambda: "nvcc 12.8")
    monkeypatch.setattr(TFP, "device_capability",
                        lambda device=None: "9.0")
    names = {TFP.kernel_fingerprint(n) for n in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    base = TFP.kernel_fingerprint("bottomup")
    assert base.startswith("bottomup-")
    assert base == TFP.kernel_fingerprint("bottomup")
    monkeypatch.setattr(TFP, "toolkit_version", lambda: "nvcc 12.9")
    assert TFP.kernel_fingerprint("bottomup") != base
    monkeypatch.setattr(TFP, "toolkit_version", lambda: "nvcc 12.8")
    monkeypatch.setattr(TFP, "device_capability",
                        lambda device=None: "8.0")
    assert TFP.kernel_fingerprint("bottomup") != base
    monkeypatch.setattr(TFP, "device_capability",
                        lambda device=None: "9.0")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert TFP.kernel_fingerprint("bottomup") != base


# --------------------------------------------------------- artifact cache --

def _jax_compiled():
    import jax
    import jax.numpy as jnp
    return jax.jit(lambda x: x + 1).lower(jnp.ones(4)).compile()


COUNTERS = ("hits", "misses", "stores", "store_errors", "evictions",
            "corrupt_evictions", "entries")


def test_cache_counters_match_jax_under_one_sequence(tmp_path):
    """Stores, a hit, a miss, a truncated record, a garbage entry found by
    a scan and an LRU cap: the same counters in both packages."""
    compiled = _jax_compiled()
    caches = {"jax": (JAC.ArtifactCache(str(tmp_path / "j"), 1 << 30),
                      lambda c, fp: c.store(fp, compiled, {"fp": fp})),
              "port": (TAC.ArtifactCache(str(tmp_path / "t"), 1 << 30),
                       lambda c, fp: c.store(fp, ("cohort", fp), {"fp": fp}))}
    stats = {}
    for name, (c, store) in caches.items():
        for i, fp in enumerate(["aa", "bb", "cc", "dd"]):
            assert store(c, fp)
            os.utime(c._path(fp), (1e6 + i, 1e6 + i))
        assert c.load("aa") is not None              # hit; aa is now newest
        assert c.load("zz") is None                  # miss
        path = c._path("bb")
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        assert c.load("bb") is None                  # corrupt: evicted
        assert "bb" not in c
        with open(c._path("ee"), "wb") as f:
            f.write(b"\x00not a pickle at all")
        assert sorted(fp for fp, _ in c.scan()) == ["aa", "cc", "dd"]
        c.max_bytes = c.total_bytes() - 1
        c._evict_over_cap()                          # the LRU: cc
        assert "cc" not in c and "aa" in c and "dd" in c
        st = c.stats()
        stats[name] = {k: st[k] for k in COUNTERS}
        assert st["hit_rate"] == pytest.approx(1 / 3)
    assert stats["port"] == stats["jax"]
    assert stats["port"] == dict(hits=1, misses=2, stores=4, store_errors=0,
                                 evictions=3, corrupt_evictions=2, entries=2)


def _populated_session(graph, cache_dir):
    """One fused batch with the cache at `cache_dir` (no pre-warm)."""
    with runtime_scope(cache_dir=str(cache_dir), prewarm=False):
        s = GraphSession(graph, "cpu")
        Engine(s).bfs(ROOTS, BFSConfig(), backend="fused")
    return s


def test_store_load_roundtrip_and_counters(tmp_path):
    g = TG.rmat(9, seed=7)
    s = _populated_session(g, tmp_path)
    assert s.total_builds == COHORT_PLANS and s.total_loads == 0
    cache = s._artifacts
    st = cache.stats()
    assert st["stores"] == st["entries"] == st["plan_entries"] \
        == COHORT_PLANS
    assert st["bytes"] > 0
    keys = set()
    for fp, meta in cache.scan():
        assert meta["graph_hash"] == s.graph_fingerprint
        assert meta["backend"] == "cpu"
        key = cache.load(fp)
        assert key[:4] == ("cohort", BFSConfig(), True, 8)
        assert meta["key"] == repr(key)
        keys.add(key[4])
    assert keys == {"td", "bu", "mixed"}
    assert cache.stats()["hits"] == COHORT_PLANS


def test_corrupt_plan_record_evicted_and_rebuilt(tmp_path):
    """Truncating every plan record breaks nothing: pre-warm's loads fail,
    the records are evicted, the plans are built on the query path (as
    the JAX package retraces) and their records published again."""
    g = TG.rmat(9, seed=7)
    s = _populated_session(g, tmp_path)
    base = Engine(s).bfs(ROOTS, backend="fused")
    entries = sorted(os.listdir(s._artifacts.plans_dir))
    assert len(entries) == COHORT_PLANS
    for name in entries:
        path = os.path.join(s._artifacts.plans_dir, name)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    reset_process_caches()
    with runtime_scope(cache_dir=str(tmp_path)):
        s2 = GraphSession(TG.rmat(9, seed=7), "cpu")
        res = Engine(s2).bfs(ROOTS, BFSConfig(), backend="fused")
        prewarm = s2.prewarm_wait(60)
    assert prewarm["loaded"] == 0 and prewarm["error"] is None
    assert s2.total_builds == COHORT_PLANS and s2.total_loads == 0
    assert s2._artifacts.stats()["corrupt_evictions"] >= COHORT_PLANS
    assert len(s2._artifacts) == COHORT_PLANS        # published again
    assert np.array_equal(res.parent, base.parent)
    assert np.array_equal(res.level, base.level)


def test_unpicklable_garbage_entry_is_not_fatal(tmp_path):
    cache = TAC.ArtifactCache(str(tmp_path), max_bytes=1 << 20)
    with open(cache._path("deadbeef"), "wb") as f:
        f.write(b"\x00not a pickle at all")
    assert cache.load("deadbeef") is None
    assert "deadbeef" not in cache
    assert cache.scan() == []
    st = cache.stats()
    assert st["corrupt_evictions"] >= 1 and st["misses"] >= 1


def test_lru_cap_evicts_oldest_first(tmp_path):
    """Entries of both kinds are evicted in least-recently-used order
    (loads refresh)."""
    cache = TAC.ArtifactCache(str(tmp_path), max_bytes=1 << 20)

    def put(path, mtime):
        with open(path, "wb") as f:
            pickle.dump({"fp": os.path.basename(path)}, f)
            pickle.dump(b"x" * 300, f)
        os.utime(path, (mtime, mtime))

    put(cache._path("old"), 1_000_000)
    put(cache.library_path("mid"), 1_000_001)
    put(cache._path("new"), 1_000_002)
    total = cache.total_bytes()
    each = total // 3
    cache.max_bytes = total - 1
    cache._evict_over_cap()
    assert "old" not in cache and "new" in cache
    assert os.path.exists(cache.library_path("mid"))
    os.utime(cache.library_path("mid"))              # a load's touch
    cache.max_bytes = each
    cache._evict_over_cap()
    assert os.path.exists(cache.library_path("mid")) and "new" not in cache
    assert cache.stats()["evictions"] == 2


def test_artifact_cache_disabled_without_dir():
    with runtime_scope(cache_dir=None):
        assert artifact_cache_for() is None
        s = GraphSession(TG.rmat(7, seed=1), "cpu")
        assert s._artifacts is None and s.prewarm_progress is None
        assert s.prewarm_wait()["done"]
        assert "artifact_cache" not in s.runtime_stats()


# ------------------------------------------- kernel libraries in the cache --

ENTRY_SYMBOLS = sorted({sym for sym, _ in _build.ENTRY_POINTS.values()})


@pytest.fixture
def stand_in_nvcc(monkeypatch, tmp_path):
    """An `nvcc` that answers `--version` and builds, for any source, a
    real shared library (a small C file through `gcc`) holding every
    entry point and `stand_in_generation()`, the count of builds started
    so far;
    `_build`'s process state is private to the test."""
    calls = tmp_path / "calls.log"
    symbols = " ".join(f"int {s}(void){{return 0;}}" for s in ENTRY_SYMBOLS)
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        if [ "$1" = --version ]; then echo "stand-in nvcc 1.0"; exit 0; fi
        out=""; src=""
        while [ $# -gt 0 ]; do
          case "$1" in -o) out="$2"; shift 2;; *) src="$1"; shift;; esac
        done
        echo "$src" >> {calls}
        gen=$(wc -l < {calls})
        echo "{symbols} int stand_in_generation(void){{return $gen;}}" \\
            > "$out.c"
        gcc -shared -fPIC -o "$out" "$out.c" && rm -f "$out.c"
        """))
    fake.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "STATS", dict(
        compiles=0, compile_s=0.0, cache_loads=0, cache_load_s=0.0,
        sources={}))
    TFP.reset_fingerprint_memos()
    return calls


def _unload():
    """A restart's view of `_build`: no library loaded (they stay mapped)."""
    _build._libraries.clear()
    _build._functions.clear()
    _build.STATS["sources"].clear()


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_kernel_libraries_cached_corrupt_rebuilt(stand_in_nvcc, tmp_path):
    cache = TAC.ArtifactCache(str(tmp_path / "cache"), 1 << 30)
    # cold: every source compiles once, in parallel, into the cache
    _build.build_all(cache=cache)
    assert _build.STATS["compiles"] == len(_build.SOURCES)
    assert set(_build.STATS["sources"].values()) == {"compiled"}
    st = cache.stats()
    assert (st["misses"], st["stores"], st["entries"]) == \
        (len(_build.SOURCES),) * 3
    # a restart: every library loads from the cache, no compile
    _unload()
    _build.build_all(cache=cache)
    assert _build.STATS["compiles"] == len(_build.SOURCES)
    assert _build.STATS["cache_loads"] == len(_build.SOURCES)
    assert cache.stats()["hits"] == len(_build.SOURCES)
    assert _build.function("topdown_push") is not None
    # garbage replaces bottomup's entry; a symbol-less library topdown's
    fps = {n: TFP.kernel_fingerprint(n) for n in _build.SOURCES}
    garbage = tmp_path / "garbage"
    garbage.write_bytes(b"\x7fELF not a library")
    os.replace(garbage, cache.library_path(fps["bottomup"]))
    other = tmp_path / "other.c"
    other.write_text("int unrelated(void){return 1;}\n")
    os.system(f"gcc -shared -fPIC -o {tmp_path / 'other.so'} {other}")
    os.replace(tmp_path / "other.so", cache.library_path(fps["topdown"]))
    _unload()
    _build.build_all(cache=cache)
    assert _build.STATS["compiles"] == len(_build.SOURCES) + 2
    assert cache.stats()["corrupt_evictions"] == 2
    assert _build.STATS["sources"]["bottomup"] == "compiled"
    assert _build.STATS["sources"]["topdown"] == "compiled"
    assert _build.STATS["sources"]["frontier_fused"] == "cache"
    # topdown's entry path was opened before in this process: the rebuilt
    # file loads fresh (dlopen would hand back the stale handle by path)
    gens = {n: _build._libraries[n].stand_in_generation()
            for n in _build.SOURCES}
    n_cold = len(_build.SOURCES)       # parallel builds may share a count
    assert all(n_cold < gens[n] <= n_cold + 2 for n in ("bottomup", "topdown"))
    assert max(gens[n] for n in ("decode_attn", "frontier_fused")) <= n_cold
    assert _build.function("bottomup") is not None


@pytest.mark.skipif(shutil.which("gcc") is None, reason="needs gcc")
def test_corrupt_library_without_nvcc_raises(stand_in_nvcc, tmp_path,
                                             monkeypatch):
    """No plain version takes a bad library's place: with no nvcc the
    build raises."""
    cache = TAC.ArtifactCache(str(tmp_path / "cache"), 1 << 30)
    _build.build_all(cache=cache)
    fp = TFP.kernel_fingerprint("frontier_fused")
    garbage = tmp_path / "garbage"
    garbage.write_bytes(b"garbage")
    os.replace(garbage, cache.library_path(fp))
    _unload()
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(cache=cache)
    assert cache.stats()["corrupt_evictions"] == 1


# ------------------------------------------------- cross-session sharing --

def test_sessions_share_plans_by_content_hash():
    """A second session over a byte-identical rebuilt graph reuses every
    plan (and so the tiles) with nothing materialized, as the JAX
    package's second session does; a different graph shares nothing."""
    with runtime_scope(cache_dir=None, share_plans=True):
        s1 = GraphSession(TG.rmat(9, seed=7), "cpu")
        r1 = Engine(s1).bfs(ROOTS, BFSConfig(), backend="fused")
        assert s1.total_builds == COHORT_PLANS
        assert registry_size() == COHORT_PLANS + 2   # its tiles and CSR
        s2 = GraphSession(TG.rmat(9, seed=7), "cpu")
        r2 = Engine(s2).bfs(ROOTS, BFSConfig(), backend="fused")
        assert s2.total_materialized == 0
        assert sum(s2.cache_info()["shared_counts"].values()) == COHORT_PLANS
        assert "ell" not in s2.cache_info()["builds"]
        assert s2.device_graph() is s1.device_graph()
        assert s2.runtime_stats()["plan_sources"] == {"shared": COHORT_PLANS}
        assert np.array_equal(r1.parent, r2.parent)
        s3 = GraphSession(TG.rmat(9, seed=8), "cpu")
        Engine(s3).bfs(ROOTS, BFSConfig(), backend="fused")
        assert s3.total_builds == COHORT_PLANS
        # the publisher's close takes its plans back; the sharer keeps them
        s1.close()
        assert registry_size() == COHORT_PLANS + 2   # s3's
        Engine(s2).bfs(ROOTS, BFSConfig(), backend="fused")
    jax_registry_reset()
    with jax_runtime_scope(cache_dir=None, share_plans=True):
        j1 = JSession(JG.rmat(9, seed=7))
        JEngine(j1).bfs(ROOTS, JBFSConfig(), backend="fused")
        j2 = JSession(JG.rmat(9, seed=7))
        jr = JEngine(j2).bfs(ROOTS, JBFSConfig(), backend="fused")
        assert j1.total_traces == JAX_COHORT_EXECUTABLES
        assert j2.total_materialized == 0
    jax_registry_reset()
    assert np.array_equal(r2.parent, np.asarray(jr.parent))


def test_registry_stats_count_the_shared_hits():
    """A session that publishes hits nothing; a second one over the same
    graph hits its three plans and the tiles; a reset zeroes both."""
    with runtime_scope(cache_dir=None, share_plans=True):
        s1 = GraphSession(TG.rmat(9, seed=7), "cpu")
        Engine(s1).bfs(ROOTS, BFSConfig(), backend="fused")
        assert registry_stats() == dict(plans=COHORT_PLANS + 2, hits=0)
        s2 = GraphSession(TG.rmat(9, seed=7), "cpu")
        Engine(s2).bfs(ROOTS, BFSConfig(), backend="fused")
        assert registry_stats() == dict(plans=COHORT_PLANS + 2,
                                        hits=COHORT_PLANS + 1)
        assert registry_stats()["plans"] == registry_size()
    reset_process_caches()
    assert registry_stats() == dict(plans=0, hits=0)


def test_share_plans_off_keeps_sessions_isolated():
    with runtime_scope(cache_dir=None, share_plans=False):
        csrs = []
        for _ in range(2):
            s = GraphSession(TG.rmat(9, seed=7), "cpu")
            Engine(s).bfs(ROOTS, BFSConfig(), backend="fused")
            assert s.total_builds == COHORT_PLANS
            assert s.cache_info()["builds"]["ell"] == 1
            assert s.runtime_stats()["csr_s"] > 0
            csrs.append(s.device_graph())
        assert registry_size() == 0
        assert csrs[0] is not csrs[1]


def test_shared_plans_read_the_sharers_csr_and_outlive_the_publisher():
    """A sharing session's init and its shared steps read one CSR (the
    publisher's); closing the publisher leaves the sharer its CSR, tiles
    and plans. The seconds of the hash, the upload and the tiles land on
    the session that did that work."""
    with runtime_scope(cache_dir=None, share_plans=True):
        s1 = GraphSession(TG.rmat(9, seed=7), "cpu")
        r1 = Engine(s1).bfs(ROOTS, BFSConfig(), backend="fused")
        s2 = GraphSession(TG.rmat(9, seed=7), "cpu")
        Engine(s2).bfs(ROOTS, BFSConfig(), backend="fused")
        dg, tiles = s2.device_graph(), s2.ell_tiles()
        assert dg is s1.device_graph() and tiles is s1.ell_tiles()
        st1, st2 = s1.runtime_stats(), s2.runtime_stats()
        assert min(st1[k] for k in ("fingerprint_s", "csr_s", "tiles_s")) > 0
        assert st2["fingerprint_s"] > 0      # its own graph object, hashed
        assert st2["csr_s"] == st2["tiles_s"] == 0.0
        s1.close()
        r2 = Engine(s2).bfs(ROOTS, BFSConfig(), backend="fused")
        assert s2.device_graph() is dg and s2.ell_tiles() is tiles
        assert s2.total_materialized == 0
        assert np.array_equal(r1.parent, r2.parent)
        assert np.array_equal(r1.level, r2.level)


def test_sessions_on_many_threads_build_each_plan_once():
    """More sessions of one graph than cores, each querying on its own
    thread at once (the server's workers), with a short switch interval:
    each plan and the tiles are built exactly once process-wide (a lost
    publish would build twice), and every session gets a lone search's
    trees from the shared step functions."""
    import sys
    g = TG.rmat(9, seed=7)
    with runtime_scope(cache_dir=None, share_plans=False):
        want = Engine(g, device="cpu").bfs(ROOTS)
    n = (os.cpu_count() or 4) + 4
    engines = [Engine(TG.rmat(9, seed=7), device="cpu") for _ in range(n)]
    go = threading.Barrier(n)
    out, errors = {}, []

    def run(i):
        try:
            go.wait(60)
            for _ in range(2):
                out[i] = engines[i].bfs(ROOTS)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    stats = [e.session.runtime_stats() for e in engines]
    assert sum(st["builds"].get("cohort", 0) for st in stats) == COHORT_PLANS
    assert sum(st["builds"].get("ell", 0) for st in stats) == 1
    assert sum(st["shared"] for st in stats) == (n - 1) * COHORT_PLANS
    for i in range(n):
        assert np.array_equal(out[i].parent, want.parent)
        assert np.array_equal(out[i].level, want.level)


# ------------------------------------------------------------- pre-warm --

def _record_buckets(graph, cache_dir, buckets=(1, 8, 16)):
    """Plan records for each batch bucket (3 variants each)."""
    with runtime_scope(cache_dir=str(cache_dir), prewarm=False):
        s = GraphSession(graph, "cpu")
        for b in buckets:
            Engine(s).bfs(np.arange(b), backend="fused")
        s.close()
    reset_process_caches()
    return len(buckets) * COHORT_PLANS


def test_prewarm_progress_and_limit(tmp_path):
    g = TG.rmat(8, seed=2)
    n = _record_buckets(g, tmp_path)
    with runtime_scope(cache_dir=str(tmp_path), prewarm_limit=4):
        s = GraphSession(g, "cpu")
        p = s.prewarm_wait(60)
        assert (p["total"], p["loaded"], p["failed"], p["skipped"]) == \
            (n, 4, 0, n - 4)
        assert p["done"] and p["error"] is None and p["seconds"] > 0
        assert s.total_loads == 4 and s.total_builds == 0
        # a pre-warmed plan is a load; the others build on the query path
        for b in (1, 8, 16):
            Engine(s).bfs(np.arange(b), backend="fused")
        assert s.total_loads + s.total_builds == n
        st = s.runtime_stats()
        assert st["plan_sources"] == {"prewarmed": 4, "built": n - 4}
        assert st["prewarm"]["loaded"] == 4
        assert st["artifact_cache"]["hits"] == 4
        assert s.close(10)


def test_prewarm_stop_and_join(tmp_path, monkeypatch):
    g = TG.rmat(8, seed=2)
    n = _record_buckets(g, tmp_path)
    started, release = threading.Event(), threading.Event()
    real = GraphSession.plan_build

    def slow(self, key):
        build = real(self, key)

        def wait_then_build():
            started.set()
            release.wait(30)
            return build()
        return wait_then_build
    monkeypatch.setattr(GraphSession, "plan_build", slow)
    with runtime_scope(cache_dir=str(tmp_path)):
        s = GraphSession(g, "cpu")
        assert started.wait(30)
        s.signal_close()
        assert not s.close(0.05)         # still inside its first build
        release.set()
        assert s.close(30)               # joined
        p = s.prewarm_progress.as_dict()
        assert p["done"] and p["loaded"] == 1 and p["skipped"] == n - 1
        assert s._prewarm_thread is None


def test_prewarm_error_is_visible_and_queries_still_build(tmp_path,
                                                          monkeypatch):
    g = TG.rmat(8, seed=2)
    _record_buckets(g, tmp_path, buckets=(8,))

    real, broke = GraphSession.plan_build, []

    def broken_once(self, key):
        build = real(self, key)

        def first_fails():
            if not broke:
                broke.append(key)
                raise RuntimeError("pre-warm build broke")
            return build()
        return first_fails
    monkeypatch.setattr(GraphSession, "plan_build", broken_once)
    with runtime_scope(cache_dir=str(tmp_path)):
        s = GraphSession(g, "cpu")
        p = s.prewarm_wait(30)
        assert "pre-warm build broke" in p["error"]
        assert s.runtime_stats()["prewarm"]["error"] == p["error"]
        res = Engine(s).bfs(ROOTS, backend="fused", validate=True)
        assert s.total_builds == COHORT_PLANS and s.total_loads == 0
        assert res.parent.shape == (8, g.num_vertices)
        s.close()


# ------------------------------------------------ subprocess cold / warm --

def test_restart_probe_records_the_graph_file_size(tmp_path):
    """A probe on a saved graph records that graph's size (scale 8 here),
    not the default RMAT scale, and its children attach that graph."""
    from repro_torch.launch import bfs_serve
    g = TG.rmat(8, seed=5)
    path = str(tmp_path / "g8.npz")
    np.savez(path, v=g.num_vertices, indptr=g.indptr, indices=g.indices,
             degrees=g.degrees)
    out = bfs_serve.run_restart_probe(str(tmp_path / "cache"),
                                      graph_path=path, device="cpu",
                                      timeout=300)
    assert (out["scale"], out["num_vertices"]) == (8, 256)
    assert out["graph_path"] == path
    assert out["root"] == int(g.degrees.argmax()) and out["same_trees"]


def test_subprocess_cold_then_warm_restart(tmp_path):
    """Two processes on one cache dir: the warm one builds no cohort plan
    on its query path, pre-warms the whole set, and its trees equal the
    cold one's and the JAX reference's."""
    from repro_torch.launch import bfs_serve
    out = bfs_serve.run_restart_probe(str(tmp_path), scale=9, seed=3,
                                      device="cpu", timeout=300)
    assert out["cold_builds"] == COHORT_PLANS
    assert out["warm_builds"] == 0
    assert out["warm_loads"] == COHORT_PLANS
    assert out["prewarm"]["loaded"] == COHORT_PLANS
    assert out["prewarm"]["failed"] == 0 and out["prewarm"]["error"] is None
    assert out["hit_rate"] == 1.0
    assert out["cold_compiles"] == out["warm_compiles"] == 0   # CPU: none
    assert out["same_trees"]
    # the warm start's pre-warm hashed the graph, uploaded it and built the
    # tiles again; the cold start's query did
    for parts in (out["cold_parts"], out["warm_parts"]):
        assert set(parts) == set(bfs_serve.RESTART_PARTS)
        assert parts["fingerprint_s"] > 0 and parts["tiles_s"] > 0
        assert parts["kernel_build_s"] == 0.0           # CPU: no kernels
    root, parent, level = out["trees"]["warm"]
    assert np.array_equal(parent, out["trees"]["cold"][1])
    ref = JEngine(JG.rmat(9, seed=3)).bfs([root], backend="fused")
    assert np.array_equal(parent, np.asarray(ref.parent))
    assert np.array_equal(level, np.asarray(ref.level))


def test_bfs_run_cache_dir(tmp_path):
    """`bfs_run --cache-dir`: the first run builds and records its plans;
    after a process-state reset (a restart, in process) the same run
    pre-warms them and builds none."""
    from repro_torch.launch import bfs_run
    argv = ["--scale", "8", "--roots", "2", "--device", "cpu",
            "--cache-dir", str(tmp_path)]
    try:
        first = bfs_run.main(argv)
        reset_process_caches()
        second = bfs_run.main(argv)
    finally:
        TCFG.reset_runtime_config()
    assert first["warm"] == dict(builds=COHORT_PLANS, loads=0, compiles=0,
                                 cache_enabled=True)
    assert second["warm"] == dict(builds=0, loads=COHORT_PLANS, compiles=0,
                                  cache_enabled=True)
    assert second["teps_hmean"] > 0


def test_bfs_serve_cache_dir_restart_and_chaos_probes(tmp_path):
    """`bfs_serve --cache-dir --restart-probe --chaos-probe` on the CPU:
    the load, the four chaos phases (the cache one evicts a record and
    builds it again), and the restart probe's cold and warm children."""
    from repro_torch.launch import bfs_serve
    try:
        m, stats = bfs_serve.main([
            "--graphs", "1", "--scale", "8", "--clients", "2",
            "--queries", "2", "--device", "cpu", "--cache-dir",
            str(tmp_path), "--restart-probe", "--chaos-probe"])
    finally:
        TCFG.reset_runtime_config()
    assert m["queries"] == 4
    rt = stats["sessions"]["rmat8-0"]["runtime"]
    assert rt["cache_enabled"] and rt["artifact_cache"]["stores"] > 0
    chaos = stats["chaos_probe"]
    assert chaos["ok"], chaos
    assert chaos["cache"]["corrupt_evictions"] >= 1
    assert chaos["cache"]["rebuilds"] >= 1 and chaos["cache"]["bitwise"]
    restart = stats["restart_probe"]
    assert restart["warm_builds"] == 0 and restart["same_trees"]
    # the load's records of the same graph pre-warm in both children too
    assert restart["prewarm_loaded"] >= COHORT_PLANS


def test_server_stats_carry_the_runtime_block(tmp_path):
    g = TG.rmat(8, seed=2)
    with runtime_scope(cache_dir=str(tmp_path)):
        with BFSServer({"a": g, "b": TG.rmat(8, seed=2)},
                       device="cpu") as srv:
            srv.submit("a", ROOTS[:4]).result(60)
            srv.submit("b", ROOTS[:4]).result(60)
        stats = srv.stats()
    ra, rb = (stats["sessions"][n]["runtime"] for n in ("a", "b"))
    for rt in (ra, rb):
        assert rt["cache_enabled"] and rt["prewarm"]["done"]
        assert {"builds", "warmups", "kernel_build_s", "loads", "shared",
                "plan_sources", "artifact_cache"} <= set(rt)
    # the two sessions of one graph share one plan set
    assert sorted([ra["plan_sources"], rb["plan_sources"]], key=len) in (
        [{"built": COHORT_PLANS}, {"shared": COHORT_PLANS}],
        [{"shared": COHORT_PLANS}, {"built": COHORT_PLANS}])
    assert ra["artifact_cache"]["stores"] == COHORT_PLANS

"""The port's fault injection, runtime config and concurrency sanitizer
against the JAX package's, on the CPU.

* The same schedule strings parse to equal specs in both packages, and bad
  ones fail alike.
* The same schedule and seed fire the same occurrences with the same
  actions, whatever the sites and contexts (`@p=` draws included).
* `RuntimeConfig.resolve` gives the same precedence (explicit > env >
  default) for the formulation, fault and sanitizer fields, and
  validates alike (the cache fields: `tests/test_torch_runtime.py`).
* The sanitizer records the same lock-order edges and cycles.
* The port's fault sites: `device` at query entry, `dispatch` per level
  with the formulation in its context, per root in Graph500 mode, and
  `compile` on a session build (a failed build is not cached).
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.analysis import concurrency as JC
from repro.runtime import config as JCFG
from repro.runtime import faults as JF
from repro_torch.analysis import concurrency as TC
from repro_torch.core import bfs as TB
from repro_torch.core import graph as TG
from repro_torch.engine import Engine
from repro_torch.runtime import config as TCFG
from repro_torch.runtime import faults as TF
from repro_torch.runtime import reset_process_caches

SCHEDULES = [
    "dispatch",
    "worker@3",
    "worker@0,2,5",
    "straggler@every=4:delay=20ms",
    "dispatch[mode=batch,kernels=tiles]@*",
    "cache_load@p=0.5",
    "worker@1;straggler@every=5:delay=2ms;dispatch[mode=batch]@1,4;compile@2",
    "cache_load@*;compile@0;device@p=0.1:limit=2",
    "dispatch@*:limit=2",
    "dispatch[kernels=gather]@p=0.3:limit=5;device@every=2",
    "  dispatch@0 ; ; worker@1  ",
    "",
]

BAD = ["nosuch@0", "dispatch@x", "dispatch[mode]@0", "dispatch:delay=abc",
       "dispatch:color=red", "dispatch@every=0", "dispatch@p=2",
       "dispatch:limit=0", "dispatch@0:nolimit", "dispatch@every=2,3"]


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    TF.uninstall()
    JF.uninstall()
    yield
    TF.uninstall()
    JF.uninstall()


@pytest.fixture(autouse=True)
def _reset_port_runtime():
    """Plans are shared across sessions by graph content, and this file's
    tests reuse graphs: reset the port's registry (and its fingerprint and
    cache memos) around each test, so build counts do not depend on which
    tests ran before."""
    reset_process_caches()
    yield
    reset_process_caches()


@pytest.mark.parametrize("text", SCHEDULES)
def test_schedules_parse_alike(text):
    mine = TF.parse_schedule(text)
    ref = JF.parse_schedule(text)
    assert [dataclasses.astuple(s) for s in mine] == \
        [dataclasses.astuple(s) for s in ref]


@pytest.mark.parametrize("text", BAD)
def test_bad_schedules_fail_alike(text):
    with pytest.raises(ValueError) as mine:
        TF.parse_schedule(text)
    with pytest.raises(ValueError) as ref:
        JF.parse_schedule(text)
    assert str(mine.value) == str(ref.value)


def _occurrences(rng):
    """A seeded stream of (site, ctx) occurrences over every site."""
    out = []
    for _ in range(400):
        site = TF.SITES[rng.integers(len(TF.SITES))]
        ctx = {}
        if site in ("dispatch", "straggler"):
            ctx = dict(mode=["batch", "scalar", "stepper"][rng.integers(3)],
                       kernels=["tiles", "gather"][rng.integers(2)],
                       level=int(rng.integers(5)))
        out.append((site, ctx))
    return out


def _run(mod, schedule, seed, occurrences, monkeypatch):
    monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    inj = mod.FaultInjector(schedule, seed=seed)
    fired = []
    for site, ctx in occurrences:
        try:
            inj.fire(site, **ctx)
            fired.append("pass")
        except mod.DevicePressure as e:
            fired.append(("pressure", e.site, e.occurrence, e.transient))
        except mod.FaultInjected as e:
            fired.append(("raise", e.site, e.occurrence, e.transient))
    return fired, inj.events, inj.stats()


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("text", SCHEDULES)
def test_same_seed_fires_the_same_sequence(text, seed, monkeypatch):
    occ = _occurrences(np.random.default_rng(seed))
    mine = _run(TF, text, seed, occ, monkeypatch)
    ref = _run(JF, text, seed, occ, monkeypatch)
    assert mine == ref


def test_fault_scope_and_ensure_installed_alike():
    for mod, cfg in ((TF, TCFG), (JF, JCFG)):
        with mod.fault_scope("worker@0") as inj:
            assert mod.active() is inj
            with pytest.raises(mod.FaultInjected):
                mod.fault_point("worker", session="s")
            mod.fault_point("worker", session="s")      # @0 only
        assert mod.active() is None
        rt = cfg.RuntimeConfig(faults="device@*", faults_seed=3)
        inj = mod.ensure_installed(rt)
        assert inj.seed == 3 and mod.ensure_installed(rt) is inj
        with pytest.raises(mod.DevicePressure):
            mod.fault_point("device")
        mod.uninstall()


# ------------------------------------------------------------ runtime config


FIELDS = ("kernel_backend", "faults", "faults_seed", "sanitize")
ENVS = [
    {},
    {"REPRO_KERNELS": "off"},
    {"REPRO_KERNELS": "0", "REPRO_FAULTS": "worker@0",
     "REPRO_FAULTS_SEED": "7", "REPRO_SANITIZE": "yes"},
    {"REPRO_KERNELS": "AUTO", "REPRO_FAULTS": "", "REPRO_SANITIZE": "0"},
]
EXPLICIT = [{}, {"kernel_backend": "off"},
            {"faults": "dispatch@*", "faults_seed": 2, "sanitize": False},
            {"kernel_backend": None, "faults": None}]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("explicit", EXPLICIT)
def test_resolve_precedence_alike(env, explicit):
    mine = TCFG.RuntimeConfig.resolve(env=env, **explicit)
    ref = JCFG.RuntimeConfig.resolve(env=env, **explicit)
    assert [getattr(mine, f) for f in FIELDS] == \
        [getattr(ref, f) for f in FIELDS]


@pytest.mark.parametrize("env,explicit", [
    ({"REPRO_FAULTS_SEED": "x"}, {}), ({"REPRO_SANITIZE": "perhaps"}, {}),
    ({"REPRO_FAULTS": "nosuch@0"}, {}), ({}, {"faults": "worker@"}),
    ({}, {"faults": "dispatch@x"})])
def test_resolve_rejects_alike(env, explicit):
    with pytest.raises(ValueError) as mine:
        TCFG.RuntimeConfig.resolve(env=env, **explicit)
    with pytest.raises(ValueError) as ref:
        JCFG.RuntimeConfig.resolve(env=env, **explicit)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("env,explicit,jax_refuses", [
    ({"REPRO_KERNELS": "maybe"}, {}, True), ({"REPRO_KERNELS": "on"}, {}, False),
    ({"REPRO_KERNELS": "1"}, {}, False), ({}, {"kernel_backend": "on"}, False),
    ({}, {"kernel_backend": "xla"}, True)])
def test_kernel_backend_is_auto_or_off(env, explicit, jax_refuses):
    """The port's REPRO_KERNELS takes 'auto' and 'off' only: the JAX
    package's 'on' (its kernels off the TPU too) is what 'auto' already
    does in the port, so the port refuses it; other values both refuse."""
    with pytest.raises(ValueError, match="'auto' already runs the kernels"):
        TCFG.RuntimeConfig.resolve(env=env, **explicit)
    if jax_refuses:
        with pytest.raises(ValueError):
            JCFG.RuntimeConfig.resolve(env=env, **explicit)
    else:
        assert JCFG.RuntimeConfig.resolve(env=env, **explicit) \
            .kernel_backend == "on"


def test_runtime_singleton_scopes():
    TCFG.reset_runtime_config()
    base = TCFG.get_runtime_config()
    with TCFG.runtime_scope(kernel_backend="off") as cfg:
        assert TCFG.get_runtime_config() is cfg
        assert cfg.kernel_backend == "off"
    assert TCFG.get_runtime_config() is base
    assert TCFG.configure(faults_seed=5).faults_seed == 5
    TCFG.reset_runtime_config()
    assert TCFG.get_runtime_config().faults_seed == base.faults_seed


# ---------------------------------------------------------------- sanitizer


def _lock_orders(mod):
    with mod.sanitize_scope(hold_threshold_s=10.0) as san:
        a, b = mod.make_lock("a"), mod.make_lock("b")
        r = mod.make_rlock("r")
        with a, b:
            pass

        def other():
            with b, a:
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with r, r, a:
            pass
        timer = mod.make_timer(60, lambda: None, name="t")
        timer.start()
        live = san.report()["timers_live"]
        timer.cancel()
        timer.join()
        rep = san.report()
    return ({k: rep[k] for k in ("locks", "acquires", "edges", "cycles",
                                 "long_holds", "timers_live")}, live)


def test_sanitizer_records_alike():
    assert _lock_orders(TC) == _lock_orders(JC)
    assert _lock_orders(TC)[0]["cycles"]


# -------------------------------------------------------- the port's sites


def test_engine_fault_sites():
    g = TG.rmat(8, seed=2)
    roots = np.flatnonzero(g.degrees > 0)[:3]
    eng = Engine(g, device="cpu")
    for cfg, kernels in ((TB.BFSConfig(), "tiles"),
                         (TB.BFSConfig(backend_kernels=False), "gather")):
        with TF.fault_scope("device@*") as inj:
            with pytest.raises(TF.DevicePressure):
                eng.bfs(roots, cfg)
        with TF.fault_scope("straggler@*:delay=1ms") as inj:
            res = eng.bfs(roots, cfg)
            assert inj.fired("straggler") == len(res.batch_level_stats)
            assert {e["ctx"]["kernels"] for e in inj.events} == {kernels}
            assert {e["ctx"]["mode"] for e in inj.events} == {"batch"}
            inj.events.clear()
            res = eng.bfs(roots, cfg, batched=False)
            assert inj.fired("straggler") == sum(int(n) + 1
                                                 for n in res.num_levels)
            assert {e["ctx"]["mode"] for e in inj.events} == {"scalar"}
            inj.events.clear()
            eng.bfs(roots[:1], cfg, backend="stepper")
            assert {e["ctx"]["mode"] for e in inj.events} == {"stepper"}
        with TF.fault_scope(f"dispatch[mode=scalar,kernels={kernels}]@2"):
            with pytest.raises(TF.FaultInjected) as e:
                eng.bfs(roots, cfg, batched=False)
            assert e.value.transient


def test_compile_fault_is_not_cached():
    g = TG.rmat(7, seed=4)
    eng = Engine(g, device="cpu")
    with TF.fault_scope("compile@0") as inj:
        with pytest.raises(TF.FaultInjected):
            eng.bfs([0, 1])
        assert inj.events[0]["site"] == "compile"
        res = eng.bfs([0, 1], validate=True)      # the build runs again
    assert res.parent.shape == (2, g.num_vertices)
    assert eng.session.runtime_stats()["builds"]["ell"] == 1


def test_session_runtime_stats_and_close():
    g = TG.rmat(7, seed=4)
    eng = Engine(g, device="cpu")
    eng.bfs([0, 1])
    eng.bfs([0], backend="stepper")
    st = eng.session.runtime_stats()
    assert st["builds"] == {"ell": 1, "cohort": 3, "stepper_step": 1}
    assert st["warmups"] == 2 and st["kernel_build_s"] == 0.0
    eng.session.signal_close()
    assert eng.session.close(0.1)
    assert eng.session.runtime_stats()["warmups"] == 0
    eng.bfs([0, 1], validate=True)                # builds again after close
    assert eng.session.runtime_stats()["builds"]["ell"] == 2

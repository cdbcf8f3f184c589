"""Deterministic fault injection for the serving runtime (chaos harness).

The port's copy of the JAX package's `runtime/faults.py` (which imports no
JAX): the same grammar, sites and seeded selection, so one schedule string
fires the same occurrences in both packages (`tests/test_torch_faults.py`).
The port names a dispatch's formulation ``kernels=tiles`` (the ELL-tile
kernels) or ``kernels=gather`` (the CSR gather formulation) where the JAX
package writes ``pallas`` / ``xla``.

A production BFS service is only as available as its failure story, and a
failure story is only testable if failures can be *produced on demand,
deterministically*. This module is the single switchboard: the runtime and
serving layers call `fault_point(site, **ctx)` at a fixed set of named
injection sites, and an installed `FaultInjector` decides — from a seeded,
text-describable schedule — whether that occurrence raises a typed fault,
sleeps (straggler), or passes through. With no injector installed,
`fault_point` is one module-global load plus a None check: zero overhead on
every production path.

Injection sites (`SITES`) and where they are threaded:

=============  ===========================================================
compile        `engine.session.GraphSession.cached` — building a cached
               step function, tile set or backend fails; the failed build
               is not cached (ctx: ``key``)
cache_load     `runtime.artifact_cache.ArtifactCache.load` (a plan record)
               and `load_library` (a built kernel library), inside the
               load's try: a fired fault takes the corrupt-entry path
               (evict, count, miss; the caller builds again) (ctx:
               ``fingerprint``)
dispatch       per-level kernel dispatch in `engine.level_loop.LevelDriver`
               and the per-root dispatch loops in `engine.engine` (ctx:
               ``mode`` in batch|scalar|stepper|sharded, ``kernels`` in
               tiles|gather, ``level`` where applicable)
device         simulated device/memory pressure at query entry
               (`Engine.bfs_plan`; raises `DevicePressure`, non-transient —
               the degradation chain, not the retry loop, handles it)
worker         `server.BFSServer` session worker between queue pop and
               dispatch — the thread "crashes" with a popped batch in hand
               (ctx: ``session``)
straggler      per-level delay in the `LevelDriver` loop — the spec's
               ``delay=`` modifier sleeps instead of raising (ctx as
               dispatch)
=============  ===========================================================

Schedule format (``REPRO_FAULTS`` / `install(text)`): specs separated by
``;``, each

    site[key=value,...]@selector:modifier:modifier...

* ``[key=value,...]`` — optional ctx filter; the spec only matches
  occurrences whose `fault_point` ctx has ``str(ctx[key]) == value``
  (e.g. ``dispatch[kernels=tiles]`` fails only kernel-backed dispatches,
  leaving the gather degradation path clear).
* ``@selector`` — which *matched* occurrences fire (0-based, counted per
  spec): ``@0,3,7`` explicit indices; ``@*`` every occurrence;
  ``@every=3`` every 3rd; ``@p=0.25`` Bernoulli per occurrence, derived
  deterministically from (schedule seed, site, occurrence index) so thread
  interleaving cannot change which indices fire. Default: ``@0``.
* modifiers: ``:delay=20ms`` (or ``0.5s`` / plain seconds) sleeps instead
  of raising — the straggler action; ``:limit=4`` stops after 4 fires.

Examples:

    worker@1;dispatch[mode=batch]@0,2;straggler@every=5:delay=3ms
    cache_load@*;compile@0;device@p=0.1:limit=2

The injector records every fire in `events` (site, occurrence, action) and
aggregates per-site counts in `stats()` — the chaos bench and tests assert
against both. `fault_scope(...)` installs a schedule for a `with` block
(tests); `ensure_installed(runtime)` installs from `RuntimeConfig.faults`
(the ``REPRO_FAULTS`` env path) exactly once per process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import re
import threading
import time
from typing import Optional, Tuple

SITES = ("compile", "cache_load", "dispatch", "device", "worker",
         "straggler")

_MODIFIERS = ("delay", "limit")


class FaultInjected(RuntimeError):
    """A fault produced by the injection harness (transient by default).

    `transient=True` means the serving retry policy may re-dispatch the
    query — the schedule decides whether the retry hits the fault again.
    """

    transient = True

    def __init__(self, site: str, occurrence: int, detail: str = ""):
        self.site = site
        self.occurrence = occurrence
        msg = f"injected fault: {site}#{occurrence}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)


class DevicePressure(FaultInjected):
    """Simulated device/memory pressure (RESOURCE_EXHAUSTED analogue).

    Non-transient: retrying the identical dispatch against an exhausted
    device is wasted work — the degradation chain (smaller/plainer
    paths: the gather formulation, per-query scalar dispatch) is the recovery
    path, and `BFSServer` routes it there directly.
    """

    transient = False

    def __init__(self, site: str, occurrence: int, detail: str = ""):
        super().__init__(site, occurrence,
                         detail or "RESOURCE_EXHAUSTED: simulated "
                                   "device memory pressure")


def _parse_delay(text: str, *, spec: str) -> float:
    s = str(text).strip().lower()
    try:
        if s.endswith("ms"):
            return float(s[:-2]) / 1e3
        if s.endswith("s"):
            return float(s[:-1])
        return float(s)
    except ValueError:
        raise ValueError(
            f"fault spec {spec!r}: cannot parse delay {text!r} "
            f"(want e.g. 20ms, 0.5s, or plain seconds)") from None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed schedule entry: where, which occurrences, what action."""

    site: str
    match: Tuple[Tuple[str, str], ...] = ()   # ((ctx key, value str), ...)
    hits: Optional[frozenset] = None          # explicit occurrence indices
    every: Optional[int] = None               # every Nth matched occurrence
    p: Optional[float] = None                 # Bernoulli per occurrence
    limit: Optional[int] = None               # max fires for this spec
    delay_s: float = 0.0                      # > 0: sleep instead of raise

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; want one of {SITES}")
        selectors = sum(x is not None for x in (self.hits, self.every,
                                                self.p))
        if selectors > 1:
            raise ValueError(
                f"fault spec for {self.site!r}: hits/every/p are mutually "
                "exclusive selectors")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.p is not None and not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.limit is not None and self.limit < 1:
            raise ValueError(f"limit must be >= 1, got {self.limit}")
        if self.delay_s < 0:
            raise ValueError(f"delay must be >= 0, got {self.delay_s}")

    def matches(self, ctx: dict) -> bool:
        return all(str(ctx.get(k)) == v for k, v in self.match)

    def selected(self, occurrence: int, seed: int) -> bool:
        """Does the spec fire on its `occurrence`-th matched hit (0-based)?"""
        if self.hits is not None:
            return occurrence in self.hits
        if self.every is not None:
            return occurrence % self.every == 0
        if self.p is not None:
            # Deterministic per (seed, site, occurrence): concurrent threads
            # racing over occurrence indices cannot change which fire.
            r = random.Random(f"{seed}:{self.site}:{occurrence}").random()
            return r < self.p
        return occurrence == 0                 # default: first occurrence


_SPEC_RE = re.compile(
    r"^(?P<site>[a-z_]+)"
    r"(?:\[(?P<filters>[^\]]*)\])?"
    r"(?:@(?P<sel>[^:]+))?"
    r"(?P<mods>(?::[^:]+)*)$")


def parse_spec(text: str) -> FaultSpec:
    """One schedule entry -> `FaultSpec` (see module docstring for format)."""
    s = text.strip()
    m = _SPEC_RE.match(s)
    if not m:
        raise ValueError(f"cannot parse fault spec {text!r}")
    site = m.group("site")
    match = []
    if m.group("filters"):
        for pair in m.group("filters").split(","):
            if "=" not in pair:
                raise ValueError(
                    f"fault spec {text!r}: filter {pair!r} is not key=value")
            k, v = pair.split("=", 1)
            match.append((k.strip(), v.strip()))
    hits = every = p = None
    sel = m.group("sel")
    if sel is not None:
        sel = sel.strip()
        if sel == "*":
            every = 1
        elif sel.startswith("every="):
            every = int(sel[len("every="):])
        elif sel.startswith("p="):
            p = float(sel[len("p="):])
        else:
            try:
                hits = frozenset(int(x) for x in sel.split(","))
            except ValueError:
                raise ValueError(
                    f"fault spec {text!r}: selector {sel!r} is not '*', "
                    "'every=N', 'p=X', or a comma list of indices") from None
    limit = None
    delay_s = 0.0
    mods = m.group("mods") or ""
    for mod in filter(None, mods.split(":")):
        if "=" not in mod:
            raise ValueError(
                f"fault spec {text!r}: modifier {mod!r} is not key=value")
        k, v = mod.split("=", 1)
        k = k.strip()
        if k == "delay":
            delay_s = _parse_delay(v, spec=text)
        elif k == "limit":
            limit = int(v)
        else:
            raise ValueError(
                f"fault spec {text!r}: unknown modifier {k!r} "
                f"(want one of {_MODIFIERS})")
    return FaultSpec(site=site, match=tuple(match), hits=hits, every=every,
                     p=p, limit=limit, delay_s=delay_s)


def parse_schedule(text) -> Tuple[FaultSpec, ...]:
    """';'-separated spec list -> tuple of `FaultSpec` (''/None -> empty)."""
    if text is None:
        return ()
    return tuple(parse_spec(part) for part in str(text).split(";")
                 if part.strip())


class FaultInjector:
    """Active fault schedule: thread-safe occurrence counting + firing.

    One injector drives the whole process (module singleton via
    `install`); every counter and the event log are observable, so tests
    and the chaos bench can assert exactly what fired.
    """

    def __init__(self, schedule, seed: int = 0):
        if isinstance(schedule, str):
            schedule = parse_schedule(schedule)
        self.specs = tuple(schedule)
        self.seed = int(seed)
        # Lazy: repro_torch.analysis.concurrency mirrors THIS module's pattern;
        # a top-level import would be circular in spirit (both are
        # install-at-runtime observers) and costs import time when off.
        from repro_torch.analysis.concurrency import make_lock
        self._lock = make_lock("faults")
        self._site_seen: dict = {s: 0 for s in SITES}
        self._spec_seen = [0] * len(self.specs)
        self._spec_fired = [0] * len(self.specs)
        self.events: list = []          # dicts: site, occurrence, action

    def fire(self, site: str, **ctx) -> None:
        """Evaluate one occurrence of `site`; raise/sleep when scheduled."""
        action = None
        with self._lock:
            self._site_seen[site] = self._site_seen.get(site, 0) + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site or not spec.matches(ctx):
                    continue
                occ = self._spec_seen[i]
                self._spec_seen[i] = occ + 1
                if spec.limit is not None and self._spec_fired[i] >= spec.limit:
                    continue
                if spec.selected(occ, self.seed):
                    self._spec_fired[i] += 1
                    action = (spec, occ)
                    self.events.append(dict(
                        site=site, occurrence=occ,
                        action="delay" if spec.delay_s > 0 else "raise",
                        ctx={k: str(v) for k, v in ctx.items()}))
                    break
        if action is None:
            return
        spec, occ = action
        if spec.delay_s > 0:
            time.sleep(spec.delay_s)
            return
        if site == "device":
            raise DevicePressure(site, occ)
        raise FaultInjected(site, occ)

    def fired(self, site: Optional[str] = None) -> int:
        """Total fires (raises + delays), optionally for one site."""
        with self._lock:
            if site is None:
                return len(self.events)
            return sum(1 for e in self.events if e["site"] == site)

    def stats(self) -> dict:
        with self._lock:
            fired: dict = {}
            for e in self.events:
                fired[e["site"]] = fired.get(e["site"], 0) + 1
            return dict(
                specs=len(self.specs),
                seen={s: n for s, n in self._site_seen.items() if n},
                fired=fired,
                total_fired=len(self.events),
            )


# --------------------------------------------------------- module singleton --

_install_lock = threading.Lock()
_active: Optional[FaultInjector] = None


def fault_point(site: str, **ctx) -> None:
    """Hook site: no-op unless a schedule is installed (the common case)."""
    inj = _active
    if inj is not None:
        inj.fire(site, **ctx)


def active() -> Optional[FaultInjector]:
    return _active


def install(schedule, seed: int = 0) -> FaultInjector:
    """Install a schedule process-wide; returns the injector (replaces any)."""
    global _active
    inj = (schedule if isinstance(schedule, FaultInjector)
           else FaultInjector(schedule, seed))
    with _install_lock:
        _active = inj
    return inj


def uninstall() -> None:
    global _active
    with _install_lock:
        _active = None


@contextlib.contextmanager
def fault_scope(schedule, seed: int = 0):
    """Install a schedule for a `with` block; restores the previous one."""
    global _active
    with _install_lock:
        prev = _active
    inj = install(schedule, seed)
    try:
        yield inj
    finally:
        with _install_lock:
            _active = prev


def ensure_installed(runtime=None) -> Optional[FaultInjector]:
    """Install from `RuntimeConfig.faults` (REPRO_FAULTS) if nothing is.

    Called by `GraphSession` / `BFSServer` construction so an env-scheduled
    chaos run needs no code changes; an explicitly installed injector (or a
    `fault_scope`) is never replaced.
    """
    if _active is not None:
        return _active
    if runtime is None:
        from repro_torch.runtime.config import get_runtime_config
        runtime = get_runtime_config()
    if not getattr(runtime, "faults", None):
        return None
    return install(runtime.faults, seed=getattr(runtime, "faults_seed", 0))


# Package-level export names (`install` alone is too generic there).
install_faults = install
uninstall_faults = uninstall
parse_fault_schedule = parse_schedule

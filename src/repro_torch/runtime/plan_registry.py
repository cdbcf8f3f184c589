"""In-process cross-session plan registry.

The port's counterpart of the JAX package's `runtime/plan_registry.py`.
A session keyed its plans on its own identity: two sessions over the same
graph (or over a rebuilt, byte-identical graph) each built their own copy
of every plan, tiles included. The registry keys on content instead:
`(graph_fingerprint, session device, plan key)`. The device is in the key
because a port plan is a closure over device tensors, so two sessions of
one graph on different devices must not share. Sessions consult it before
building; whoever builds first publishes, and later sessions (or later
`Engine`s over a rebuilt identical graph) reuse the plan with no build.

Entries hold `_Plan` handles (see `repro_torch.engine.session`), which
build on first resolve under their own lock, so a plan is built at most
once process-wide, not once per session; the build counts on the session
that published it. The CSR and the tiles the plans close over are
entries too (`_Shared` handles), so every session of a graph on a device
reads one copy of them.

The registry lives for the process. A session's `close()` takes back the
entries it published (a session that took one keeps it, and its device
tensors with it, until it closes too); tests that count builds reset it
with `reset_process_caches()` in an autouse fixture of their own file,
so counts do not depend on which tests ran before.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

_lock = threading.Lock()
_plans: dict = {}
_hits = 0


def registry_get(key) -> Optional[Any]:
    """The shared plan for `(graph_hash, device, plan_key)`, if published
    (a hit counts in `registry_stats`)."""
    global _hits
    with _lock:
        fn = _plans.get(key)
        if fn is not None:
            _hits += 1
        return fn


def registry_put(key, fn) -> Any:
    """Publish a plan; first writer wins (returns the winner)."""
    with _lock:
        return _plans.setdefault(key, fn)


def registry_drop(key, fn) -> None:
    """Take back `key` if it still holds `fn` (its publisher closing)."""
    with _lock:
        if _plans.get(key) is fn:
            del _plans[key]


def registry_size() -> int:
    with _lock:
        return len(_plans)


def registry_stats() -> dict:
    """Entries held and hits served since the last reset."""
    with _lock:
        return dict(plans=len(_plans), hits=_hits)


def registry_reset() -> None:
    """Drop every shared plan and zero the hits (tests / explicit
    invalidation)."""
    global _hits
    with _lock:
        _plans.clear()
        _hits = 0


def reset_process_caches() -> None:
    """Full runtime reset: registry, fingerprint memos, cache singletons.

    The disk cache itself is untouched, and so are the kernel libraries
    this process already loaded: this only drops in-process state of the
    runtime layer, returning it to a just-started view.
    """
    from repro_torch.runtime.artifact_cache import reset_artifact_caches
    from repro_torch.runtime.fingerprint import reset_fingerprint_memos
    registry_reset()
    reset_fingerprint_memos()
    reset_artifact_caches()

"""Disk-backed store for built kernel libraries and plan records.

The port's counterpart of the JAX package's `runtime/artifact_cache.py`.
What a JAX plan costs to make the first time is its trace and XLA
compile, which the reference serializes; what the port's cold start costs
is the `nvcc` build of the kernel libraries and the plans a graph uses
(its ELL tiles, hub split and step functions). A step function is a
closure over device tensors and is never pickled: the store keeps the
built libraries, and a record of each plan's key, from which a restarted
process rebuilds the plans before its first query (the session's
pre-warm).

Layout (under `RuntimeConfig.cache_dir`):

    <cache_dir>/kernels/<kernel_fingerprint>.so   one built library each
    <cache_dir>/plans/<plan_fingerprint>.plan     one plan record each

Each `.plan` file holds two consecutive pickles: a small metadata dict
(graph hash, plan key repr, environment facts; what `scan()` reads without
the rest), then the plan key itself (a tuple of strings, ints, bools and a
frozen `BFSConfig`), which pre-warm needs to rebuild the plan.

Guarantees:

* **atomic publish**: entries are written to a same-directory temporary
  file and `os.replace`d into place, so a crashed writer never publishes a
  half-written entry and concurrent processes see nothing or a whole file;
* **corruption-tolerant loads**: any failure while loading an entry (a
  truncated or garbage file, an unpicklable record, a library `dlopen`
  refuses or one without its entry point) evicts it, counts a corrupt
  eviction and reports a miss; the caller builds again. A library is
  never replaced by a plain version: with no valid entry, `kernels._build`
  runs `nvcc` from the repo's sources, or raises;
* **size-capped LRU eviction**: after each store, the least recently used
  entries of both kinds (mtime order; loads touch the mtime) are deleted
  until the total is back under `cache_max_bytes`;
* **environment invalidation for free**: both fingerprints fold in the
  environment (`runtime.fingerprint`), so stale entries are never looked
  up again and age out through the cap;
* **counters**: hits / misses / stores / store errors / evictions /
  corrupt evictions, cumulative load and store seconds, and per-entry
  hit / miss / load-time counts (`stats()`; `BFSServer.stats()` reports
  them per session).

`dlopen` caches by path: a library loaded once stays mapped in the
process, and opening the same path again returns the old handle. So a
second load of one path in a process (after an eviction and a rebuild)
opens a fresh hard link of the file instead (`_dlopen`); a loaded file is
never overwritten in place.
"""
from __future__ import annotations

import ctypes
import os
import pickle
import threading
import time
from typing import Any, Optional

from repro_torch.analysis.concurrency import make_lock
from repro_torch.runtime.faults import fault_point

PLANS_SUBDIR = "plans"
KERNELS_SUBDIR = "kernels"
SUFFIX = {PLANS_SUBDIR: ".plan", KERNELS_SUBDIR: ".so"}
_TMP_PREFIX = ".tmp-"

_dlopen_lock = threading.Lock()
_dlopened: dict = {}             # path -> times opened in this process


def _dlopen(path: str) -> ctypes.CDLL:
    """`ctypes.CDLL(path)`, through a fresh hard link when this process
    opened `path` before (`dlopen` would return the old handle)."""
    with _dlopen_lock:
        n = _dlopened.get(path, 0)
        _dlopened[path] = n + 1
    if n == 0:
        return ctypes.CDLL(path)
    alias = os.path.join(os.path.dirname(path),
                         f"{_TMP_PREFIX}load-{os.getpid()}-{n}-"
                         f"{os.path.basename(path)}")
    os.link(path, alias)
    try:
        return ctypes.CDLL(alias)
    finally:
        os.unlink(alias)


class ArtifactCache:
    """One directory of kernel libraries and plan records, with an LRU cap
    and counters."""

    def __init__(self, cache_dir: str, max_bytes: int):
        self.root = os.path.abspath(cache_dir)
        self.plans_dir = os.path.join(self.root, PLANS_SUBDIR)
        self.kernels_dir = os.path.join(self.root, KERNELS_SUBDIR)
        self.max_bytes = int(max_bytes)
        self._lock = make_lock("artifact_cache")
        self._counts = dict(hits=0, misses=0, stores=0, store_errors=0,
                            evictions=0, corrupt_evictions=0)
        self._load_s = 0.0
        self._store_s = 0.0
        self._entries: dict = {}     # fingerprint -> dict(hits, misses, ...)
        os.makedirs(self.plans_dir, exist_ok=True)
        os.makedirs(self.kernels_dir, exist_ok=True)

    # -------------------------------------------------------------- paths --

    def _path(self, fingerprint: str, kind: str = PLANS_SUBDIR) -> str:
        return os.path.join(self.root, kind, fingerprint + SUFFIX[kind])

    def temp_path(self, fingerprint: str, kind: str = KERNELS_SUBDIR) -> str:
        """A same-directory temporary name for a writer of `fingerprint`
        (this process and thread only), to `os.replace` into place."""
        return os.path.join(self.root, kind,
                            f"{_TMP_PREFIX}{fingerprint}.{os.getpid()}."
                            f"{threading.get_ident()}")

    def library_path(self, fingerprint: str) -> str:
        return self._path(fingerprint, KERNELS_SUBDIR)

    def __contains__(self, fingerprint: str) -> bool:
        return os.path.exists(self._path(fingerprint))

    def _listing(self, kinds=(PLANS_SUBDIR, KERNELS_SUBDIR)) -> list:
        """[(path, stat)] of every published entry of `kinds`."""
        out = []
        for kind in kinds:
            d = os.path.join(self.root, kind)
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                if name.startswith(_TMP_PREFIX) \
                        or not name.endswith(SUFFIX[kind]):
                    continue
                path = os.path.join(d, name)
                try:
                    out.append((path, os.stat(path)))
                except OSError:
                    pass
        return out

    def __len__(self) -> int:
        return len(self._listing())

    def total_bytes(self) -> int:
        return sum(st.st_size for _, st in self._listing())

    # ------------------------------------------------------------ counters --

    def _count(self, fingerprint: Optional[str] = None, *, load_s: float = 0.0,
               store_s: float = 0.0, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._counts[k] += v
            self._load_s += load_s
            self._store_s += store_s
            if fingerprint is not None:
                e = self._entries.setdefault(
                    fingerprint, dict(hits=0, misses=0, load_s=0.0))
                e["hits"] += deltas.get("hits", 0)
                e["misses"] += deltas.get("misses", 0)
                e["load_s"] += load_s

    # --------------------------------------------------------------- plans --

    def store(self, fingerprint: str, key, meta: dict) -> bool:
        """Write plan `key`'s record and atomically publish it.

        Never raises: a failure (an unpicklable key, a full disk) counts
        as `store_errors` and returns False; the caller keeps its plan.
        """
        t0 = time.perf_counter()
        tmp = self.temp_path(fingerprint, PLANS_SUBDIR)
        try:
            full_meta = dict(meta, created=time.time())
            with open(tmp, "wb") as f:
                pickle.dump(full_meta, f, protocol=pickle.HIGHEST_PROTOCOL)
                pickle.dump(key, f, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(fingerprint))
        except Exception:  # noqa: BLE001 — persistence is best-effort
            self._count(store_errors=1, store_s=time.perf_counter() - t0)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self._count(stores=1, store_s=time.perf_counter() - t0)
        self._evict_over_cap()
        return True

    def load(self, fingerprint: str) -> Optional[Any]:
        """The plan key a record holds, or None (miss / corrupt).

        A corrupt record (truncated, unpicklable) is evicted and reported
        as a miss, never fatal. A load touches the record's mtime (the LRU
        clock).
        """
        path = self._path(fingerprint)
        t0 = time.perf_counter()
        if not os.path.exists(path):
            self._count(fingerprint, misses=1)
            return None
        try:
            # Chaos hook inside the try: an injected cache_load fault takes
            # the corrupt-entry path (evict + miss).
            fault_point("cache_load", fingerprint=fingerprint)
            with open(path, "rb") as f:
                pickle.load(f)
                key = pickle.load(f)
        except Exception:  # noqa: BLE001 — corrupt entry: evict, miss
            self._evict(path, corrupt=True)
            self._count(fingerprint, misses=1,
                        load_s=time.perf_counter() - t0)
            return None
        self._touch(path)
        self._count(fingerprint, hits=1, load_s=time.perf_counter() - t0)
        return key

    def read_meta(self, fingerprint: str) -> Optional[dict]:
        """A record's metadata dict without the rest."""
        try:
            with open(self._path(fingerprint), "rb") as f:
                meta = pickle.load(f)
        except Exception:  # noqa: BLE001
            return None
        return meta if isinstance(meta, dict) else None

    def scan(self) -> list:
        """[(fingerprint, meta)] for every readable record (pre-warm's
        input). Unreadable metadata marks the record corrupt and evicts
        it."""
        out = []
        suffix = SUFFIX[PLANS_SUBDIR]
        for path, _st in sorted(self._listing((PLANS_SUBDIR,))):
            fp = os.path.basename(path)[:-len(suffix)]
            meta = self.read_meta(fp)
            if meta is None:
                self._evict(path, corrupt=True)
            else:
                out.append((fp, meta))
        return out

    # ----------------------------------------------------------- libraries --

    def store_library(self, fingerprint: str, built: str) -> bool:
        """Publish the library `nvcc` wrote to `built` (a `temp_path`) as
        `fingerprint`'s entry. Never raises: a failure counts as
        `store_errors` and returns False (`built` stays for the caller)."""
        t0 = time.perf_counter()
        try:
            os.replace(built, self.library_path(fingerprint))
        except OSError:
            self._count(store_errors=1, store_s=time.perf_counter() - t0)
            return False
        self._count(stores=1, store_s=time.perf_counter() - t0)
        self._evict_over_cap()
        return True

    def load_library(self, fingerprint: str,
                     symbol: str) -> Optional[ctypes.CDLL]:
        """`fingerprint`'s library, loaded, or None (miss / corrupt).

        A file that `dlopen` refuses (truncated, garbage) or that lacks
        the entry point `symbol` is evicted, counted as a corrupt eviction
        and reported as a miss.
        """
        path = self.library_path(fingerprint)
        t0 = time.perf_counter()
        if not os.path.exists(path):
            self._count(fingerprint, misses=1)
            return None
        try:
            fault_point("cache_load", fingerprint=fingerprint)
            lib = _dlopen(path)
            getattr(lib, symbol)
        except Exception:  # noqa: BLE001 — corrupt entry: evict, miss
            self._evict(path, corrupt=True)
            self._count(fingerprint, misses=1,
                        load_s=time.perf_counter() - t0)
            return None
        self._touch(path)
        self._count(fingerprint, hits=1, load_s=time.perf_counter() - t0)
        return lib

    # ------------------------------------------------------------- eviction --

    @staticmethod
    def _touch(path: str) -> None:
        try:
            os.utime(path)
        except OSError:
            pass

    def _evict(self, path: str, *, corrupt: bool = False) -> None:
        try:
            os.unlink(path)
            self._count(evictions=1, corrupt_evictions=int(corrupt))
        except OSError:
            pass

    def _evict_over_cap(self) -> None:
        """Delete least-recently-used entries until under `max_bytes`."""
        entries = [(st.st_mtime, st.st_size, path)
                   for path, st in self._listing()]
        total = sum(size for _, size, _ in entries)
        for _mtime, size, path in sorted(entries):
            if total <= self.max_bytes:
                break
            self._evict(path)
            total -= size

    # ---------------------------------------------------------------- stats --

    def stats(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            per_entry = {fp: dict(e) for fp, e in self._entries.items()}
            load_s, store_s = self._load_s, self._store_s
        requests = counts["hits"] + counts["misses"]
        listing = self._listing()
        return dict(
            dir=self.root, entries=len(listing),
            plan_entries=sum(p.startswith(self.plans_dir + os.sep)
                             for p, _ in listing),
            bytes=sum(st.st_size for _, st in listing),
            max_bytes=self.max_bytes,
            hit_rate=counts["hits"] / requests if requests else 0.0,
            load_s=load_s, store_s=store_s, per_entry=per_entry, **counts)


# ------------------------------------------------- per-directory singletons --

_caches_lock = threading.Lock()
_caches: dict = {}


def artifact_cache_for(runtime=None) -> Optional[ArtifactCache]:
    """The shared `ArtifactCache` for a config's cache dir (None = disabled).

    One instance per directory per process, so counters aggregate across
    every session using that directory (what `BFSServer.stats()` reports).
    """
    from repro_torch.runtime.config import get_runtime_config
    runtime = runtime or get_runtime_config()
    if not runtime.cache_enabled:
        return None
    key = (os.path.abspath(runtime.cache_dir), int(runtime.cache_max_bytes))
    with _caches_lock:
        cache = _caches.get(key)
        if cache is None:
            cache = _caches[key] = ArtifactCache(runtime.cache_dir,
                                                 runtime.cache_max_bytes)
        return cache


def reset_artifact_caches() -> None:
    """Test hook: drop per-directory cache instances (files stay on disk)."""
    with _caches_lock:
        _caches.clear()

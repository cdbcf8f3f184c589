"""Canonical content fingerprints: graphs, plans, the environment, kernels.

The port's counterpart of the JAX package's `runtime/fingerprint.py`. A
cohort plan (a step function over a graph's CSR and ELL tiles) is a pure
function of

    (graph CSR content, plan key, torch version, CUDA version,
     backend, device name and compute capability, device count)

so that tuple, hashed, names its record everywhere: the in-process
`plan_registry` keys on (graph hash, session device, plan key); the
`ArtifactCache` files a plan record under `plan_fingerprint`, which folds
the environment in, so a torch upgrade or another card silently misses
every stale record (it is never looked up again) instead of rebuilding a
plan for the wrong environment.

A built kernel library is named by `kernel_fingerprint`: its source
digest and `NVCC_FLAGS` (what `kernels._build.library_path` hashes), the
`nvcc --version` text and the compute capability of the card it is built
for. A toolkit or card change then misses, as a JAX upgrade does for the
reference. So a cached library is found only where a toolkit is: without
`nvcc` the text reads "none", every library misses, and the build raises.

The plan key is the `GraphSession.executable` key: a tuple of strings,
ints, bools and the frozen `BFSConfig`, whose `repr` is deterministic and
spells out every field (adding a config field changes every fingerprint).

Graph hashing reads the whole CSR (`indptr` + `indices` bytes) with
blake2b, once per graph object per process (memoized with a weakref, so a
dropped graph does not pin its entry). The environment is read lazily,
once per process and backend, never at import or config parsing: a CPU
session never initializes CUDA.
"""
from __future__ import annotations

import hashlib
import subprocess
import threading
import weakref

import numpy as np

_lock = threading.Lock()
_graph_hash_memo: dict = {}      # id(graph) -> (hexdigest, weakref.ref)
_env_memo: dict = {}             # (backend, index) -> dict
_toolkit_memo: list = []         # [nvcc --version text] once read


def graph_fingerprint(graph) -> str:
    """Content hash of a `Graph`'s CSR arrays (memoized per graph object).

    Two separately built but identical graphs (same generator and seed, or
    one loaded from the other's arrays) hash equal: this is what lets
    sessions share plans across graph objects, not just references.
    """
    key = id(graph)
    with _lock:
        got = _graph_hash_memo.get(key)
        if got is not None:
            return got[0]
    h = hashlib.blake2b(digest_size=16)
    h.update(str(int(graph.num_vertices)).encode())
    h.update(b"|")
    h.update(np.ascontiguousarray(graph.indptr).view(np.uint8))
    h.update(b"|")
    h.update(np.ascontiguousarray(graph.indices).view(np.uint8))
    digest = h.hexdigest()
    with _lock:
        try:
            ref = weakref.ref(graph,
                              lambda _r, _k=key: _graph_hash_memo.pop(_k, None))
        except TypeError:         # non-weakrefable graph stand-in: no memo
            return digest
        _graph_hash_memo[key] = (digest, ref)
    return digest


def environment_fingerprint(device=None) -> dict:
    """The facts that invalidate a plan record, for `device`'s backend
    (None: CUDA when available, else the CPU).

    A CPU session reads `backend="cpu"` and never initializes CUDA; a CUDA
    one reads its card's name and capability and the card count.
    Computed once per process and device.
    """
    import torch
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    index = dev.index or 0
    with _lock:
        got = _env_memo.get((dev.type, index))
        if got is not None:
            return dict(got)
    env = dict(torch_version=torch.__version__,
               cuda_version=str(torch.version.cuda), backend=dev.type,
               device_kind="cpu", capability="", n_devices=1)
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(index)
        env.update(device_kind=torch.cuda.get_device_name(index),
                   capability=f"{major}.{minor}",
                   n_devices=torch.cuda.device_count())
    with _lock:
        _env_memo.setdefault((dev.type, index), env)
    return dict(env)


def canonical_plan_key(key) -> str:
    """Deterministic string form of a session executable key."""
    return repr(key)


def plan_fingerprint(graph_hash: str, key, env: dict) -> str:
    """Disk identity of one plan record (hex, stable across runs): the
    graph, the key and every field of `env` (`environment_fingerprint`)."""
    parts = [graph_hash, canonical_plan_key(key)]
    parts += [f"{k}={env[k]}" for k in sorted(env)]
    return hashlib.blake2b("\x1f".join(parts).encode(),
                           digest_size=20).hexdigest()


def toolkit_version() -> str:
    """`nvcc --version`'s text (read once; "none" without a toolkit)."""
    with _lock:
        if _toolkit_memo:
            return _toolkit_memo[0]
    from repro_torch.kernels import _build
    try:
        text = subprocess.run([_build._nvcc(), "--version"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        text = "none"
    with _lock:
        if not _toolkit_memo:
            _toolkit_memo.append(text)
        return _toolkit_memo[0]


def device_capability(device=None) -> str:
    """Compute capability of CUDA `device` (an index or a device; None:
    the current card), "none" for a CPU device or without CUDA."""
    import torch
    if isinstance(device, int):
        device = torch.device("cuda", device)
    elif device is not None:
        device = torch.device(device)
    if (device is not None and device.type != "cuda") \
            or not torch.cuda.is_available():
        return "none"
    major, minor = torch.cuda.get_device_capability(device)
    return f"{major}.{minor}"


def kernel_fingerprint(name: str, device=None) -> str:
    """Cache identity of library `name`'s build for `device` (None: the
    current card): its source digest and flags (as in
    `_build.library_path`), the toolkit and the card's capability."""
    from repro_torch.kernels import _build
    h = hashlib.blake2b(digest_size=20)
    h.update(_build.source_digest(name).encode())
    h.update(b"\x1f" + toolkit_version().encode())
    h.update(b"\x1f" + device_capability(device).encode())
    return f"{name}-{h.hexdigest()}"


def reset_fingerprint_memos() -> None:
    """Test hook: drop the graph-hash, environment and toolkit memos."""
    with _lock:
        _graph_hash_memo.clear()
        _env_memo.clear()
        _toolkit_memo.clear()

"""Build the CUDA kernels with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Missing
libraries are built together, one `nvcc` process per source, started at
once, under one process-wide lock (so two callers never write the same
temporary file). `STATS["compiles"]` counts the `nvcc` runs of this
process (the port's counterpart of the JAX package's trace count).

Where the libraries live:

* without a cache dir, in `build/repro_torch/` at the repo root, named by
  a hash of the source and flags, so an edited source rebuilds at its
  next use and a stale library is never loaded (delete the directory to
  force a rebuild);
* with one (`RuntimeConfig.cache_dir`; `build_all(cache=...)`, or the
  process config when a launch loads first), in the artifact cache's
  `kernels/<kernel_fingerprint>.so` (`runtime.artifact_cache`): the
  fingerprint adds the `nvcc --version` text and the capability of the
  card it is built for, so a toolkit or card change misses (and a
  process without `nvcc` never hits). A load that fails (a truncated or
  garbage file, a missing entry point) evicts the entry and compiles the
  source again from `csrc/`. Nothing gives way to a plain version: with
  no valid library and no `nvcc`, the build raises.

Nothing here runs at import: the first kernel launch (or `build_all()`)
builds. Pointer arguments and the stream are `c_void_p`; sizes `c_int64`;
scalars of the arithmetic `c_float`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("bottomup", "decode_attn", "frontier_fused", "topdown")
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_F = ctypes.c_float
# C entry point and argument types, by library unless LIBRARY says
# otherwise (see each source's footer).
ENTRY_POINTS = {
    "bottomup": ("repro_bottomup_batch",
                 [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _I,
                  _I64, _I64, _I, _I, _P]),
    "bottomup_resident": ("repro_bottomup_resident", [_I, _P, _I]),
    "bottomup_attributes": ("repro_bottomup_attributes", [_I, _I, _P, _I]),
    "decode_attn": ("repro_decode_attention",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                     _I64, _I64, _I64, _F, _F, _I, _I, _P]),
    "decode_attn_resident": ("repro_decode_attention_resident",
                             [_I64, _I64, _I, _P, _I]),
    "decode_attn_attributes": ("repro_decode_attention_attributes",
                               [_I64, _I64, _I, _I64, _P, _I]),
    "frontier_fused": ("repro_frontier_fused_batch",
                       [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64,
                        _I, _P]),
    "frontier_fused_resident": ("repro_frontier_fused_resident",
                                [_I, _I, _P, _I]),
    "frontier_fused_attributes": ("repro_frontier_fused_attributes",
                                  [_I, _I, _P, _I]),
    "topdown": ("repro_topdown_batch",
                [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _P]),
    "topdown_push": ("repro_topdown_push",
                     [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                      _P]),
    "topdown_attributes": ("repro_topdown_attributes", [_I, _I, _P, _I]),
}
LIBRARY = {"decode_attn_resident": "decode_attn",
           "bottomup_resident": "bottomup", "topdown_push": "topdown",
           "frontier_fused_resident": "frontier_fused",
           "bottomup_attributes": "bottomup",
           "decode_attn_attributes": "decode_attn",
           "frontier_fused_attributes": "frontier_fused",
           "topdown_attributes": "topdown"}

_lock = threading.RLock()      # builds and first loads
_functions: dict = {}          # entry point name -> ctypes function
_libraries: dict = {}          # library name -> loaded ctypes.CDLL
# This process's builds and loads: nvcc runs and their seconds (the
# parallel build's wall), libraries loaded from the artifact cache and
# those seconds, and where each loaded library came from ("build_dir",
# "cache", "compiled").
STATS: dict = dict(compiles=0, compile_s=0.0, cache_loads=0,
                   cache_load_s=0.0, sources={})


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels build only where the CUDA toolkit is")
    return path


def source_digest(name: str) -> str:
    """sha256 of library `name`'s source and the flags it builds with."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_digest(name)[:16]}.so"


def build_all(names=SOURCES, cache=None, device=None) -> float:
    """Make every library in `names` ready; seconds taken.

    Without `cache` (an `ArtifactCache`): build the missing ones into
    `BUILD_DIR` in parallel (a launch loads them from there). With one:
    load each library this process has not loaded from the cache entry
    for `device`'s card (None: the current one), compiling the misses in
    parallel into it.
    """
    with _lock:
        if cache is None:
            return _build_missing(names)
        return _load_cached(names, cache, device)


def _compile(jobs, publish) -> None:
    """Run one `nvcc` per (name, output path) of `jobs`, all at once;
    `publish(name, path)` each that succeeds, then raise if any failed."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in jobs:
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            Path(out).unlink(missing_ok=True)
            continue
        publish(name, out)
    STATS["compiles"] += len(jobs)
    STATS["compile_s"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _build_missing(names) -> float:
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _compile([(n, library_path(n).with_suffix(f".{os.getpid()}.tmp"))
              for n in todo],
             lambda name, tmp: os.replace(tmp, library_path(name)))
    return time.perf_counter() - t0


def _load_cached(names, cache, device) -> float:
    from repro_torch.runtime.artifact_cache import _dlopen
    from repro_torch.runtime.fingerprint import kernel_fingerprint
    t0 = time.perf_counter()
    todo = [n for n in names if n not in _libraries]
    fps = {n: kernel_fingerprint(n, device) for n in todo}
    missing = []
    for n in todo:
        t1 = time.perf_counter()
        lib = cache.load_library(fps[n], ENTRY_POINTS[n][0])
        if lib is None:
            missing.append(n)
            continue
        _libraries[n] = lib
        STATS["sources"][n] = "cache"
        STATS["cache_loads"] += 1
        STATS["cache_load_s"] += time.perf_counter() - t1

    def publish(name, tmp):
        # a store that fails leaves the library at `tmp`: load it there
        path = (cache.library_path(fps[name])
                if cache.store_library(fps[name], tmp) else str(tmp))
        _libraries[name] = _dlopen(path)
        STATS["sources"][name] = "compiled"
        if path == str(tmp):
            os.unlink(tmp)
    if missing:
        _compile([(n, cache.temp_path(fps[n])) for n in missing], publish)
    return time.perf_counter() - t0 if todo else 0.0


def _library(name: str, device):
    """Library `name`, loaded: from this process's loads, else through the
    process config's cache (its entry for `device`'s card), else built
    into `BUILD_DIR`."""
    lib = _libraries.get(name)
    if lib is None:
        from repro_torch.runtime.artifact_cache import artifact_cache_for
        cache = artifact_cache_for()
        build_all(cache=cache, device=device)
        lib = _libraries.get(name)
        if lib is None:
            lib = _libraries[name] = ctypes.CDLL(str(library_path(name)))
            STATS["sources"][name] = "build_dir"
    return lib


def function(name: str, device=None):
    """C entry point `name`, its library built (for `device`'s card, an
    index; None: the current one) and loaded on first use."""
    fn = _functions.get(name)
    if fn is None:
        with _lock:
            fn = _functions.get(name)
            if fn is None:
                symbol, argtypes = ENTRY_POINTS[name]
                fn = getattr(_library(LIBRARY.get(name, name), device),
                             symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _functions[name] = fn
    return fn


def require(t, dtype, ndim: int, what: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and rank."""
    if not t.is_cuda or t.dtype != dtype or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"{what}: want a contiguous CUDA {dtype} tensor of rank {ndim}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def launch(name: str, *args, device, stream) -> None:
    """Call library `name`'s entry point; raise if the launch was refused.

    `args` are the kernel's pointers and sizes; the device index and the
    stream handle (`torch.cuda.Stream.cuda_stream`) go last.
    """
    err = function(name, device)(*args, device, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_POINTS[name][0]} launch failed: "
                           f"cudaError_t {err}")

"""Build the CUDA kernels with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The libraries go
to `build/repro_torch/` at the repo root, named by a hash of the source, so
an edited source rebuilds at its next use and a stale library is never
loaded. Missing libraries are built together, one `nvcc` process per
source, started at once, under one process-wide lock (so two callers never
write the same temporary file). Delete `build/repro_torch/` to force a
rebuild.

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
    "decode_attn": ("repro_decode_attention",
                    [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                     _I64, _I64, _F, _F, _I, _I, _P]),
    "decode_attn_resident": ("repro_decode_attention_resident",
                             [_I64, _I64, _I, _P, _I]),
    "frontier_fused": ("repro_frontier_fused_batch",
                       [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I64,
                        _I, _P]),
    "frontier_fused_resident": ("repro_frontier_fused_resident",
                                [_I, _I, _P, _I]),
    "topdown": ("repro_topdown_batch",
                [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I, _I, _P]),
    "topdown_push": ("repro_topdown_push",
                     [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I,
                      _P]),
}
LIBRARY = {"decode_attn_resident": "decode_attn",
           "bottomup_resident": "bottomup", "topdown_push": "topdown",
           "frontier_fused_resident": "frontier_fused"}

_lock = threading.RLock()      # build_all and first loads
_functions: dict = {}


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Build every missing library in `names` in parallel; seconds taken."""
    with _lock:
        return _build_missing(names)


def _build_missing(names) -> float:
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str):
    """C entry point `name`, its library built and loaded on first use."""
    fn = _functions.get(name)
    if fn is None:
        with _lock:
            fn = _functions.get(name)
            if fn is None:
                build_all()
                symbol, argtypes = ENTRY_POINTS[name]
                lib = library_path(LIBRARY.get(name, name))
                fn = getattr(ctypes.CDLL(str(lib)), symbol)
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
    err = function(name)(*args, device, stream)
    if err != 0:
        raise RuntimeError(f"{ENTRY_POINTS[name][0]} launch failed: "
                           f"cudaError_t {err}")

"""Checkpointing: atomic step snapshots with keep-k GC (the JAX package's
`checkpoint/checkpoint.py`, with its on-disk contract).

Layout:
  <dir>/step_000123/arrays.npz     flattened 'path/to/leaf' -> array
  <dir>/step_000123/manifest.json  step, leaf paths, dtypes, metadata
  <dir>/LATEST                     atomic pointer (rename) -> step_000123

A tree is nested tuples, lists and dicts whose leaves are tensors (or
numpy arrays); an `nn.Module` in it stands for its `named_parameters()`.
A training run saves `(model, opt_state)`: leaves `0/<param name>`,
`1/m/<name>`, `1/v/<name>` and `1/step`. numpy has no bfloat16 (and
`ml_dtypes` is not assumed), so a bf16 tensor is stored as its int16 bits
with "bfloat16" as its manifest dtype, and viewed back on restore.
Restore writes a module's parameters in place (on the module's device);
every other leaf comes back as a new tensor on its prototype's device.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import time
from typing import Optional

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of `tree`, depth first, in its order."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array npz stores and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | pathlib.Path, step: int, tree,
         metadata: Optional[dict] = None, keep: int = 3) -> pathlib.Path:
    """Atomically write a checkpoint; GC to the newest `keep` steps."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = ckpt_dir / f".tmp_{name}_{int(time.time() * 1e6)}"
    tmp.mkdir()
    arrays, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {"step": step, "keys": sorted(arrays), "dtypes": dtypes,
                "metadata": metadata or {}, "written_at": time.time()}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    final = ckpt_dir / name
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                                   # atomic publish
    latest_tmp = ckpt_dir / f".LATEST_{int(time.time() * 1e6)}"
    latest_tmp.write_text(name)
    latest_tmp.rename(ckpt_dir / "LATEST")              # atomic pointer swap
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ptr = ckpt_dir / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (ckpt_dir / name / "manifest.json").exists():
        # torn write of the pointed-to dir: fall back to newest complete
        steps = sorted(p.name for p in ckpt_dir.glob("step_*")
                       if (p / "manifest.json").exists())
        if not steps:
            return None
        name = steps[-1]
    return int(name.split("_")[1])


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def restore(ckpt_dir: str | pathlib.Path, tree_like,
            step: Optional[int] = None):
    """Load into the structure of `tree_like`; returns (tree, step,
    metadata). Raises FileNotFoundError when there is no checkpoint,
    KeyError for a leaf the checkpoint lacks, ValueError for a shape that
    differs."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}

    def load(node, prefix):
        if isinstance(node, nn.Module):
            with torch.no_grad():
                for name, p in node.named_parameters():
                    p.copy_(leaf(prefix + name, p))
            return node
        if isinstance(node, dict):
            return {k: load(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(load(v, f"{prefix}{i}/")
                              for i, v in enumerate(node))
        return leaf(prefix[:-1], node)

    def leaf(key, proto):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(proto.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(proto.shape)}")
        t = _from_numpy(arr, manifest["dtypes"].get(key, ""))
        return t.to(proto.device) if isinstance(proto, torch.Tensor) else t

    return load(tree_like, ""), step, manifest["metadata"]

"""Checkpointing: per-leaf .npy files + JSON manifest, atomic directory
rename; the JAX package's ``checkpoint/ckpt.py`` over trees of tensors.

Layout:
    <dir>/step_000000123.tmp/...   (written)
    <dir>/step_000000123/          (atomic rename on completion)
        MANIFEST.json           {step, leaves: {path: {file, shape, dtype}}}
        leaf files  <flattened__key__path>.npy

A tree is nested dicts (lists and tuples by index) of tensors; a leaf's
key is its path joined by "/", so a train state's keys are
``params/<name>``, ``opt/m/<name>``, ``opt/v/<name>``, ``opt/step`` and
``ef_err/<name>``.  numpy has no bfloat16: a bf16 leaf is stored as its
``uint16`` bits, with ``"dtype": "bfloat16"`` in the manifest, and
restored bit for bit.  ``restore`` writes each leaf into the matching
tensor of a like-shaped tree, in place: on that tensor's device and in
its dtype, so a model's parameters restore without a second copy.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "list_steps"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, sub in items:
        flat.update(_flatten(sub, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(leaf) -> tuple:
    """(array, manifest dtype) of one leaf."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree) -> str:
    """Write a checkpoint; returns the final path.  Atomic: a crash
    mid-write leaves only a .tmp directory that restore ignores."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fn = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {
            "file": fn,
            "shape": list(arr.shape),
            "dtype": dtype,
        }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "MANIFEST.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like_tree):
    """Load checkpoint ``step`` into ``like_tree`` (the same structure,
    tensors of the saved shapes), leaf by leaf in place; returns it."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for key, like in _flatten(like_tree).items():
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        src = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            src = src.view(torch.bfloat16)
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)}, "
                             f"expected {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(src)
    return like_tree

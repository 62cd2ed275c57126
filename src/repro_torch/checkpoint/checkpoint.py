"""Atomic, elastic checkpointing in the reference's on-disk format.

Format: one directory per step, one ``.npy`` file per flattened tree
leaf plus a ``manifest.json`` (paths, shapes, dtypes, step, extra state).
Writes go to ``<dir>.tmp`` then ``os.replace``: a crash mid-save never
corrupts the latest checkpoint, which together with the deterministic
data pipeline gives exact crash/restart semantics.  A bfloat16 leaf is
stored as its 16-bit words (``uint16``) under the logical dtype
``bfloat16``, as the reference stores it, so a checkpoint written by
either package loads in the other.

Elasticity: leaves are saved as whole host arrays, so a restore may
place them on any device (``device=``, the card unless given).

Async: ``CheckpointManager(async_save=True)`` copies every leaf to the
host before ``save`` returns (the train step updates its tensors in
place), then writes on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.models.common import flatten, unflatten

_MANIFEST = "manifest.json"


def _sanitize(path: str) -> str:
    return path.replace("/", "__")


def _leaves(tree) -> list:
    """Leaves of a list / tuple / dict tree in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def enumerate_tree(tree) -> Dict[str, Any]:
    return {f"leaf_{i}": leaf for i, leaf in enumerate(_leaves(tree))}


def _host_array(leaf):
    """(C-contiguous numpy array as stored, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:      # numpy has no bf16: its words
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write atomically to <directory>/step_<n>; returns the final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = flatten(tree) if isinstance(tree, dict) else enumerate_tree(tree)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in flat.items():
        arr, logical_dtype = _host_array(leaf)
        fname = _sanitize(path) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][path] = {"file": fname,
                                    "shape": list(arr.shape),
                                    "dtype": logical_dtype}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, name, _MANIFEST)):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None,
                    device=None):
    """Load (tree, step, extra), each leaf a tensor on ``device`` (the
    card unless given), moved there one leaf at a time."""
    dev = engine.resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat = {}
    for lpath, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(path, meta["file"]))
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        flat[lpath] = t.to(dev)
    return unflatten(flat), manifest["step"], manifest.get("extra", {})


def _host_copy(tree):
    """A host snapshot that later in-place updates of ``tree`` cannot
    reach, dict keys sorted as ``jax.tree.map`` sorts them."""
    if isinstance(tree, dict):
        return {k: _host_copy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async background
    save.  A failed background save raises from the next ``wait``."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None):
        host = _host_copy(tree)     # before the next step mutates tree

        def work():
            save_checkpoint(self.directory, step, host, extra)
            self._gc()

        if self.async_save:
            self.wait()

            def guarded():
                try:
                    work()
                except Exception as e:   # re-raised by wait()
                    self._error = e

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, device=None, step: Optional[int] = None):
        self.wait()
        return load_checkpoint(self.directory, step, device)

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        all_steps = sorted(
            int(n[5:]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in all_steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

"""Checkpoints of flat dictionaries of NumPy arrays: atomic, resumable.

Layout (the JAX package's, so either package reads the other's sweep
checkpoints): ``<dir>/step_<N>/`` with one ``leaf_<i>.npy`` per array, in
sorted key order, plus ``manifest.json`` (keys, shapes, dtypes, extra
metadata).  Writes go to a temporary directory that is atomically renamed,
so a crash mid-save never corrupts the latest checkpoint; ``latest_step``
only sees manifests that finished.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

_MANIFEST = "manifest.json"


def save(directory: str, step: int, tree: Mapping[str, np.ndarray],
         extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic synchronous save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, key in enumerate(sorted(tree)):
        arr = np.asarray(tree[key])
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, tree_like: Mapping[str, Any],
            step: Optional[int] = None
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Restore the arrays saved under the keys of ``tree_like``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    files = {leaf["key"]: leaf["file"] for leaf in manifest["leaves"]}
    if set(files) != set(tree_like):
        raise ValueError(f"checkpoint holds {sorted(files)}, tree expects "
                         f"{sorted(tree_like)}")
    restored = {key: np.load(os.path.join(path, files[key]))
                for key in sorted(tree_like)}
    return restored, manifest["extra"] | {"step": manifest["step"]}


def retain(directory: str, keep: int = 3) -> None:
    """Garbage-collect all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(directory, n, _MANIFEST)))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)

"""Checkpoints of flat dictionaries of arrays: atomic, async-capable.

Layout (the JAX package's, so either package reads the other's sweep and
train checkpoints): ``<dir>/step_<N>/`` with one ``leaf_<i>.npy`` per
array, in sorted key order (the JAX package's flattening order of a nested
tree whose paths are these keys), plus ``manifest.json`` (keys, shapes,
dtypes, extra metadata).  Values may be NumPy arrays or tensors on any
device; bfloat16, which NumPy cannot hold, is stored as its uint16 bits
with the logical dtype ``"bfloat16"`` in the manifest, as the JAX package
stores it.  Writes go to a temporary directory that is atomically renamed,
so a crash mid-save never corrupts the latest checkpoint; ``latest_step``
only sees manifests that finished.  ``AsyncCheckpointer`` writes on a
worker thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _encode(value) -> Tuple[np.ndarray, str]:
    """A host array to write and its logical dtype."""
    if torch.is_tensor(value):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        value = t.numpy()
    arr = np.asarray(value)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, logical: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if logical == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


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
        arr, logical = _encode(tree[key])
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": logical})
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
            step: Optional[int] = None, shardings: Optional[Mapping[str, Any]] = None
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Restore the arrays saved under the keys of ``tree_like``.

    ``shardings``: optional mapping of the same keys to ``(mesh, spec)``
    (a ``DeviceMesh`` and a ``distributed.sharding`` spec) -- each leaf is
    then a DTensor on that mesh, every rank keeping its own shard of the
    saved whole array, whatever mesh wrote it (an elastic reshard)."""
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
    if shardings is not None:
        from repro_torch.distributed.place import distribute

        restored = {key: distribute(torch.from_numpy(arr), shardings[key][1],
                                    shardings[key][0])
                    for key, arr in restored.items()}
    return restored, manifest["extra"] | {"step": manifest["step"]}


def restore_tensors(directory: str, step: Optional[int] = None
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Every leaf of a checkpoint as a CPU tensor (bfloat16 leaves decoded),
    keyed by path, with the manifest's extra metadata and step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    tensors = {leaf["key"]: _decode(np.load(os.path.join(path, leaf["file"])),
                                    leaf["dtype"])
               for leaf in manifest["leaves"]}
    return tensors, manifest["extra"] | {"step": manifest["step"]}


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


class AsyncCheckpointer:
    """Non-blocking saves on a worker thread (one in flight at a time; the
    training loop never stalls on I/O).  ``save`` copies the tree to host
    memory before it returns, so the caller may update its tensors in place
    right after."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Mapping[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = {k: (v.detach().to("cpu", copy=True) if torch.is_tensor(v)
                         else np.array(v)) for k, v in tree.items()}

        def work():
            try:
                save(self.directory, step, host_tree, extra)
                retain(self.directory, self.keep)
            except Exception as exc:  # noqa: BLE001 - raised again by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

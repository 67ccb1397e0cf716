"""Carry state across from the JAX package.

The sweep path's state is profile suites and machine populations.  Both
packages pack them the same way -- one float64 array per field -- so
carrying a packed suite or population across is a matter of handing those
arrays over.  ``WorkloadProfile`` JSON written by the JAX package loads
unchanged through ``WorkloadProfile.load``.

The model stack's state is its weights.  Both packages keep the same
parameter layout, so ``model_from_jax`` builds the port's model from the
JAX package's ``init_model`` tree (as NumPy arrays) by copying, for every
family: each stacked leaf becomes a list of per-layer trees.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.core.sweep import SWEEP_PARAMS, MachineBatch, ProfileBatch
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import Model

PROFILE_FIELDS = ("flops", "mem_bytes", "collective_bytes",
                  "pod_collective_bytes", "model_flops", "num_devices")


def profiles_from_numpy(names: Sequence[str],
                        fields: Mapping[str, np.ndarray]) -> ProfileBatch:
    """A ``ProfileBatch`` from packed per-field arrays (``PROFILE_FIELDS``).

    The arrays are taken as they are; each app also gets a minimal
    ``WorkloadProfile`` (for per-cell reports) whose packing gives the same
    arrays back.
    """
    cols = {f: np.array(fields[f], dtype=np.float64) for f in PROFILE_FIELDS}
    profiles = [
        WorkloadProfile(
            name=name,
            num_devices=int(cols["num_devices"][i]),
            flops=float(cols["flops"][i]),
            bytes_accessed=float(cols["mem_bytes"][i]),
            hbm_bytes=float(cols["mem_bytes"][i]),
            collective_bytes={"all-reduce": float(cols["collective_bytes"][i])},
            pod_collective_bytes=float(cols["pod_collective_bytes"][i]),
            model_flops=float(cols["model_flops"][i]),
        )
        for i, name in enumerate(names)]
    return ProfileBatch(names=list(names), profiles=profiles, **cols)


def machines_from_numpy(names: Sequence[str],
                        fields: Mapping[str, np.ndarray]) -> MachineBatch:
    """A ``MachineBatch`` from packed per-field arrays (``SWEEP_PARAMS``)."""
    return MachineBatch(
        names=list(names),
        **{f: np.array(fields[f], dtype=np.float64) for f in SWEEP_PARAMS})


def model_from_jax(cfg: ModelConfig, params: Mapping, device="cuda") -> Model:
    """The port's model from the JAX package's ``init_model`` parameter tree
    for ``cfg``, its leaves as NumPy arrays (``jax.tree.map(np.asarray,
    params)``).  The stacks -- ``layers``, the hybrid's ``groups`` (their
    ``rec`` leaves stacked ``(n_groups, 2, ...)``) and ``tail``, the audio
    family's ``enc_layers`` and ``dec_layers`` -- are split into per-layer
    trees; every other leaf is taken whole.  Each leaf is copied to
    ``device`` in ``cfg.param_dtype``."""
    dev = resolve_device(device)
    dt = dtype_of(cfg.param_dtype)

    def tensors(tree, i=()):
        if isinstance(tree, Mapping):
            return {k: tensors(v, i) for k, v in tree.items()}
        a = np.array(tree[i], dtype=np.float32)
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    def n_of(tree):
        leaf = tree
        while isinstance(leaf, Mapping):
            leaf = next(iter(leaf.values()))
        return np.shape(leaf)[0]

    out = {}
    for name, tree in params.items():
        if name in ("layers", "tail", "enc_layers", "dec_layers"):
            out[name] = [tensors(tree, (i,)) for i in range(n_of(tree))]
        elif name == "groups":
            out[name] = [{"rec": [tensors(tree["rec"], (g, j)) for j in range(2)],
                          "att": tensors(tree["att"], (g,))}
                         for g in range(n_of(tree))]
        else:
            out[name] = tensors(tree)
    return Model(cfg, out)

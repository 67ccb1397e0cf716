"""Carry state across from the JAX package.

The system has no weights: its state is profile suites and machine
populations.  Both packages pack them the same way -- one float64 array per
field -- so carrying a packed suite or population across is a matter of
handing those arrays over.  ``WorkloadProfile`` JSON written by the JAX
package loads unchanged through ``WorkloadProfile.load``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.sweep import SWEEP_PARAMS, MachineBatch, ProfileBatch

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

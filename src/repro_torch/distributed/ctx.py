"""Activation-sharding context (the JAX package's ``repro/distributed/ctx.py``).

Model code calls ``constrain(x, kind)`` at block boundaries; the launcher
installs the active rules (``sharding.activation_rules``: a spec per
activation kind and the mesh) with the ``use_rules`` context manager.
Outside any context ``constrain`` is the identity, so single-device runs
need no mesh.  Inside one it redistributes a DTensor to the rule's
placements on the rules' ``DeviceMesh``, where
``jax.lax.with_sharding_constraint`` asks XLA for the same layout; a plain
tensor passes through.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

_state = threading.local()


def _rules() -> Optional[Dict[str, object]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, object]):
    """rules: {"acts": spec, "logits": spec, ..., "shmap": {...}}."""
    prev = _rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def shmap_info():
    """(dp_axes, tp_axis, mesh) for explicit local regions, or None."""
    rules = _rules()
    if rules and "shmap" in rules:
        info = rules["shmap"]
        return info["dp"], info["tp"], info["mesh"]
    return None


def data_parallel_groups() -> int:
    """Number of data-parallel shards the launcher runs with (used by the
    capacity-MoE dispatch to keep routing device-local); 1 outside a mesh."""
    rules = _rules()
    if rules and "dp_groups" in rules:
        return int(rules["dp_groups"])  # type: ignore[arg-type]
    return 1


def constrain(x, kind: str):
    """``x`` redistributed to the active rules' layout for ``kind`` (a
    DTensor), else ``x`` itself."""
    rules = _rules()
    if not rules or kind not in rules:
        return x
    spec = rules[kind]
    if isinstance(spec, (int, dict)):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or len(spec) > x.ndim:
        return x
    from repro_torch.distributed.sharding import placements

    want = placements(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)

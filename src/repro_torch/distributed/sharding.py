"""Logical-axis -> mesh sharding rules (DP / TP / EP / ZeRO / FSDP / pod).

The JAX package's ``repro/distributed/sharding.py``, rule for rule.
Models annotate parameters with logical axes ("embed", "heads", "mlp",
"experts", "vocab", ...).  A sharding *variant* maps logical axes onto mesh
axes; divisibility is checked per tensor, replicating any axis that does not
divide evenly (e.g. kv_heads=2 on a 16-way model axis).

Variants (the software-densification DSE axis):
  tp      -- baseline: TP over "model" (heads/mlp/vocab), DP over pod+data;
             optimizer states follow parameters.
  zero1   -- tp + optimizer states additionally sharded over "data"
             (ZeRO stage 1).
  fsdp    -- zero1 + parameters themselves sharded over "data" on their
             largest replicated dim (ZeRO-3 / FSDP: parameters are gathered
             per layer where they are used).

A spec is a plain tuple with one entry per tensor dimension: a mesh-axis
name, a tuple of names (the dimension split over several axes, major
first) or ``None``, entry for entry the JAX package's ``PartitionSpec``.
``placements(spec, mesh)`` turns one into DTensor placements on a
``DeviceMesh``.  A "mesh" here is a ``DeviceMesh`` or a mapping of axis
name to size (``mesh_shape``), so the rules can be asked about a
production mesh without a process group of its size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

SHARDING_VARIANTS = ("tp", "zero1", "fsdp")

#: logical axis -> mesh axis for tensor-parallel dims
_TP_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",   # EP: experts over model axis when divisible,
                          # else TP falls through to the "mlp" dim
    "batch": "data",      # cache/batch leading dims
}

#: logical axes never sharded
_REPLICATED = {"layers", "head_dim", "conv", "state", "positions",
               "mlp_block", None}

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    variant: str = "tp"
    multi_pod: bool = False

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or of a mapping of sizes."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh)[name]


def spec_for_tensor(
    shape: Sequence[int],
    axes: Sequence[Optional[str]],
    mesh,
    sc: ShardingConfig,
    *,
    fsdp_this: bool = False,
) -> Spec:
    """The spec of one tensor given its logical axes."""
    assert len(shape) == len(axes), (shape, axes)
    sizes = mesh_shape(mesh)
    entries: list = []
    used = set()
    model_wanted_failed = False
    for dim, ax in zip(shape, axes):
        mesh_ax: Optional[str] = None
        if ax == "batch":
            # batch dims shard over the full data-parallel hierarchy
            total = 1
            for a in sc.data_axes:
                total *= sizes[a]
            if dim % total == 0 and not used.intersection(sc.data_axes):
                entries.append(sc.data_axes if len(sc.data_axes) > 1
                               else sc.data_axes[0])
                used.update(sc.data_axes)
                continue
            entries.append(None)
            continue
        if ax not in _REPLICATED:
            cand = _TP_RULES.get(ax)
            if cand is not None and cand not in used:
                if dim % sizes[cand] == 0:
                    mesh_ax = cand
                elif cand == "model":
                    model_wanted_failed = True
        entries.append(mesh_ax)
        if mesh_ax is not None:
            used.add(mesh_ax)

    if model_wanted_failed and "model" not in used:
        # PaLM-style fallback: when kv_heads (MQA/GQA < TP degree) cannot be
        # sharded, shard the head_dim instead -- keeps KV caches and k/v
        # projections distributed rather than replicated TP-degree times.
        for i, (dim, ax) in enumerate(zip(shape, axes)):
            if (ax == "head_dim" and entries[i] is None
                    and dim % sizes["model"] == 0):
                entries[i] = "model"
                used.add("model")
                break

    if fsdp_this:
        # shard the largest still-replicated dim over "data"
        dsize = sizes["data"]
        best, best_dim = -1, 0
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim % dsize == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best >= 0:
            entries[best] = "data"
    return tuple(entries)


def _is_axes_leaf(x) -> bool:
    return x is None or (
        isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x))


def _map(fn, shapes, axes):
    """``fn(shape, axes)`` over a nested dict of shapes and its axes tree."""
    if isinstance(shapes, Mapping):
        return {k: _map(fn, shapes[k], axes[k]) for k in shapes}
    return fn(tuple(shapes), tuple(axes))


def param_specs(shapes: Any, axes: Any, mesh, sc: ShardingConfig, *,
                fsdp: Optional[bool] = None, min_fsdp_size: int = 2 ** 20) -> Any:
    """Nested dict of specs for a (shapes, axes) pair of nested dicts
    (``models.transformer.param_shapes`` / ``param_axes``, or a cache's).

    fsdp: shard big replicated dims over "data" too (defaults to the
    variant's behaviour); small tensors (< min_fsdp_size elements) stay
    replicated to avoid pathological tiny collectives."""
    if fsdp is None:
        fsdp = sc.variant == "fsdp"

    def one(shape, a):
        size = 1
        for d in shape:
            size *= d
        return spec_for_tensor(shape, a, mesh, sc,
                               fsdp_this=fsdp and size >= min_fsdp_size)

    return _map(one, shapes, axes)


def opt_state_specs(shapes: Any, axes: Any, mesh, sc: ShardingConfig, *,
                    min_fsdp_size: int = 2 ** 20) -> Any:
    """Adam moment specs: ZeRO-1+ shards them over "data" as well."""
    zero = sc.variant in ("zero1", "fsdp")
    return param_specs(shapes, axes, mesh, sc, fsdp=zero,
                       min_fsdp_size=min_fsdp_size)


def batch_spec(mesh, sc: ShardingConfig, ndim: int = 2,
               batch_size: Optional[int] = None) -> Spec:
    """Token batches: (B, S, ...) with B over pod+data (replicated when the
    global batch does not divide the data-parallel world, e.g. long_500k)."""
    total = 1
    for a in sc.data_axes:
        total *= _axis_size(mesh, a)
    if batch_size is not None and batch_size % total != 0:
        return (None,) * ndim
    lead = sc.data_axes if len(sc.data_axes) > 1 else sc.data_axes[0]
    return (lead,) + (None,) * (ndim - 1)


def activation_rules(mesh, sc: ShardingConfig, kind: str = "train") -> Dict[str, Any]:
    """Rules consumed by ``repro_torch.distributed.ctx.constrain``.

    Full-sequence kinds (train/prefill) shard the residual stream's sequence
    dim over "model" between blocks (Megatron-style sequence parallelism):
    layer-boundary activations and scan carries shrink by the TP degree.
    The all-gather before attention/MLP and the reduce-scatter after are
    collectives the op counter sees, so their cost reaches the
    interconnect roofline term.  ``mesh`` may be a mapping of sizes; the
    ``shmap`` entry then carries it as given."""
    lead = sc.data_axes if len(sc.data_axes) > 1 else sc.data_axes[0]
    seq = "model" if kind in ("train", "prefill") else None
    dp_groups = 1
    for a in sc.data_axes:
        dp_groups *= _axis_size(mesh, a)
    return {
        "acts": (lead, seq, None),
        "logits": (lead, None, "model"),
        "moe_tokens": (lead, None, None),
        "ssm_state": (lead, "model", None),
        "lru_state": (lead, "model"),
        "lru_seq": (None, lead, "model"),
        "ssm_chunks_d": (None, None, lead, "model"),
        "dp_groups": dp_groups,
        "shmap": {"dp": sc.data_axes, "tp": "model", "mesh": mesh},
    }


def scalar_spec(mesh=None) -> Spec:
    return ()


# --------------------------------------------------------------------------- #
# specs -> DTensor placements
# --------------------------------------------------------------------------- #


def placements(spec: Spec, mesh, ndim: Optional[int] = None):
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    for each mesh dimension, ``Shard(d)`` when tensor dimension ``d`` is
    split over it, else ``Replicate()``.  A dimension split over several
    axes (``("pod", "data")``) is sharded over them in mesh order, which is
    the spec's major-to-minor order.  ``ndim`` (the tensor's rank) drops
    leading spec entries, which must be ``None``: a per-layer tensor of a
    stacked leaf takes the stacked spec without its layer dims."""
    from torch.distributed.tensor import Replicate, Shard

    spec = tuple(spec)
    if ndim is not None and len(spec) > ndim:
        lead, spec = spec[:len(spec) - ndim], spec[len(spec) - ndim:]
        if any(e is not None for e in lead):
            raise ValueError(f"spec {lead + spec} shards a stacked layer dim")
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, e in enumerate(spec):
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            out[names.index(a)] = Shard(d)
    order = [names.index(a) for e in spec if isinstance(e, tuple) for a in e]
    if order != sorted(order):
        raise ValueError(f"spec {spec} splits a dim in other than mesh order")
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``spec`` (every
    split dimension divides evenly, as the rules ensure)."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec)[len(spec) - len(shape):] if len(spec) > len(shape) else spec
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            n *= sizes[a]
        out.append(d // n)
    return tuple(out)

"""Placing tensors, models and train states on a mesh as DTensors.

The JAX package hands ``jax.jit`` shardings and lets XLA's partitioner
split the program; the port makes every sharded argument a ``DTensor``
(``torch.distributed.tensor``) with the rules' placements, and DTensor
propagates the sharding op by op, issuing the collectives a layout change
needs.  On the ``meta`` device (the dry run) a DTensor is a meta local
shard of the rank's size: nothing is allocated and every count is per
device.

Operations DTensor has no sharding rule for (the MoE's sort and scatter,
the recurrent step loops) run in explicit local regions
(``local_region``), as the JAX package's ``shard_map`` regions do.
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.distributed.sharding import placements


_DTENSOR = []


def is_dtensor(t) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def local_shape(shape, pl, mesh):
    """The local shard shape of a tensor of ``shape`` under placements
    ``pl`` at this rank (even splits, as the rules ensure)."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def distribute(t: torch.Tensor, spec, mesh, *, pl=None):
    """``t`` (a whole plain tensor, the same on every rank) as a DTensor
    with ``spec``'s placements (or ``pl``); each rank keeps its own shard,
    without communication.  On ``meta`` the shard is a meta tensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = tuple(pl) if pl is not None else placements(spec, mesh, t.ndim)
    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, pl, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def shard_model(model: nn.Module, specs: Mapping, mesh) -> nn.Module:
    """Replace every parameter of ``model`` (a ``ParamTree``) in place by a
    DTensor with its spec's placements; ``specs`` is the stacked tree of
    ``sharding.param_specs`` (a per-layer tensor takes its stack's spec
    without the layer dims).  Returns ``model``."""

    def walk(tree, sp):
        for k, v in list(tree.items()):
            if isinstance(v, nn.ModuleList):
                for blk in v:
                    walk(blk, sp[k])
            elif isinstance(v, nn.Module):
                walk(v, sp[k])
            else:
                tree._parameters[k] = nn.Parameter(
                    distribute(v.detach(), sp[k], mesh), requires_grad=v.requires_grad)

    walk(model, specs)
    return model


def spec_at(specs: Mapping, name: str):
    """The stacked spec of the port's parameter ``name``
    (``layers.3.attn.wq`` -> ``specs["layers"]["attn"]["wq"]``)."""
    for part in name.split("."):
        if not part.isdigit():
            specs = specs[part]
    return specs


def shard_state(cfg, model: nn.Module, mesh, sc, state=None) -> None:
    """Shard ``model``'s parameters (``sharding.param_specs``) and, with a
    train ``state``, its AdamW moments (``opt_state_specs``) onto ``mesh``
    under ``sc``, in place; the step counter stays a plain scalar."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T

    shapes, axes = T.param_shapes(model), T.param_axes(cfg)
    shard_model(model, SH.param_specs(shapes, axes, mesh, sc), mesh)
    if state is not None:
        o_specs = SH.opt_state_specs(shapes, axes, mesh, sc)
        for part in ("m", "v", "ef"):
            if part in state["opt"]:
                state["opt"][part] = {k: distribute(t, spec_at(o_specs, k), mesh)
                                      for k, t in state["opt"][part].items()}


def shard_batch(batch: Mapping, mesh, sc) -> dict:
    """A batch's tensors split over the data axes (``batch_spec``)."""
    from repro_torch.distributed import sharding as SH

    return {k: distribute(t, SH.batch_spec(mesh, sc, t.ndim, t.shape[0]), mesh)
            for k, t in batch.items()}


def shard_tree(tree: Any, specs: Any, mesh):
    """A nested dict of tensors as DTensors with the matching specs."""
    if isinstance(tree, Mapping):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute(tree, specs, mesh)


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank, as a plain tensor."""
    return t.full_tensor() if is_dtensor(t) else t


@contextlib.contextmanager
def sharded_step():
    """Run a step whose arguments are DTensors: plain tensors the model
    makes (positions, masks, schedule scalars) count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield

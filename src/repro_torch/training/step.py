"""Train-step construction: loss gradient + AdamW + optional microbatching.

The JAX package's ``repro/training/step.py``.  ``make_train_step(cfg, oc,
accum=1)`` returns ``train_step(state, batch) -> (state, metrics)``; the
gradient of ``loss_fn``'s total loss comes from ``torch.autograd.grad``
and AdamW updates the state's tensors in place.  With ``accum > 1`` the
global batch is split into ``accum`` microbatches whose float32 gradients
and losses are summed in order and divided by ``accum``, as the JAX
package's ``lax.scan`` body does.

On a mesh (DTensor parameters) the gradient of a parameter that is
replicated over the data axes leaves ``torch.autograd.grad`` as a partial
sum; ``reduce_grads`` reduces it once, to its AdamW moment's placements --
an all-reduce where the moment is replicated as the parameter is, a
reduce-scatter where ZeRO-1 shards the moment over "data" -- before
AdamW reads it (each read of a partial sum would reduce it again).  Under
FSDP a sharded parameter's gradient is reduce-scattered inside autograd
and already has its moment's placements.

A train state is ``{"params": Model, "opt": {"m", "v", "step"[, "ef"]}}``
with the model's parameters requiring grad.  ``state_arrays`` and
``state_from_arrays`` convert it to and from the JAX package's checkpoint
leaves (``params/...``, ``opt/m/...``, ``opt/step``; each stack of layers
one stacked array), so checkpoints written by either package load in the
other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.core.kernels_xp import resolve_device
from repro_torch.distributed.place import full, is_dtensor
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw

TrainState = Dict[str, object]   # {"params": Model, "opt": {...}}


def init_state(cfg: ModelConfig, oc: adamw.OptimizerConfig, *,
               generator: torch.Generator = None, device="cuda",
               model: T.Model = None) -> TrainState:
    """A fresh state: ``model`` (or ``T.init_model(cfg, generator,
    device)``) with its parameters set to require grad, and AdamW's zeros."""
    if model is None:
        model = T.init_model(cfg, generator, device)
    model.requires_grad_(True)
    return {"params": model, "opt": adamw.init(adamw.params_of(model), oc)}


def loss_and_grads(model: T.Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]):
    """(total loss, metrics, {name: gradient}) of ``loss_fn`` at ``model``'s
    parameters, detached; a parameter the loss does not reach gets zeros."""
    params = adamw.params_of(model)
    with torch.enable_grad():
        total, metrics = T.loss_fn(model, cfg, batch)
        grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {k: g if g is not None else torch.zeros_like(p)
             for (k, p), g in zip(params.items(), grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, grads


def reduce_grads(grads: Mapping[str, torch.Tensor],
                 moments: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each DTensor gradient redistributed once to its moment's placements
    (module docstring); any other gradient as it is."""
    out = {}
    for k, g in grads.items():
        m = moments[k]
        if is_dtensor(g) and tuple(g.placements) != tuple(m.placements):
            g = g.redistribute(m.device_mesh, m.placements)
        out[k] = g
    return out


def make_train_step(cfg: ModelConfig, oc: adamw.OptimizerConfig, accum: int = 1):
    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model = state["params"]
        params = adamw.params_of(model)
        if accum > 1:
            micro = [{k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(accum)]
            grads = {k: torch.zeros_like(state["opt"]["m"][k]) for k in params}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            per_micro = []
            for mb in micro:
                mb_loss, metrics, mb_grads = loss_and_grads(model, cfg, mb)
                mb_grads = reduce_grads(mb_grads, state["opt"]["m"])
                grads = {k: grads[k] + mb_grads[k] for k in grads}
                loss = loss + mb_loss
                per_micro.append(metrics)
            grads = {k: g / accum for k, g in grads.items()}
            loss = loss / accum
            metrics = {k: torch.mean(torch.stack([m[k] for m in per_micro]))
                       for k in per_micro[0]}
        else:
            loss, metrics, grads = loss_and_grads(model, cfg, batch)
            grads = reduce_grads(grads, state["opt"]["m"])
        _, new_opt, stats = adamw.update(grads, state["opt"], params, oc)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["total_loss"] = loss
        return {"params": model, "opt": new_opt}, metrics

    return train_step


# --------------------------------------------------------------------------- #
# The JAX package's checkpoint layout
# --------------------------------------------------------------------------- #


def _jax_path(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A parameter name of the port (``layers.3.attn.wq``,
    ``groups.1.rec.0.mlp.w_up``) -> (the JAX tree's key path
    ``layers/attn/wq``, the index into its stacked leaf ``(3,)``)."""
    parts = name.split(".")
    return ("/".join(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def _stacked(tree: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    groups: Dict[str, list] = {}
    for name, t in tree.items():
        key, idx = _jax_path(name)
        groups.setdefault(key, []).append((idx, t))
    out = {}
    for key, items in groups.items():
        items.sort(key=lambda it: it[0])
        if not items[0][0]:
            out[f"{prefix}/{key}"] = full(items[0][1].detach())
            continue
        lead = tuple(max(idx[d] for idx, _ in items) + 1
                     for d in range(len(items[0][0])))
        out[f"{prefix}/{key}"] = torch.stack(
            [full(t.detach()) for _, t in items]).reshape(*lead, *items[0][1].shape)
    return out


def state_arrays(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state as the JAX package's checkpoint leaves, keyed by path; a
    sharded state's leaves are gathered whole (every rank calls it)."""
    opt = state["opt"]
    out = _stacked(adamw.params_of(state["params"]), "params")
    for part in ("m", "v", "ef"):
        if part in opt:
            out.update(_stacked(opt[part], f"opt/{part}"))
    out["opt/step"] = opt["step"]
    return out


@torch.no_grad()
def state_from_arrays(cfg: ModelConfig, arrays: Mapping[str, torch.Tensor],
                      oc: adamw.OptimizerConfig, device="cuda") -> TrainState:
    """A state on ``device`` from the leaves ``state_arrays`` gives (or the
    JAX package's checkpoint holds), whatever device wrote them."""
    dev = resolve_device(device)
    model = T.init_model(cfg, device="meta").to_empty(device=dev)
    params = adamw.params_of(model)
    for name, p in params.items():
        key, idx = _jax_path(name)
        p.copy_(torch.as_tensor(arrays[f"params/{key}"])[idx])
    state = init_state(cfg, oc, model=model)
    for part in ("m", "v", "ef"):
        if part in state["opt"]:
            for name, t in state["opt"][part].items():
                key, idx = _jax_path(name)
                t.copy_(torch.as_tensor(arrays[f"opt/{part}/{key}"])[idx])
    state["opt"]["step"] = torch.as_tensor(arrays["opt/step"]).to(
        device=dev, dtype=torch.int32).reshape(())
    return state

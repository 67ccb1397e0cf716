"""AdamW with warmup-cosine schedule, global-norm clipping, and an optional
error-feedback int8 gradient-compression hook (off by default).

The JAX package's ``repro/optim/adamw.py`` as plain functions on tensors.
A parameter "tree" is a mapping of names to tensors (``params_of(model)``
gives a model's); ``m`` and ``v`` are float32 mappings with the same keys
and ``step`` an int32 scalar tensor.  ``update`` writes the new parameters,
``m``, ``v`` (and ``ef``) into the tensors it is given, under ``no_grad``,
and returns them with the JAX package's stats (``grad_norm``, ``lr``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False   # int8 quantize + error feedback


def params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A model's parameters as the tree ``update`` takes, in
    ``named_parameters`` order."""
    return dict(model.named_parameters())


def schedule(step: torch.Tensor, oc: OptimizerConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor), float32: linear warmup, then a
    cosine decay to ``min_lr_ratio * peak_lr``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(oc.warmup_steps, 1), 1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    decay = oc.min_lr_ratio + (1.0 - oc.min_lr_ratio) * cos
    return oc.peak_lr * warm * decay


def init(params: Tree, oc: OptimizerConfig) -> Dict[str, object]:
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    device = next(iter(params.values())).device if params else None
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if oc.compress_grads:
        state["ef"] = zeros()   # error-feedback residual
    return state


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _compress(g: torch.Tensor, residual: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 stochastic-free quantization with error feedback.

    Emulates a compressed all-reduce: the value that crosses the wire is the
    dequantized int8 tensor; the quantization error stays local in ``ef``.
    """
    gf = g.to(torch.float32) + residual
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


@torch.no_grad()
def update(grads: Tree, state: Dict[str, object], params: Tree,
           oc: OptimizerConfig
           ) -> Tuple[Tree, Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, stats), the
    mappings those it was given (with ``state["step"]`` a new tensor)."""
    step = state["step"] + 1

    if oc.compress_grads:
        pairs = {k: _compress(grads[k], state["ef"][k]) for k in params}
        grads = {k: pr[0] for k, pr in pairs.items()}
        for k, pr in pairs.items():
            state["ef"][k].copy_(pr[1])

    gnorm = global_norm(grads)
    if oc.clip_norm:
        clip_scale = torch.clamp_max(oc.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    else:
        clip_scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule(step, oc)

    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(oc.b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(oc.b2, dtype=torch.float32, device=stepf.device), stepf)

    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].to(torch.float32) * clip_scale
        m.copy_(oc.b1 * m + (1.0 - oc.b1) * gf)
        v.copy_(oc.b2 * v + (1.0 - oc.b2) * torch.square(gf))
        mh = m / bc1
        vh = v / bc2
        pf = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}

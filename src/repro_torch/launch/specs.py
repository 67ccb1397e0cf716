"""Stand-ins for every model input of a cell (the dry-run contract).

The JAX package's ``repro/launch/specs.py`` builds ``ShapeDtypeStruct``
stand-ins with shardings; the port's counterpart is the ``meta`` device:
tensors with shapes and dtypes and no data, on which the step runs
op by op without allocating.  ``input_specs(cfg, shape, device=...)``
returns the cell's step function, its arguments (on ``device``: ``meta``
for the dry run, the card or the CPU for a real run) and the same ``meta``
dict as the JAX package (``params``, ``params_active``, ``tokens``,
``step_kind``).  There is no mesh and there are no shardings.

The steps are the JAX package's: ``make_train_step`` (AdamW, a fresh
state), ``make_prefill_step`` (a zero cache of ``seq_len``, then the whole
prompt) and ``make_serve_step`` (one new token per sequence with a cache of
``seq_len``).  Real runs draw the weights, the token ids and the
stub-frontend embeddings from ``torch.Generator(device)`` seeded ``seed``;
the counts do not depend on the values, except for the MoE's routing
(``models.layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec, tokens_of
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import Family, ModelConfig
from repro_torch.optim import adamw
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.training.step import init_state, make_train_step


def _tokens(cfg: ModelConfig, shape, dev, gen) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=torch.int32, device=dev)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def _batch(cfg: ModelConfig, seq_len: int, batch: int, dev, gen) -> Dict[str, torch.Tensor]:
    out = {"tokens": _tokens(cfg, (batch, seq_len), dev, gen),
           "labels": _tokens(cfg, (batch, seq_len), dev, gen)}

    def embeddings(n):
        shape = (batch, n, cfg.d_model)
        if gen is None:
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    if cfg.family == Family.AUDIO:
        out["frames"] = embeddings(cfg.encoder_seq_len)
    if cfg.family == Family.VLM:
        out["patches"] = embeddings(cfg.n_vision_tokens)
    return out


@dataclasses.dataclass
class CellSpec:
    step_fn: Any
    args: Tuple[Any, ...]
    meta: Dict[str, Any]


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, device="cuda",
                oc: Optional[adamw.OptimizerConfig] = None, seed: int = 0,
                model: Optional[T.Model] = None) -> CellSpec:
    """The cell's step and arguments on ``device``.  ``model`` reuses
    weights already on that device (for an inference cell; a train cell
    turns its parameters' grads on)."""
    oc = oc or adamw.OptimizerConfig()
    dev = resolve_device(device)
    total, active = cfg.param_counts()
    meta = {
        "params": total,
        "params_active": active,
        "tokens": tokens_of(cfg, shape),
        "step_kind": shape.kind,
    }
    gen = None if dev.type == "meta" else torch.Generator(dev).manual_seed(seed)
    if model is None:
        model = T.init_model(cfg, gen, dev)
    B = shape.global_batch

    if shape.kind == "train":
        state = init_state(cfg, oc, model=model)
        return CellSpec(make_train_step(cfg, oc),
                        (state, _batch(cfg, shape.seq_len, B, dev, gen)), meta)

    cache = T.init_cache(cfg, B, shape.seq_len, device=dev)
    if shape.kind == "prefill":
        return CellSpec(make_prefill_step(cfg),
                        (model, cache, _batch(cfg, shape.seq_len, B, dev, gen)), meta)

    # decode: one new token with a cache of seq_len
    tok = _tokens(cfg, (B, 1), dev, gen)
    return CellSpec(make_serve_step(cfg), (model, cache, tok, shape.seq_len - 1),
                    meta)

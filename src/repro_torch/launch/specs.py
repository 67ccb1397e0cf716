"""Stand-ins for every model input of a cell (the dry-run contract).

The JAX package's ``repro/launch/specs.py`` builds ``ShapeDtypeStruct``
stand-ins with shardings; the port's counterpart is the ``meta`` device:
tensors with shapes and dtypes and no data, on which the step runs
op by op without allocating.  ``input_specs(cfg, shape, device=...)``
returns the cell's step function, its arguments (on ``device``: ``meta``
for the dry run, the card or the CPU for a real run) and the same ``meta``
dict as the JAX package (``params``, ``params_active``, ``tokens``,
``step_kind``).  With ``mesh`` and ``sc`` (a ``DeviceMesh`` and a
``distributed.sharding.ShardingConfig``) the arguments are DTensors with
the rules' placements, the JAX package's ``in_shardings``: the parameters
(``param_specs``), the AdamW moments (``opt_state_specs``: ZeRO-1 and FSDP
shard them over "data"), the cache (``param_specs`` without FSDP) and the
batch (``batch_spec``); the step counter stays a plain scalar, which a
sharded step reads as replicated.  ``meta["param_bytes"]`` is then one
device's parameter bytes.

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
from repro_torch.core.costs import storage_bytes
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.distributed import place as PL
from repro_torch.distributed import sharding as SH
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
                model: Optional[T.Model] = None, mesh=None,
                sc: Optional[SH.ShardingConfig] = None) -> CellSpec:
    """The cell's step and arguments on ``device``.  ``model`` reuses
    weights already on that device (for an inference cell; a train cell
    turns its parameters' grads on).  ``mesh`` (with ``sc``) shards the
    arguments over it (module docstring)."""
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
    sharded = mesh is not None
    if sharded:
        sc = sc or SH.ShardingConfig()

    if shape.kind == "train":
        state = init_state(cfg, oc, model=model)
        batch = _batch(cfg, shape.seq_len, B, dev, gen)
        if sharded:
            PL.shard_state(cfg, model, mesh, sc, state)
            batch = PL.shard_batch(batch, mesh, sc)
        return CellSpec(make_train_step(cfg, oc), (state, batch), _meta(meta, model))

    cache = T.init_cache(cfg, B, shape.seq_len, device=dev)
    if sharded:
        PL.shard_state(cfg, model, mesh, sc)
        cache = PL.shard_tree(cache, SH.param_specs(
            _shapes(cache), T.cache_axes(cfg), mesh, sc, fsdp=False), mesh)
    if shape.kind == "prefill":
        batch = _batch(cfg, shape.seq_len, B, dev, gen)
        if sharded:
            batch = PL.shard_batch(batch, mesh, sc)
        return CellSpec(make_prefill_step(cfg), (model, cache, batch), _meta(meta, model))

    # decode: one new token with a cache of seq_len
    tok = _tokens(cfg, (B, 1), dev, gen)
    if sharded:
        tok = PL.shard_batch({"tok": tok}, mesh, sc)["tok"]
    return CellSpec(make_serve_step(cfg), (model, cache, tok, shape.seq_len - 1),
                    _meta(meta, model))


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tuple(tree.shape)


def _meta(meta, model):
    return dict(meta, param_bytes=float(storage_bytes(model)))

"""The model stack in PyTorch (dense family in this slice).

Public API (the JAX package's ``repro/models/transformer.py``, with the
parameter tree replaced by an ``nn.Module``):
  init_model(cfg, generator, device)             -> Model
  forward(model, cfg, batch[, cache])            -> (hidden, aux_loss[, cache])
  loss_fn(model, cfg, batch)                     -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)        -> cache
  prefill(model, cfg, batch, cache)              -> (cache, logits_last)
  decode_step(model, cfg, cache, tokens, index)  -> (cache, logits)

``batch`` is a dict: {"tokens": (B,S) int, "labels": (B,S) int}.  ``cfg``
is passed beside the model, as in the JAX package, so one set of weights
runs under ``cfg.replace(attn_impl=...)`` or other execution options.

Where the port differs: the layer ``scan`` is a Python loop over
``Model.layers``; sharding constraints and logical axes have no
counterpart (``init_model`` and ``init_cache`` return no axes); the KV
cache is written in place, and the cache ``forward``, ``prefill`` and
``decode_step`` return is the one they were given; everything runs under
``torch.inference_mode()``.  Building or running a family other than dense
raises ``NotImplementedError`` naming the slice that will port it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from repro_torch.core.kernels_xp import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import Family, ModelConfig

Params = Dict[str, torch.Tensor]


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port has no stack for yet, naming the item of
    ROADMAP.md's Queue 1 that will port it."""
    if cfg.family == Family.DENSE:
        return
    later = ("item 1 (kernels K6-K8 and the SSM family)"
             if cfg.family == Family.SSM else
             "item 2 (the MoE, hybrid, audio and VLM families)")
    raise NotImplementedError(
        f"{cfg.name}: the {Family(cfg.family).value} family is not ported to "
        f"PyTorch yet; ROADMAP.md Queue 1 {later} will port it")


def _pdict(params: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in params.items()})


class DenseBlock(nn.Module):
    """Pre-norm attention + MLP block; parameters in the JAX layout."""

    def __init__(self, params: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.attn = _pdict(params["attn"])
        self.mlp = _pdict(params["mlp"])
        self.ln1 = _pdict(params["ln1"])
        self.ln2 = _pdict(params["ln2"])


class Model(nn.Module):
    """Embedding, the dense blocks and the final norm."""

    def __init__(self, cfg: ModelConfig, embed: Params, final_norm: Params,
                 layers: List[Mapping[str, Params]]):
        super().__init__()
        check_family(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name} has {cfg.n_layers} layers, got "
                             f"{len(layers)}")
        self.cfg = cfg
        self.embed = _pdict(embed)
        self.final_norm = _pdict(final_norm)
        self.layers = nn.ModuleList(DenseBlock(p) for p in layers)

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #


def _dense_block_init(cfg: ModelConfig, generator, device):
    return {"attn": L.attn_init(cfg, generator, device),
            "mlp": L.mlp_init(cfg, generator, device),
            "ln1": L.norm_init(cfg, device),
            "ln2": L.norm_init(cfg, device)}


@torch.no_grad()
def init_model(cfg: ModelConfig, generator: torch.Generator = None,
               device="cuda") -> Model:
    """Random weights with the JAX package's scales, drawn on ``device``
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    None).  The numbers differ from the JAX package's for the same seed:
    ``repro_torch.carry.model_from_jax`` carries its weights across."""
    check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    embed = L.embed_init(cfg, generator, dev)
    final_norm = L.norm_init(cfg, dev)
    layers = [_dense_block_init(cfg, generator, dev) for _ in range(cfg.n_layers)]
    return Model(cfg, embed, final_norm, layers)


# --------------------------------------------------------------------------- #
# forward (full-sequence)
# --------------------------------------------------------------------------- #


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.rope_style == "none":
        return None
    return L.rope_tables(positions, L.rotary_dim_of(cfg), cfg.rope_theta)


def _dense_block_apply(bp: DenseBlock, cfg, x, *, rope, mask, q_pos=None,
                       k_pos=None, cache=None, index=None):
    h, _ = L.attn_apply(
        bp.attn, cfg, L.norm_apply(bp.ln1, cfg, x),
        rope=rope, mask=mask, q_pos=q_pos, k_pos=k_pos,
        cache=cache, cache_index=index,
    )
    x = x + h
    y = L.mlp_apply(bp.mlp, cfg, L.norm_apply(bp.ln2, cfg, x))
    return x + y


def _layer_cache(cache: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s views of the stacked (n_layers, ...) cache."""
    return {"k": cache["k"][i], "v": cache["v"][i]}


@torch.inference_mode()
def forward(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            cache=None):
    """Full-sequence forward -> (hidden (B,S,D), aux_loss[, cache]).

    With ``cache`` (prefill mode) the per-layer k/v are written in the same
    pass (single-pass prefill; no recompute)."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_apply(model.embed, cfg, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = _rope_for(cfg, positions)
    mask = L.MaskSpec(causal=True, window=cfg.attn_window)
    if cache is not None:
        S_cache = cache["k"].shape[2]
        k_pos = torch.arange(S_cache, device=x.device).expand(B, S_cache)
        for i, bp in enumerate(model.layers):
            x = _dense_block_apply(bp, cfg, x, rope=rope, mask=mask,
                                   q_pos=positions, k_pos=k_pos,
                                   cache=_layer_cache(cache, i), index=0)
    else:
        for bp in model.layers:
            x = _dense_block_apply(bp, cfg, x, rope=rope, mask=mask,
                                   q_pos=positions, k_pos=positions)
    x = L.norm_apply(model.final_norm, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache is not None:
        return x, aux, cache
    return x, aux


# --------------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------------- #


def _xent(model: Model, cfg: ModelConfig, hidden, labels):
    """Mean token cross-entropy; optionally chunked over sequence."""

    def chunk_loss(h_chunk, y_chunk):
        logits = L.unembed_apply(model.embed, cfg, h_chunk).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = logits.gather(-1, y_chunk[..., None].long())[..., 0]
        correct = logits.argmax(dim=-1) == y_chunk
        return (lse - picked).sum(), correct.sum().float()

    B, S, _ = hidden.shape
    lc = cfg.logits_chunk
    if lc and S % lc == 0 and S > lc:
        loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        correct = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, S, lc):
            ls, cs = chunk_loss(hidden[:, i:i + lc], labels[:, i:i + lc])
            loss_sum, correct = loss_sum + ls, correct + cs
    else:
        loss_sum, correct = chunk_loss(hidden, labels)
    denom = float(B * S)
    return loss_sum / denom, correct / denom


@torch.inference_mode()
def loss_fn(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]):
    hidden, aux = forward(model, cfg, batch)
    loss, acc = _xent(model, cfg, hidden, batch["labels"])
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux, "accuracy": acc}


# --------------------------------------------------------------------------- #
# caches + decode
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Decode cache: k, v (n_layers, B, S, K, hd) in the compute dtype.
    max_len = full context length (S = min(max_len, attn_window))."""
    check_family(cfg)
    S = max_len
    if cfg.attn_window:
        S = min(S, cfg.attn_window)
    shape = (cfg.n_layers, batch_size, S, cfg.n_kv_heads, cfg.head_dim_)
    dev = resolve_device(device)
    cd = L.dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev)}


@torch.inference_mode()
def decode_step(model: Model, cfg: ModelConfig, cache, tokens: torch.Tensor,
                index):
    """One-token decode.  tokens: (B, 1); index: position of the new token in
    the context -- a scalar shared by all rows, or a (B,) vector of per-row
    positions (continuous batching with staggered admissions).
    Returns (cache, logits (B, 1, V))."""
    check_family(cfg)
    B = tokens.shape[0]
    x = L.embed_apply(model.embed, cfg, tokens)
    if torch.is_tensor(index) and index.dim():
        index = index.to(device=x.device, dtype=torch.long)
        positions = index.reshape(B, 1)
    else:
        # one host read of a shared index, not one per layer's cache write
        index = int(index)
        positions = torch.full((B, 1), index, dtype=torch.long, device=x.device)
    rope = _rope_for(cfg, positions)

    S_cache = cache["k"].shape[2]
    slots = torch.arange(S_cache, device=x.device).expand(B, S_cache)
    if cfg.attn_window and S_cache <= cfg.attn_window:
        # ring-buffer slots; slot i holds the latest position p <= index with
        # p % S_cache == i (positions broadcasts (B, 1) against (B, S))
        k_pos = positions - ((positions - slots) % S_cache)
        write_index = index % S_cache
    else:
        k_pos = slots
        write_index = index
    mask = L.MaskSpec(causal=True, window=cfg.attn_window)

    for i, bp in enumerate(model.layers):
        x = _dense_block_apply(bp, cfg, x, rope=rope, mask=mask,
                               q_pos=positions, k_pos=k_pos,
                               cache=_layer_cache(cache, i), index=write_index)
    x = L.norm_apply(model.final_norm, cfg, x)
    logits = L.unembed_apply(model.embed, cfg, x)
    return cache, logits


@torch.inference_mode()
def prefill(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            cache):
    """Run the full prompt, fill the cache, return (cache, last-token logits).

    Single-pass: cache writes happen inside the same forward (no recompute).
    """
    hidden, _, cache = forward(model, cfg, batch, cache=cache)
    logits = L.unembed_apply(model.embed, cfg, hidden[:, -1:])
    return cache, logits

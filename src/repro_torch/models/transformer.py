"""The model stack in PyTorch (dense and SSM families so far).

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
cache and the SSM's conv / scan states are written in place, and the cache
``forward``, ``prefill`` and ``decode_step`` return is the one they were
given; everything runs under ``torch.inference_mode()``.  Building or
running a family other than dense or SSM raises ``NotImplementedError``
naming the ROADMAP item that will port it.

For the SSM family ``attn_impl="pallas"`` selects the kernels K6-K8 (the
config schema must stay the JAX package's, so the existing "xla | pallas"
switch is the one used): the first block's norm is RMSNorm K6, each
block's residual add fused with the next block's norm -- and the last
block's with the final norm -- is one fused residual RMSNorm K7, and each
mixer's scan is K8.  So a forward, or a decode step, of an L-layer stack
makes 1 K6, L K7 and L K8 launches.  K7 normalises the float32 sum where
the plain blocks round it to the compute dtype first, so the two settings
agree exactly in float32 and to bf16 rounding in bfloat16.  With
``"xla"`` the blocks are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from repro_torch.core.kernels_xp import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import Family, ModelConfig

Params = Dict[str, torch.Tensor]


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the port has no stack for yet, naming the item of
    ROADMAP.md's Queue 1 that will port it."""
    if cfg.family in (Family.DENSE, Family.SSM):
        return
    raise NotImplementedError(
        f"{cfg.name}: the {Family(cfg.family).value} family is not ported to "
        "PyTorch yet; ROADMAP.md Queue 1 item 3 (the MoE, hybrid, audio and "
        "VLM families) will port it")


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


class SSMBlock(nn.Module):
    """Pre-norm Mamba-1 block; parameters in the JAX layout."""

    def __init__(self, params: Mapping[str, Mapping[str, torch.Tensor]]):
        super().__init__()
        self.mamba = _pdict(params["mamba"])
        self.ln = _pdict(params["ln"])


_BLOCKS = {Family.DENSE: DenseBlock, Family.SSM: SSMBlock}


class Model(nn.Module):
    """Embedding, the blocks of the config's family and the final norm."""

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
        block = _BLOCKS[Family(cfg.family)]
        self.layers = nn.ModuleList(block(p) for p in layers)

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


def _ssm_block_init(cfg: ModelConfig, generator, device):
    return {"mamba": L.mamba_init(cfg, generator, device),
            "ln": L.norm_init(cfg, device)}


_BLOCK_INIT = {Family.DENSE: _dense_block_init, Family.SSM: _ssm_block_init}


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
    block_init = _BLOCK_INIT[Family(cfg.family)]
    layers = [block_init(cfg, generator, dev) for _ in range(cfg.n_layers)]
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
    return {k: v[i] for k, v in cache.items()}


def _ssm_block_apply(bp: SSMBlock, cfg, x, *, state=None):
    h = L.mamba_apply(bp.mamba, cfg, L.norm_apply(bp.ln, cfg, x), state=state,
                      scan_chunk=cfg.ssm.scan_chunk)
    return x + h


def _ssm_stack(model: Model, cfg: ModelConfig, x: torch.Tensor, cache=None):
    """The SSM blocks and the final norm over x (B, S, D); with ``cache``
    each block's conv / scan states start from it and are written back.
    Under ``attn_impl="pallas"`` (with RMSNorm) the norms and residual adds
    run as K6 + K7 (module docstring)."""
    states = ([_layer_cache(cache, i) for i in range(len(model.layers))]
              if cache is not None else [None] * len(model.layers))
    if cfg.attn_impl != "pallas" or cfg.norm != "rmsnorm":
        for bp, st in zip(model.layers, states):
            x = _ssm_block_apply(bp, cfg, x, state=st)
        return L.norm_apply(model.final_norm, cfg, x)
    eps = cfg.norm_eps
    norms = [bp.ln["scale"] for bp in model.layers[1:]] + [model.final_norm["scale"]]
    normed = kops.rmsnorm(x, model.layers[0].ln["scale"], eps=eps)
    for bp, st, scale in zip(model.layers, states, norms):
        h = L.mamba_apply(bp.mamba, cfg, normed, state=st,
                          scan_chunk=cfg.ssm.scan_chunk)
        normed, x = kops.rmsnorm_residual(x, h, scale, eps=eps)
    return normed


@torch.inference_mode()
def forward(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            cache=None):
    """Full-sequence forward -> (hidden (B,S,D), aux_loss[, cache]).

    With ``cache`` (prefill mode) the per-layer k/v, or the SSM's states,
    are written in the same pass (single-pass prefill; no recompute).  The
    SSM's prefill starts from the states the cache holds, as the JAX
    package's does."""
    check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed_apply(model.embed, cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == Family.SSM:
        x = _ssm_stack(model, cfg, x, cache)
        return (x, aux, cache) if cache is not None else (x, aux)
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
    """Decode cache.  Dense: k, v (n_layers, B, S, K, hd) in the compute
    dtype, max_len = full context length (S = min(max_len, attn_window)).
    SSM: conv (n_layers, B, conv_width - 1, Din) in the compute dtype and
    ssm (n_layers, B, Din, N) in float32, whatever max_len."""
    check_family(cfg)
    dev = resolve_device(device)
    cd = L.dtype_of(cfg.compute_dtype)
    if cfg.family == Family.SSM:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return {"conv": torch.zeros((cfg.n_layers, batch_size, s.conv_width - 1, d_in),
                                    dtype=cd, device=dev),
                "ssm": torch.zeros((cfg.n_layers, batch_size, d_in, s.state_dim),
                                   dtype=torch.float32, device=dev)}
    S = max_len
    if cfg.attn_window:
        S = min(S, cfg.attn_window)
    shape = (cfg.n_layers, batch_size, S, cfg.n_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev)}


@torch.inference_mode()
def decode_step(model: Model, cfg: ModelConfig, cache, tokens: torch.Tensor,
                index):
    """One-token decode.  tokens: (B, 1); index: position of the new token in
    the context -- a scalar shared by all rows, or a (B,) vector of per-row
    positions (continuous batching with staggered admissions).
    Returns (cache, logits (B, 1, V)).

    The SSM family ignores ``index``: every row advances its own conv and
    scan state by one token, as in the JAX package."""
    check_family(cfg)
    B = tokens.shape[0]
    x = L.embed_apply(model.embed, cfg, tokens)
    if cfg.family == Family.SSM:
        x = _ssm_stack(model, cfg, x, cache)
        return cache, L.unembed_apply(model.embed, cfg, x)
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

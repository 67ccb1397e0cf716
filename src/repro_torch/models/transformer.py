"""The model stack in PyTorch: every family of the JAX package.

Public API (the JAX package's ``repro/models/transformer.py``, with the
parameter tree replaced by an ``nn.Module``):
  init_model(cfg, generator, device)             -> Model
  forward(model, cfg, batch[, cache])            -> (hidden, aux_loss[, cache])
  loss_fn(model, cfg, batch)                     -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)        -> cache
  prefill(model, cfg, batch, cache)              -> (cache, logits_last)
  decode_step(model, cfg, cache, tokens, index)  -> (cache, logits)
  encode(model, cfg, frames)                     -> encoder states (audio)

``batch`` is a dict: {"tokens": (B,S) int, "labels": (B,S) int, and for
the stub-frontend families "frames": (B,F,D) (audio) / "patches": (B,P,D)
(VLM)}.  ``cfg`` is passed beside the model, as in the JAX package, so one
set of weights runs under ``cfg.replace(attn_impl=...)`` or other
execution options.

The families: dense and VLM (attention + MLP blocks; the VLM's patches
are a prefix its text attends to, and its hidden states and cache
positions count past them), MoE (attention + top-k experts, whose
Switch aux loss, summed over the layers, is ``forward``'s second
output), SSM (Mamba-1 blocks), hybrid (groups of two RG-LRU blocks and a
local-attention block, then the tail's RG-LRU blocks) and audio (a
whisper encoder over frame embeddings and a decoder of self-attention,
cross-attention and MLP blocks).

Sharding: ``param_axes(cfg)`` and ``cache_axes(cfg)`` are the JAX
package's logical axes (its ``init_model`` / ``init_cache`` second
results), keyed by the ``ParamTree`` names in the stacked layout, and
``param_shapes(model)`` the matching stacked shapes; the blocks call
``distributed.ctx.constrain`` at the JAX package's block boundaries (the
identity outside ``use_rules``).  A model whose parameters are DTensors
(``distributed.place.shard_model``) runs sharded: attention, the MoE, the
embedding lookup and the label pick of the loss run in explicit local
regions (``layers``), as do the kernels K5-K8 under ``attn_impl="pallas"``
and the in-place cache writes, each on the device's local tensors, and a
parameter split over the data axes (FSDP) is gathered where a layer
reads it.

Where the port differs: the layer ``scan`` is a Python loop over the
model's stacks; ``init_model`` and ``init_cache`` return no axes (the
functions above give them); the KV caches and the recurrent states are written in place, and the cache
``forward``, ``prefill`` and ``decode_step`` return is the one they were
given (the audio prefill replaces the cross k/v tensors inside it);
``prefill`` and ``decode_step`` run under ``torch.inference_mode()`` (a
sharded model's under ``torch.no_grad()``), and so do ``forward``, ``encode`` and ``loss_fn`` unless autograd is on and
the model has a parameter that requires grad (``repro_torch.training``
turns its model's on), when they build the graph ``torch.autograd.grad``
differentiates.  The kernels K5-K8 have no backward: a call that would
need one raises, as the JAX package's Pallas kernels, which have no JVP
rule, do under ``jax.grad``.  The audio forward with
a cache (prefill) reads the cross k/v from the cache and does not run
the encoder again, whose result the JAX package computes there and
never reads.

``attn_impl="pallas"`` routes attention to the flash-attention kernel K5
where the JAX package routes it to its Pallas kernel: causal
self-attention without a cache or a prefix -- every layer of a dense or
MoE forward, the hybrid's local-attention blocks (in prefill too) and
the audio decoder's self-attention; never the VLM (its prefix), the
audio encoder (unmasked) or cross-attention.  Beyond the JAX package, it
also routes the dense, MoE and audio-decoder prefill's cached
self-attention to K5, over the cache rows just written
(``layers.attn_apply``), unless the config has a logit softcap; a decode
step stays on the plain path.

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

import functools
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch import tracing
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.distributed.ctx import constrain
from repro_torch.distributed.place import is_dtensor
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import Family, ModelConfig


class ParamTree(nn.Module):
    """A nested mapping of tensors as a module: a tensor becomes a frozen
    parameter, a mapping a sub-tree and a list of mappings an
    ``nn.ModuleList`` of sub-trees.  ``tree[name]``, ``name in tree`` and
    ``tree.items()`` read it as the mapping it was built from."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(name, ParamTree(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(b) for b in v))
            else:
                self.register_parameter(name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return _gather_data_shards(getattr(self, name))

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self):
        return [*self._parameters, *self._modules]

    def items(self):
        return [(k, self[k]) for k in self.keys()]


def _gather_data_shards(t):
    """A parameter read by a layer: a DTensor split over the data axes
    (FSDP) is gathered over them first, where the layer uses it, so the
    gather and its backward reduce-scatter sit at each use as in FSDP;
    anything else as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    names = t.device_mesh.mesh_dim_names
    want = tuple(Replicate() if isinstance(p, Shard) and names[i] in ("pod", "data")
                 else p for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, n_tail_rec) of the hybrid's (rec, rec, att) groups."""
    period = len(cfg.hybrid.pattern)
    n_groups = cfg.n_layers // period
    return n_groups, cfg.n_layers - n_groups * period


def _stack_lengths(cfg: ModelConfig) -> Dict[str, int]:
    if cfg.family == Family.HYBRID:
        n_groups, n_tail = hybrid_layout(cfg)
        return {"groups": n_groups, "tail": n_tail}
    if cfg.family == Family.AUDIO:
        return {"enc_layers": cfg.n_encoder_layers, "dec_layers": cfg.n_layers}
    return {"layers": cfg.n_layers}


class Model(ParamTree):
    """A config's parameters in the JAX package's layout, each stacked
    leaf as a list of per-layer trees: ``embed``, ``final_norm`` and

      dense, VLM, MoE, SSM: ``layers`` (n_layers blocks);
      hybrid: ``groups`` (n_layers // 3 of ``{"rec": [2 blocks], "att":
        block}``) and ``tail`` (the remaining recurrent blocks, if any);
      audio: ``enc_layers``, ``dec_layers``, ``enc_norm``, ``enc_pos`` and,
        with ``decoder_pos_len``, ``dec_pos``.
    """

    def __init__(self, cfg: ModelConfig, params: Mapping):
        for name, n in _stack_lengths(cfg).items():
            got = len(params.get(name, ()))
            if got != n:
                raise ValueError(f"{cfg.name} has {n} {name}, got {got}")
        super().__init__(params)
        self.cfg = cfg

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


def _moe_block_init(cfg: ModelConfig, generator, device):
    return {"attn": L.attn_init(cfg, generator, device),
            "moe": L.moe_init(cfg, generator, device),
            "ln1": L.norm_init(cfg, device),
            "ln2": L.norm_init(cfg, device)}


def _ssm_block_init(cfg: ModelConfig, generator, device):
    return {"mamba": L.mamba_init(cfg, generator, device),
            "ln": L.norm_init(cfg, device)}


def _rec_block_init(cfg: ModelConfig, generator, device):
    return {"rec": L.rglru_init(cfg, generator, device),
            "mlp": L.mlp_init(cfg, generator, device),
            "ln1": L.norm_init(cfg, device),
            "ln2": L.norm_init(cfg, device)}


def _xattn_block_init(cfg: ModelConfig, generator, device):
    """Whisper decoder block: self-attn + cross-attn + mlp."""
    return {"self": L.attn_init(cfg, generator, device),
            "cross": L.attn_init(cfg, generator, device),
            "mlp": L.mlp_init(cfg, generator, device),
            "ln1": L.norm_init(cfg, device),
            "ln2": L.norm_init(cfg, device),
            "ln3": L.norm_init(cfg, device)}


_BLOCK_INIT = {Family.DENSE: _dense_block_init, Family.VLM: _dense_block_init,
               Family.MOE: _moe_block_init, Family.SSM: _ssm_block_init}


@torch.no_grad()
def init_model(cfg: ModelConfig, generator: torch.Generator = None,
               device="cuda") -> Model:
    """Random weights with the JAX package's scales, drawn on ``device``
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    None).  The numbers differ from the JAX package's for the same seed:
    ``repro_torch.carry.model_from_jax`` carries its weights across.  On
    the ``meta`` device the weights have shapes and dtypes but no data
    (the dry run's stand-ins)."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    params = {"embed": L.embed_init(cfg, generator, dev),
              "final_norm": L.norm_init(cfg, dev)}
    n = _stack_lengths(cfg)
    if cfg.family in _BLOCK_INIT:
        block_init = _BLOCK_INIT[Family(cfg.family)]
        params["layers"] = [block_init(cfg, generator, dev) for _ in range(n["layers"])]
    elif cfg.family == Family.HYBRID:
        params["groups"] = [
            {"rec": [_rec_block_init(cfg, generator, dev) for _ in range(2)],
             "att": _dense_block_init(cfg, generator, dev)}
            for _ in range(n["groups"])]
        if n["tail"]:
            params["tail"] = [_rec_block_init(cfg, generator, dev)
                              for _ in range(n["tail"])]
    else:   # audio
        dt = L.dtype_of(cfg.param_dtype)
        params["enc_layers"] = [_dense_block_init(cfg, generator, dev)
                                for _ in range(n["enc_layers"])]
        params["dec_layers"] = [_xattn_block_init(cfg, generator, dev)
                                for _ in range(n["dec_layers"])]
        params["enc_norm"] = L.norm_init(cfg, dev)
        params["enc_pos"] = L._init_dense((cfg.encoder_seq_len, cfg.d_model), dt,
                                          generator, dev, scale=0.02)
        if cfg.decoder_pos_len:
            params["dec_pos"] = L._init_dense((cfg.decoder_pos_len, cfg.d_model), dt,
                                              generator, dev, scale=0.02)
    return Model(cfg, params)


# --------------------------------------------------------------------------- #
# logical axes (the JAX package's ``init_model`` / ``init_cache`` axes)
# --------------------------------------------------------------------------- #


def _stacked(axes: Mapping, depth: int = 1) -> Dict:
    """``axes`` with ``depth`` "layers" axes in front of every leaf."""
    return {k: _stacked(v, depth) if isinstance(v, Mapping)
            else ("layers",) * depth + tuple(v) for k, v in axes.items()}


def _dense_block_axes(cfg):
    return {"attn": L.attn_axes(cfg), "mlp": L.mlp_axes(cfg),
            "ln1": L.norm_axes(cfg), "ln2": L.norm_axes(cfg)}


def _moe_block_axes(cfg):
    return {"attn": L.attn_axes(cfg), "moe": L.moe_axes(cfg),
            "ln1": L.norm_axes(cfg), "ln2": L.norm_axes(cfg)}


def _ssm_block_axes(cfg):
    return {"mamba": L.mamba_axes(cfg), "ln": L.norm_axes(cfg)}


def _rec_block_axes(cfg):
    return {"rec": L.rglru_axes(cfg), "mlp": L.mlp_axes(cfg),
            "ln1": L.norm_axes(cfg), "ln2": L.norm_axes(cfg)}


def _xattn_block_axes(cfg):
    return {"self": L.attn_axes(cfg), "cross": L.attn_axes(cfg),
            "mlp": L.mlp_axes(cfg), "ln1": L.norm_axes(cfg),
            "ln2": L.norm_axes(cfg), "ln3": L.norm_axes(cfg)}


_BLOCK_AXES = {Family.DENSE: _dense_block_axes, Family.VLM: _dense_block_axes,
               Family.MOE: _moe_block_axes, Family.SSM: _ssm_block_axes}


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``init_model(cfg)``'s parameters, keyed by the
    ``ParamTree`` names, with the JAX package's stacked layout: a leaf of a
    stack (``layers``, ``groups``, ``tail``, ``enc_layers``,
    ``dec_layers``) has one "layers" axis in front per stacking level (the
    hybrid's ``groups.rec`` two), where the port keeps a list of per-layer
    trees.  ``param_shapes`` gives the matching stacked shapes."""
    axes = {"embed": L.embed_axes(cfg), "final_norm": L.norm_axes(cfg)}
    n = _stack_lengths(cfg)
    if cfg.family in _BLOCK_AXES:
        axes["layers"] = _stacked(_BLOCK_AXES[Family(cfg.family)](cfg))
    elif cfg.family == Family.HYBRID:
        axes["groups"] = {"rec": _stacked(_rec_block_axes(cfg), 2),
                          "att": _stacked(_dense_block_axes(cfg))}
        if n["tail"]:
            axes["tail"] = _stacked(_rec_block_axes(cfg))
    else:   # audio
        axes["enc_layers"] = _stacked(_dense_block_axes(cfg))
        axes["dec_layers"] = _stacked(_xattn_block_axes(cfg))
        axes["enc_norm"] = L.norm_axes(cfg)
        axes["enc_pos"] = ("positions", "embed")
        if cfg.decoder_pos_len:
            axes["dec_pos"] = ("positions", "embed")
    return axes


def param_shapes(model: nn.Module) -> Dict:
    """The stacked shape of every parameter of ``model`` (a ``ParamTree``),
    in ``param_axes``' layout: a stack of n per-layer trees gives each leaf
    a leading dim n."""

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, nn.ModuleList):
                out[k] = _lead(len(v), walk(v[0]))
            elif isinstance(v, ParamTree):
                out[k] = walk(v)
            else:
                out[k] = tuple(v.shape)
        return out

    def _lead(n, tree):
        return {k: _lead(n, v) if isinstance(v, dict) else (n,) + v
                for k, v in tree.items()}

    return walk(model)


_KV_AXES = {"k": ("layers", "batch", None, "kv_heads", "head_dim"),
            "v": ("layers", "batch", None, "kv_heads", "head_dim")}


def cache_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of ``init_cache(cfg, ...)``'s tensors."""
    if cfg.family == Family.SSM:
        return {"conv": ("layers", "batch", None, "mlp"),
                "ssm": ("layers", "batch", "mlp", "state")}
    if cfg.family == Family.HYBRID:
        def rec_axes(extra):
            return {"conv": extra + ("batch", None, "mlp"),
                    "lru": extra + ("batch", "mlp")}
        ax = {"groups": {"rec": rec_axes(("layers", None)), "att": dict(_KV_AXES)}}
        if hybrid_layout(cfg)[1]:
            ax["tail"] = rec_axes(("layers",))
        return ax
    if cfg.family == Family.AUDIO:
        return {"self": dict(_KV_AXES), "cross": dict(_KV_AXES)}
    return dict(_KV_AXES)


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #


def _rope_for(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.rope_style == "none":
        return None
    return L.rope_tables(positions, L.rotary_dim_of(cfg), cfg.rope_theta)


def _at(cache, i):
    """Layer ``i``'s views (``i`` an index or a tuple of indices) of a
    stacked cache: every tensor of the nested dict indexed by ``i``."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i] for k, v in cache.items()}


def _residual(x, h):
    """``constrain(x + h, "acts")``, the JAX package's block boundary.  The
    branch ``h`` takes the layout first (under sequence parallelism its
    partial sums are reduce-scattered over the sequence), so its gradient
    comes back gathered in the layout the branch computed it in."""
    return constrain(x + constrain(h, "acts"), "acts")


def _dense_block_apply(bp, cfg, x, *, rope, mask, q_pos=None, k_pos=None,
                       cache=None, index=None):
    """Pre-norm attention + MLP block, or + MoE for a block that has one:
    -> (x, the MoE's aux loss or None)."""
    h, _ = L.attn_apply(
        bp.attn, cfg, L.norm_apply(bp.ln1, cfg, x),
        rope=rope, mask=mask, q_pos=q_pos, k_pos=k_pos,
        cache=cache, cache_index=index,
    )
    x = _residual(x, h)
    if "moe" in bp:
        y, aux = L.moe_apply(bp.moe, cfg, L.norm_apply(bp.ln2, cfg, x))
        return _residual(x, y), aux
    return _residual(x, L.mlp_apply(bp.mlp, cfg, L.norm_apply(bp.ln2, cfg, x))), None


def _ssm_block_apply(bp, cfg, x, *, state=None):
    h = L.mamba_apply(bp.mamba, cfg, L.norm_apply(bp.ln, cfg, x), state=state,
                      scan_chunk=cfg.ssm.scan_chunk)
    return _residual(x, h)


def _rec_block_apply(bp, cfg, x, *, state=None):
    x = _residual(x, L.rglru_apply(bp.rec, cfg, L.norm_apply(bp.ln1, cfg, x),
                                   state=state))
    return _residual(x, L.mlp_apply(bp.mlp, cfg, L.norm_apply(bp.ln2, cfg, x)))


def _xattn_block_apply(bp, cfg, x, *, mask, q_pos=None, k_pos=None,
                       enc_out=None, cache=None, index=None):
    """Whisper decoder block.  With ``cache`` ({"self", "cross"} layer
    views) the self-attention writes its k/v at ``index`` and the
    cross-attention reads the static cross k/v; else it attends over
    ``enc_out``."""
    h, _ = L.attn_apply(
        bp["self"], cfg, L.norm_apply(bp.ln1, cfg, x),
        mask=mask, q_pos=q_pos, k_pos=k_pos,
        cache=cache["self"] if cache is not None else None, cache_index=index,
    )
    x = _residual(x, h)
    cross = cache["cross"] if cache is not None else None
    h, _ = L.attn_apply(bp.cross, cfg, L.norm_apply(bp.ln2, cfg, x),
                        kv_x=enc_out, cache=cross, static_cache=cross is not None)
    x = _residual(x, h)
    return _residual(x, L.mlp_apply(bp.mlp, cfg, L.norm_apply(bp.ln3, cfg, x)))


def _ssm_stack(model: Model, cfg: ModelConfig, x: torch.Tensor, cache=None):
    """The SSM blocks and the final norm over x (B, S, D); with ``cache``
    each block's conv / scan states start from it and are written back.
    Under ``attn_impl="pallas"`` (with RMSNorm) the norms and residual adds
    run as K6 + K7 (module docstring), on a mesh in local regions
    (``_kernel_norm``)."""
    states = ([_at(cache, i) for i in range(len(model.layers))]
              if cache is not None else [None] * len(model.layers))
    if cfg.attn_impl != "pallas" or cfg.norm != "rmsnorm":
        for i, (bp, st) in enumerate(zip(model.layers, states)):
            with tracing.span("block", index=i):
                x = _ssm_block_apply(bp, cfg, x, state=st)
        with tracing.span("final_norm"):
            return L.norm_apply(model.final_norm, cfg, x)
    eps = cfg.norm_eps
    norms = [bp.ln["scale"] for bp in model.layers[1:]] + [model.final_norm["scale"]]
    normed, = _kernel_norm(x, model.layers[0].ln["scale"], eps)
    for i, (bp, st, scale) in enumerate(zip(model.layers, states, norms)):
        with tracing.span("block", index=i):
            h = L.mamba_apply(bp.mamba, cfg, normed, state=st,
                              scan_chunk=cfg.ssm.scan_chunk)
            normed, x = _kernel_norm(x, scale, eps, h)
    return normed


def _kernel_norm(x, scale, eps, h=None):
    """K6 over x, or (``h`` given) K7 over ``x + h``: -> (normed,) or
    (normed, x + h).  On a mesh in an explicit local region: RMSNorm is
    row-local, so each device normalises its own rows of x in the "acts"
    layout (rows over the data axes, the sequence over "model" under
    sequence parallelism, d_model whole; a decode step's pending partial
    sums reduced), with ``h`` redistributed to that layout (its partial
    sums reduce-scattered under sequence parallelism) and ``scale``
    whole; the results are DTensors in that layout."""
    if not is_dtensor(x):
        if h is None:
            return (kops.rmsnorm(x, scale, eps=eps),)
        return kops.rmsnorm_residual(x, h, scale, eps=eps)
    from torch.distributed.tensor import Replicate, Shard

    x = constrain(x, "acts")
    pl = tuple(p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
               for p in x.placements)
    mesh = x.device_mesh
    x = x.redistribute(mesh, pl)
    xl, sl = x.to_local().contiguous(), L._plain(scale).contiguous()
    if h is None:
        outs = (kops.rmsnorm(xl, sl, eps=eps),)
    else:
        hl = h.redistribute(mesh, pl).to_local().contiguous()
        outs = kops.rmsnorm_residual(xl, hl, sl, eps=eps)
    return tuple(L._dtensor(o, mesh, pl, x.shape) for o in outs)


def _ring_write(bp, cfg, x, rope, kv) -> None:
    """The hybrid prefill's cache write: the local-attention block's k/v of
    the last ``min(W, S)`` positions of x, at ring slots ``(S - take +
    arange(take)) % W`` of its (B, W, K, hd) layer views -- computed as the
    JAX package computes them (no bias, no k-norm)."""
    cd = L.dtype_of(cfg.compute_dtype)
    xn = L._tokens_whole(L.norm_apply(bp.ln1, cfg, x).to(cd))
    k = L._kv_whole(L._matmul(xn, bp.attn["wk"].to(cd)))
    v = L._kv_whole(L._matmul(xn, bp.attn["wv"].to(cd)))
    if rope is not None:
        k = L.apply_rope(k, *rope, cfg.rope_style)
    W, S = kv["k"].shape[1], k.shape[1]
    take = min(W, S)
    slots = (S - take + torch.arange(take, device=x.device)) % W
    k, v = k[:, S - take:].to(kv["k"].dtype), v[:, S - take:].to(kv["v"].dtype)
    if is_dtensor(kv["k"]):
        # in a local region (DTensor has no rule for index_put_ in every
        # PyTorch release): each device writes its own rows and heads
        mesh, pl = kv["k"].device_mesh, kv["k"].placements
        kv = {n: kv[n].to_local() for n in ("k", "v")}
        k, v = (t.redistribute(mesh, pl).to_local() for t in (k, v))
    kv["k"][:, slots] = k
    kv["v"][:, slots] = v


def _hybrid_stack(model: Model, cfg: ModelConfig, x, *, rope, mask, q_pos,
                  k_pos, cache=None, index=None):
    """The hybrid's groups and tail over x.  With ``index`` (decode) the
    local-attention blocks write and attend over their ring caches; with a
    cache and no index (prefill) they attend over x itself and then write
    the ring (``_ring_write``); the recurrent blocks carry their states
    through the cache either way."""
    for g, gp in enumerate(model.groups):
        c = _at(cache["groups"], g) if cache is not None else None
        for j, bp in enumerate(gp.rec):
            x = _rec_block_apply(bp, cfg, x,
                                 state=_at(c["rec"], j) if c is not None else None)
        if index is not None:
            x, _ = _dense_block_apply(gp.att, cfg, x, rope=rope, mask=mask, q_pos=q_pos,
                                      k_pos=k_pos, cache=c["att"], index=index)
        else:
            if c is not None:
                _ring_write(gp.att, cfg, x, rope, c["att"])
            x, _ = _dense_block_apply(gp.att, cfg, x, rope=rope, mask=mask,
                                      q_pos=q_pos, k_pos=k_pos)
    for i, bp in enumerate(model.tail if "tail" in model else ()):
        x = _rec_block_apply(bp, cfg, x,
                             state=_at(cache["tail"], i) if cache is not None else None)
    return x


# --------------------------------------------------------------------------- #
# forward (full-sequence)
# --------------------------------------------------------------------------- #


def trains(model: nn.Module) -> bool:
    """True when autograd is on and ``model`` has a parameter that requires
    grad: ``forward``, ``encode`` and ``loss_fn`` then build a graph."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())


def _no_grad_for(model: nn.Module):
    """``torch.inference_mode()``, or ``torch.no_grad()`` for a model whose
    parameters are DTensors."""
    from repro_torch.distributed.place import is_dtensor

    if any(is_dtensor(p) for p in model.parameters()):
        return torch.no_grad()
    return torch.inference_mode()


def _without_autograd(fn):
    """Run ``fn(model, ...)`` under ``_no_grad_for(model)``."""

    @functools.wraps(fn)
    def wrapped(model, *args, **kwargs):
        with _no_grad_for(model):
            return fn(model, *args, **kwargs)

    return wrapped


def _inference_unless_training(fn):
    """Run ``fn(model, ...)`` under ``torch.inference_mode()`` unless
    ``trains(model)``; a model sharded over a mesh (DTensor parameters,
    which inference tensors cannot wrap) runs under ``torch.no_grad()``."""

    @functools.wraps(fn)
    def wrapped(model, *args, **kwargs):
        if trains(model):
            return fn(model, *args, **kwargs)
        with _no_grad_for(model):
            return fn(model, *args, **kwargs)

    return wrapped


@_inference_unless_training
def encode(model: Model, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, F, D): unmasked
    attention, no rope, learned positions."""
    x = frames.to(device=model.device, dtype=L.dtype_of(cfg.compute_dtype))
    x = x + model.enc_pos[:x.shape[1]].to(x.dtype)
    mask = L.MaskSpec(everything=True)
    enc_cfg = cfg.replace(rope_style="none")
    for bp in model.enc_layers:
        x, _ = _dense_block_apply(bp, enc_cfg, x, rope=None, mask=mask)
    return L.norm_apply(model.enc_norm, cfg, x)


@_inference_unless_training
def forward(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            cache=None):
    """Full-sequence forward -> (hidden (B,S,D), aux_loss[, cache]).

    With ``cache`` (prefill mode) the per-layer k/v, or the recurrent
    states, are written in the same pass (single-pass prefill; no
    recompute).  The SSM's and the hybrid's prefill start from the states
    the cache holds, as the JAX package's do."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    with tracing.span("embed"):
        x = constrain(L.embed_apply(model.embed, cfg, tokens), "acts")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == Family.SSM:
        x = _ssm_stack(model, cfg, x, cache)
        return (x, aux, cache) if cache is not None else (x, aux)
    prefix_len = 0
    if cfg.family == Family.VLM:
        patches = batch["patches"].to(device=x.device, dtype=x.dtype)  # SigLIP stub
        x = torch.cat([patches, x], dim=1)
        prefix_len = patches.shape[1]
        S = x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    rope = _rope_for(cfg, positions)

    if cfg.family == Family.HYBRID:
        mask = L.MaskSpec(causal=True, window=cfg.attn_window)
        x = _hybrid_stack(model, cfg, x, rope=rope, mask=mask, q_pos=positions,
                          k_pos=positions, cache=cache)
    elif cfg.family == Family.AUDIO:
        if "dec_pos" in model:
            x = x + model.dec_pos[:S].to(x.dtype)
        mask = L.MaskSpec(causal=True)
        if cache is not None:
            S_cache = cache["self"]["k"].shape[2]
            k_pos = torch.arange(S_cache, device=x.device).expand(B, S_cache)
            # index 0 with q_pos 0..S-1 and k_pos 0..S_cache-1: the contract
            # under which attn_apply's cached prefill takes K5
            for i, bp in enumerate(model.dec_layers):
                with tracing.span("block", index=i):
                    x = _xattn_block_apply(bp, cfg, x, mask=mask, q_pos=positions,
                                           k_pos=k_pos, cache=_at(cache, i), index=0)
        else:
            enc = encode(model, cfg, batch["frames"])
            for i, bp in enumerate(model.dec_layers):
                with tracing.span("block", index=i):
                    x = _xattn_block_apply(bp, cfg, x, mask=mask, q_pos=positions,
                                           k_pos=positions, enc_out=enc)
    else:   # dense, VLM, MoE
        mask = L.MaskSpec(causal=True, window=cfg.attn_window, prefix_len=prefix_len)
        k_pos = positions
        if cache is not None:
            # index 0 with q_pos 0..S-1 and k_pos 0..S_cache-1: the contract
            # under which attn_apply's cached prefill takes K5 (it does not
            # read the positions)
            S_cache = cache["k"].shape[2]
            k_pos = torch.arange(S_cache, device=x.device).expand(B, S_cache)
        for i, bp in enumerate(model.layers):
            with tracing.span("block", index=i):
                x, layer_aux = _dense_block_apply(
                    bp, cfg, x, rope=rope, mask=mask, q_pos=positions, k_pos=k_pos,
                    cache=_at(cache, i) if cache is not None else None, index=0)
                if layer_aux is not None:
                    aux = aux + layer_aux
    with tracing.span("final_norm"):
        x = L.norm_apply(model.final_norm, cfg, x)
    if prefix_len:
        x = x[:, prefix_len:]   # loss only over text positions
    if cache is not None:
        return x, aux, cache
    return x, aux


# --------------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------------- #


def _xent_sharded(logits, labels):
    """``chunk_loss`` of DTensor logits split over the vocabulary: the
    log-sum-exp from a max and a sum over the split dim (two small
    all-reduces, where ``torch.logsumexp`` would gather the logits), the
    label's logit from DTensor's masked gather."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = logits.device_mesh
    rows = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in logits.placements)
    # each token's terms are all-reduced whole on its batch shard (not
    # reduce-scattered over the sequence), so the logits' gradient keeps
    # the logits' layout
    m = logits.detach().amax(-1, keepdim=True).redistribute(mesh, rows)
    lse = (logits - m).exp().sum(-1, keepdim=True).redistribute(mesh, rows).log() + m
    picked = _picked_sharded(logits, labels).redistribute(mesh, rows)
    correct = _argmax_sharded(logits.detach()) == labels
    return (lse - picked).sum(), correct.sum().float()


def _picked_sharded(logits, labels):
    """``logits.gather(-1, labels[..., None])`` of DTensor logits split over
    the vocabulary, in a local region: each device reads the labels inside
    its shard (zeros elsewhere), a partial sum over that mesh dim."""
    from torch.distributed.tensor import DTensor, Partial

    split, ids, inside = L.vocab_local(logits, labels, -1)
    local = logits.to_local()
    picked = local.gather(-1, ids[..., None].long())
    if inside is not None:
        picked = picked * inside[..., None].to(picked.dtype)
    pl = tuple(Partial() if i in split else p for i, p in enumerate(logits.placements))
    shape = (*logits.shape[:-1], 1)
    return DTensor.from_local(picked, logits.device_mesh, pl, run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def _argmax_sharded(logits):
    """``logits.argmax(-1)`` of a DTensor, its last dim split over at most
    one mesh dim: each device's first maximum and its index, gathered over
    that mesh dim, and the first maximum of those (the lowest index among
    ties, as ``argmax``).  DTensor's own rule fails when the other dims are
    split over two mesh dims."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    last = logits.ndim - 1
    split = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last]
    if not split:
        return logits.argmax(dim=-1)
    (md,) = split
    mesh = logits.device_mesh
    local = logits.to_local()
    val, idx = local.max(-1)
    n = mesh.size(md)
    idx = idx + mesh.get_local_rank(md) * local.shape[-1]
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    vals = gather(val, 0, (mesh, md)).reshape(n, *val.shape)
    idxs = gather(idx, 0, (mesh, md)).reshape(n, *idx.shape)
    pred = idxs.gather(0, vals.argmax(0)[None])[0]
    pl = tuple(Replicate() if i == md else p for i, p in enumerate(logits.placements))
    return DTensor.from_local(pred, mesh, pl, run_check=False,
                              shape=logits.shape[:-1],
                              stride=torch.empty(logits.shape[:-1], device="meta").stride())


def _xent(model: Model, cfg: ModelConfig, hidden, labels):
    """Mean token cross-entropy; optionally chunked over sequence."""

    def chunk_loss(h_chunk, y_chunk):
        logits = constrain(L.unembed_apply(model.embed, cfg, h_chunk), "logits").float()
        if is_dtensor(logits):
            return _xent_sharded(logits, y_chunk)
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


@_inference_unless_training
def loss_fn(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]):
    hidden, aux = forward(model, cfg, batch)
    loss, acc = _xent(model, cfg, hidden, batch["labels"])
    total = loss + aux
    return total, {"loss": loss, "aux_loss": aux, "accuracy": acc}


# --------------------------------------------------------------------------- #
# caches + decode
# --------------------------------------------------------------------------- #


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device="cuda"):
    """Decode cache, zeros, shaped as the JAX package's; max_len = full
    context length.

      dense, MoE, VLM: k, v (n_layers, B, S, K, hd) in the compute dtype,
        S = max_len (+ n_vision_tokens for the VLM), at most attn_window;
      SSM: conv (n_layers, B, conv_width - 1, Din) in the compute dtype and
        ssm (n_layers, B, Din, N) in float32, whatever max_len;
      hybrid: {"groups": {"rec": {conv (G, 2, B, conv_width - 1, W_lru),
        lru (G, 2, B, W_lru) f32}, "att": k, v (G, B, W, K, hd)}, "tail":
        {conv, lru} (n_tail, ...)}, W = min(max_len, attn_window);
      audio: {"self": k, v (n_layers, B, max_len, K, hd), "cross": k, v
        (n_layers, B, encoder_seq_len, K, hd)}.
    """
    dev = resolve_device(device)
    cd = L.dtype_of(cfg.compute_dtype)
    B = batch_size

    def kv(n, S):
        shape = (n, B, S, cfg.n_kv_heads, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=cd, device=dev),
                "v": torch.zeros(shape, dtype=cd, device=dev)}

    if cfg.family == Family.SSM:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        return {"conv": torch.zeros((cfg.n_layers, B, s.conv_width - 1, d_in),
                                    dtype=cd, device=dev),
                "ssm": torch.zeros((cfg.n_layers, B, d_in, s.state_dim),
                                   dtype=torch.float32, device=dev)}
    if cfg.family == Family.HYBRID:
        h = cfg.hybrid
        w = h.lru_width or cfg.d_model
        n_groups, n_tail = hybrid_layout(cfg)
        W = min(max_len, cfg.attn_window or max_len)

        def rec_state(*lead):
            return {"conv": torch.zeros(lead + (B, h.conv_width - 1, w), dtype=cd,
                                        device=dev),
                    "lru": torch.zeros(lead + (B, w), dtype=torch.float32, device=dev)}

        cache = {"groups": {"rec": rec_state(n_groups, 2), "att": kv(n_groups, W)}}
        if n_tail:
            cache["tail"] = rec_state(n_tail)
        return cache
    if cfg.family == Family.AUDIO:
        return {"self": kv(cfg.n_layers, max_len),
                "cross": kv(cfg.n_layers, cfg.encoder_seq_len)}
    S = max_len + (cfg.n_vision_tokens if cfg.family == Family.VLM else 0)
    if cfg.attn_window:
        S = min(S, cfg.attn_window)
    return kv(cfg.n_layers, S)


def _ring_positions(positions: torch.Tensor, W: int) -> torch.Tensor:
    """The position ring slot i holds when the newest is ``positions``
    (B, 1): the latest p <= position with p % W == i.  Slots not written
    yet get positions below 0 and stay unmasked, as in the JAX package."""
    slots = torch.arange(W, device=positions.device).expand(positions.shape[0], W)
    return positions - ((positions - slots) % W)


@_without_autograd
def decode_step(model: Model, cfg: ModelConfig, cache, tokens: torch.Tensor,
                index):
    """One-token decode.  tokens: (B, 1); index: position of the new token in
    the context -- a scalar shared by all rows, or a (B,) vector of per-row
    positions (continuous batching with staggered admissions).
    Returns (cache, logits (B, 1, V)).

    The SSM family ignores ``index``: every row advances its own conv and
    scan state by one token, as in the JAX package.  The VLM's positions
    count past its ``n_vision_tokens`` prefix slots; the hybrid's local
    attention writes ring slot ``index % W``; the audio decoder reads the
    cross cache and never writes it."""
    B = tokens.shape[0]
    x = L.embed_apply(model.embed, cfg, tokens)
    if cfg.family == Family.SSM:
        x = _ssm_stack(model, cfg, x, cache)
        return cache, L.unembed_apply(model.embed, cfg, x)
    if torch.is_tensor(index) and index.dim():
        index = index.to(device=x.device, dtype=torch.long)
        per_row = True
    else:
        # one host read of a shared index, not one per layer's cache write
        index = int(index)
        per_row = False
    if cfg.family == Family.VLM:
        index = index + cfg.n_vision_tokens   # cache slots are absolute
    if per_row:
        positions = index.reshape(B, 1)
    else:
        positions = torch.full((B, 1), index, dtype=torch.long, device=x.device)
    rope = _rope_for(cfg, positions)

    if cfg.family == Family.HYBRID:
        W = cache["groups"]["att"]["k"].shape[2]
        mask = L.MaskSpec(causal=True, window=cfg.attn_window)
        x = _hybrid_stack(model, cfg, x, rope=rope, mask=mask, q_pos=positions,
                          k_pos=_ring_positions(positions, W), cache=cache,
                          index=index % W)
    elif cfg.family == Family.AUDIO:
        if "dec_pos" in model:
            if per_row:   # jnp.take: NaN rows outside [-n, n), negatives wrap
                n = model.dec_pos.shape[0]
                inside = (index >= -n) & (index < n)
                rows = model.dec_pos[torch.where(inside, index, 0)]
                rows = torch.where(inside[:, None], rows, float("nan"))
                x = x + rows[:, None].to(x.dtype)
            else:   # lax.dynamic_slice_in_dim clamps the start
                i = min(max(index, 0), model.dec_pos.shape[0] - 1)
                x = x + model.dec_pos[i:i + 1].to(x.dtype)[None]
        S_cache = cache["self"]["k"].shape[2]
        k_pos = torch.arange(S_cache, device=x.device).expand(B, S_cache)
        mask = L.MaskSpec(causal=True)
        for i, bp in enumerate(model.dec_layers):
            x = _xattn_block_apply(bp, cfg, x, mask=mask, q_pos=positions, k_pos=k_pos,
                                   cache=_at(cache, i), index=index)
    else:   # dense, MoE, VLM
        S_cache = cache["k"].shape[2]
        if cfg.attn_window and S_cache <= cfg.attn_window:
            k_pos = _ring_positions(positions, S_cache)
            write_index = index % S_cache
        else:
            k_pos = torch.arange(S_cache, device=x.device).expand(B, S_cache)
            write_index = index
        mask = L.MaskSpec(causal=True, window=cfg.attn_window)
        for i, bp in enumerate(model.layers):
            x, _ = _dense_block_apply(bp, cfg, x, rope=rope, mask=mask,
                                      q_pos=positions, k_pos=k_pos,
                                      cache=_at(cache, i), index=write_index)
    x = L.norm_apply(model.final_norm, cfg, x)
    logits = L.unembed_apply(model.embed, cfg, x)
    return cache, logits


def prefill(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor],
            cache):
    """Run the full prompt, fill the cache, return (cache, last-token logits).

    Single-pass: cache writes happen inside the same forward (no recompute).
    The audio family first encodes ``batch["frames"]`` and puts each decoder
    layer's cross k/v (no bias, as the JAX package computes them) into
    ``cache["cross"]``.

    The whole call is a ``prefill`` span of ``repro_torch.tracing``
    (attributes B and S), with the counters' deltas across it.
    """
    B, S = batch["tokens"].shape
    with tracing.span("prefill", counts=True, B=B, S=S):
        return _prefill(model, cfg, batch, cache)


@_without_autograd
def _prefill(model: Model, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], cache):
    if cfg.family == Family.AUDIO:
        cd = L.dtype_of(cfg.compute_dtype)
        enc = encode(model, cfg, batch["frames"]).to(cd)
        cache["cross"].update(
            k=torch.stack([L._matmul(enc, bp.cross["wk"].to(cd)) for bp in model.dec_layers]),
            v=torch.stack([L._matmul(enc, bp.cross["wv"].to(cd)) for bp in model.dec_layers]))
    hidden, _, cache = forward(model, cfg, batch, cache=cache)
    with tracing.span("unembed"):
        logits = L.unembed_apply(model.embed, cfg, hidden[:, -1:])
    return cache, logits

"""Neural net layers of every model family, in PyTorch.

The JAX package's ``repro/models/layers.py``: norms, rotary embeddings,
embedding and unembedding, GQA attention (self or cross; causal,
sliding-window and prefix-LM masks; q-chunked; KV-cached with a scalar or
per-row write index, or over a static cross cache; or the flash-attention
kernel K5), the MLPs, the token-choice top-k MoE (``gmm``, ``dense`` and
``capacity`` dispatch), the RG-LRU recurrent block and the Mamba-1 mixer
(the plain chunked scan, or the selective-scan kernel K8 after the fused
conv-and-SiLU kernel); the depthwise causal conv ``causal_conv1d`` lives
beside that kernel in ``repro_torch.kernels.causal_conv``.

Parameters keep the JAX layout -- ``wq`` is ``(d, H, hd)``, ``wo`` is
``(H, hd, d)``, ``w_gate`` is ``(d, f)``, never ``nn.Linear``'s transposed
``(out, in)`` -- so weights carry across by copying.  Every ``*_apply``
takes a mapping of tensors (a dict or an ``nn.ParameterDict``); every
``*_init`` draws a dict of tensors from a ``torch.Generator`` with the JAX
package's scales.  KV caches and recurrent states are written in place.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.distributed import ctx as _ctx
from repro_torch.distributed.place import is_dtensor
from repro_torch.kernels import causal_conv as kconv
from repro_torch.kernels import ops as kops
from repro_torch.kernels.causal_conv import causal_conv1d
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _init_dense(shape, dtype, generator, device, scale: Optional[float] = None):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def _tokens_whole(x):
    """x (B, S, ...) with only its batch dim left split: a DTensor whose
    sequence is split (sequence parallelism between blocks) is gathered
    over the sequence where a block's first projections read it, as
    Megatron's sequence parallelism does, and pending partial sums (a
    decode step's vocabulary-parallel embedding rows) are reduced;
    anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def _kv_whole(t):
    """k or v (B, T, K, hd) projected by a DTensor layer whose kv heads do
    not split over "model" (the rules then split head_dim): gathered over
    "model" right after the projection, so rope, the norm and attention read
    whole heads and the backward reduce-scatters the gradient back to the
    projection's layout; anything else as it is."""
    if not is_dtensor(t):
        return t
    names = t.device_mesh.mesh_dim_names
    if "model" not in names or t.shape[2] % t.device_mesh.size(names.index("model")) == 0:
        return t
    return _tokens_whole(t)


def _matmul_local(x, w):
    """``_matmul`` of DTensors whose weight is split on an inner dim of the
    ones the product flattens (a (d, K, hd) projection split on head_dim):
    each device contracts its own blocks, as DTensor cannot flatten a dim
    split inside (in every PyTorch release).  The result keeps x's splits
    of its leading dims and w's of its trailing ones; x's gradient is a
    partial sum over the mesh dims that split w, and w's over those that
    split x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    lead = x.ndim - 1
    x_pl, w_pl = tuple(x.placements), tuple(w.placements)
    out_pl, x_grad, w_grad = [], [], []
    for xp, wp in zip(x_pl, w_pl):
        x_split = isinstance(xp, Shard) and xp.dim < lead
        w_split = isinstance(wp, Shard) and wp.dim >= 1
        if x_split and w_split or isinstance(xp, Shard) and not x_split \
                or isinstance(wp, Shard) and not w_split \
                or not isinstance(xp, (Shard, Replicate)) \
                or not isinstance(wp, (Shard, Replicate)):
            raise ValueError(f"_matmul_local: {x_pl} x {w_pl}")
        out_pl.append(xp if x_split else Shard(lead - 1 + wp.dim) if w_split
                      else Replicate())
        x_grad.append(Partial() if w_split else xp)
        w_grad.append(Partial() if x_split else wp)
    xl = x.to_local(grad_placements=tuple(x_grad))
    wl = w.to_local(grad_placements=tuple(w_grad))
    out = torch.matmul(xl, wl.reshape(wl.shape[0], -1)).reshape(
        *xl.shape[:-1], *wl.shape[1:])
    shape = (*x.shape[:-1], *w.shape[1:])
    return DTensor.from_local(out, mesh, tuple(out_pl), run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract x's last dim with w's first: ``einsum("...d,d...->...")``.
    A weight split on a dim the product flattens -- an inner one, or one of
    extent 1 (one kv head "split" over a "model" axis of size 1), which
    DTensor's view rule will not flatten either -- takes ``_matmul_local``."""
    if is_dtensor(w) and w.ndim > 2 and any(
            getattr(p, "dim", 0) >= 2 or getattr(p, "dim", 0) == 1 and w.shape[1] == 1
            for p in w.placements):
        return _matmul_local(x, w)
    out = torch.matmul(x, w.reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #


def norm_init(cfg: ModelConfig, device, dim: Optional[int] = None) -> Params:
    dim = dim or cfg.d_model
    dt = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones((dim,), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dt, device=device)
    return p


def norm_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
        y = y * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS norm over the trailing head_dim (qwen3 qk_norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# Rotary embeddings ("full" neox-style, "half" = partial/interleaved a la GLM)
# --------------------------------------------------------------------------- #


def rope_tables(positions: torch.Tensor, rotary_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables: (..., seq, rotary_dim//2), f32."""
    half = rotary_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exponent)
    angles = positions.float()[..., None] * freqs   # (..., S, half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str) -> torch.Tensor:
    """x: (B, S, H, hd).  "full": rotate all dims (paired halves).
    "half": chatglm-style 2d rotary -- rotate only the first half of head_dim,
    interleaved pairing; the second half passes through."""
    if style == "none":
        return x
    hd = x.shape[-1]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    if style == "half":
        rot, keep = torch.split(x, hd // 2, dim=-1)
        xr = rot.float().reshape(*rot.shape[:-1], -1, 2)
        x1, x2 = xr[..., 0], xr[..., 1]
        o1 = x1 * c - x2 * s
        o2 = x2 * c + x1 * s
        out = torch.stack([o1, o2], dim=-1).reshape(rot.shape)
        return torch.cat([out.to(x.dtype), keep], dim=-1)
    # full, neox pairing (first half with second half)
    half = hd // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def rotary_dim_of(cfg: ModelConfig) -> int:
    return cfg.head_dim_ // 2 if cfg.rope_style == "half" else cfg.head_dim_


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #


def embed_init(cfg: ModelConfig, generator, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    p = {"tok": _init_dense((cfg.vocab_size, cfg.d_model), dt, generator,
                            device, scale=1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = _init_dense((cfg.d_model, cfg.vocab_size), dt,
                                   generator, device)
    return p


def vocab_local(t, ids, vdim: int):
    """A DTensor ``t`` split over at most one mesh dim on its vocabulary dim
    ``vdim`` (0 for the embedding table, the last for logits), read at
    token ids ``ids`` (a DTensor or plain): -> (the mesh dims that split
    the vocabulary, this device's ids less its shard's first id, clamped,
    and the mask of the ids inside its shard, or the ids and None when the
    vocabulary is whole)."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    vdim %= t.ndim
    split = [i for i, p in enumerate(t.placements)
             if isinstance(p, Shard) and p.dim % t.ndim == vdim]
    ids_l = ids.to_local() if is_dtensor(ids) else ids
    if not split:
        return split, ids_l, None
    (md,) = split
    n = t.shape[vdim] // mesh.size(md)
    v0 = mesh.get_local_rank(md) * n
    inside = (ids_l >= v0) & (ids_l < v0 + n)
    return split, (ids_l - v0).clamp(0, n - 1), inside


def _embed_sharded(tok, tokens):
    """The token embedding of DTensors in a local region (Megatron's
    vocabulary-parallel lookup): each device looks up the ids inside its
    vocabulary shard (zeros elsewhere) for its batch rows, and the rows are
    partial sums over the mesh dim that splits the vocabulary.  The table's
    gradient is a partial sum over the mesh dims that split the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = tok.device_mesh
    tok_pl = tuple(tok.placements)
    ids_pl = tuple(tokens.placements) if is_dtensor(tokens) else (Replicate(),) * mesh.ndim
    split, ids, inside = vocab_local(tok, tokens, 0)
    grad = tuple(Partial() if isinstance(ip, Shard) else tp
                 for ip, tp in zip(ids_pl, tok_pl))
    rows = tok.to_local(grad_placements=grad)[ids]
    if inside is not None:
        rows = rows * inside[..., None].to(rows.dtype)
    out_pl = tuple(Partial() if i in split else
                   (ip if isinstance(ip, Shard) else Replicate())
                   for i, ip in enumerate(ids_pl))
    shape = (*tokens.shape, tok.shape[1])
    return DTensor.from_local(rows, mesh, out_pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def embed_apply(p: Mapping, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the JAX package's cast-then-gather, elementwise
    tok = p["tok"]
    if is_dtensor(tok):
        x = _embed_sharded(tok, tokens).to(dtype_of(cfg.compute_dtype))
    else:
        x = tok[tokens].to(dtype_of(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    w = p["unembed"] if not cfg.tie_embeddings else p["tok"].T
    return torch.matmul(_tokens_whole(x.to(cd)), w.to(cd))


# --------------------------------------------------------------------------- #
# Attention (GQA; causal / sliding-window / prefix-LM; cached)
# --------------------------------------------------------------------------- #


def attn_init(cfg: ModelConfig, generator, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    d, hd = cfg.d_model, cfg.head_dim_
    H, K = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": _init_dense((d, H, hd), dt, generator, device),
        "wk": _init_dense((d, K, hd), dt, generator, device),
        "wv": _init_dense((d, K, hd), dt, generator, device),
        "wo": _init_dense((H, hd, d), dt, generator, device,
                          scale=1.0 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return p


class MaskSpec:
    """Attention-mask description; the (S_q, S_k) boolean mask itself is
    built lazily per q-chunk inside attention (a full 32k x 32k mask is 1 GB
    per device -- never materialize it)."""

    def __init__(self, *, causal: bool = True, window: Optional[int] = None,
                 prefix_len: int = 0, everything: bool = False):
        self.causal = causal
        self.window = window
        self.prefix_len = prefix_len
        self.everything = everything  # True -> no masking at all

    def build(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        """(B, S_q) x (B, S_k) -> (B, S_q, S_k) bool, or None if unmasked."""
        if self.everything:
            return None
        dq = q_pos[..., :, None]
        dk = k_pos[..., None, :]
        mask = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape),
                          dtype=torch.bool, device=q_pos.device)
        if self.causal:
            m = dk <= dq
            if self.prefix_len:
                m = m | (dk < self.prefix_len)
            mask = mask & m
        if self.window is not None:
            mask = mask & (dq - dk < self.window)
        return mask


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Masked softmax attention core (the plain attention, ``attn_impl="xla"``).
    q: (B,Sq,K,G,hd); k,v: (B,T,K,hd); mask: (B,Sq,T) bool or None.  The
    scores are scaled in the compute dtype, then cast to f32 and masked."""
    cd = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bkgst", q, k) * scale
    scores = scores.float()
    if cfg.attn_logit_softcap:
        cap = cfg.attn_logit_softcap
        scores = cap * torch.tanh(scores / cap)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(cd)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _write_cache(cache: Dict[str, torch.Tensor], k, v, cache_index) -> None:
    """Insert k, v (B, S, K, hd) into the layer's cache (B, S_max, K, hd) in
    place: at one shared position, or at one position per row (continuous
    batching; decode only, so S == 1)."""
    if is_dtensor(cache["k"]):
        # in a local region: each device writes its own rows and heads
        ck = cache["k"]
        mesh, pl = ck.device_mesh, ck.placements
        if torch.is_tensor(cache_index) and cache_index.dim():
            cache_index = _plain(cache_index)[_local_rows(ck)]
        _write_cache({"k": ck.to_local(), "v": cache["v"].to_local()},
                     k.redistribute(mesh, pl).to_local(),
                     v.redistribute(mesh, pl).to_local(), cache_index)
        return
    idx = cache_index
    if torch.is_tensor(idx) and idx.dim():
        rows = torch.arange(k.shape[0], device=k.device)
        idx = idx.to(device=k.device, dtype=torch.long)
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        return
    # a shared start, clamped so the update fits (lax.dynamic_update_slice)
    S, S_max = k.shape[1], cache["k"].shape[1]
    start = min(max(int(idx), 0), S_max - S)
    cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + S] = v.to(cache["v"].dtype)


def attn_apply(
    p: Mapping,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mask: Optional[MaskSpec] = None,
    q_pos: Optional[torch.Tensor] = None,
    k_pos: Optional[torch.Tensor] = None,
    kv_x: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index=None,
    static_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention.

    x: (B, S, D).  ``mask`` is a MaskSpec evaluated lazily against
    (q_pos, k_pos) -- per q-chunk when ``cfg.attn_q_chunk`` divides S, so the
    full (S, T) mask / score matrices are never materialized at long context.
    With ``cache`` (dict of k/v (B, S_max, K, hd)) and ``cache_index``:
    decode mode -- writes new k/v at cache_index (in place) and attends over
    the cache.  ``kv_x`` switches to cross-attention over its positions;
    with a cache and ``static_cache`` (or ``kv_x``) the cache holds the
    precomputed cross k/v, read as they are (no k-norm, no rope, no write).

    Under ``attn_impl="pallas"`` the flash-attention kernel K5 takes causal
    self-attention without prefix-LM masking where every live key is one of
    this call's own: without a cache (as the JAX package gates its Pallas
    kernel), and in a cached prefill -- ``cache_index`` the int 0, ``S > 1``
    rows that fit the cache, no logit softcap -- where it reads the cache
    rows just written (``forward`` passes q_pos 0..S-1 and k_pos
    0..S_max-1, so every row past S is causally masked on the plain path).
    K5 does not read q_pos or k_pos: a caller that passes the int
    ``cache_index`` 0 with other positions (a left-padded batch, say) gets
    K5's top-left causal mask under ``"pallas"``, and only the plain path
    honours its positions.
    """
    with tracing.span("attn"):
        cd = dtype_of(cfg.compute_dtype)
        B, S, _ = x.shape
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        G = H // K
        cross_cached = cache is not None and (static_cache or kv_x is not None)
        self_cached = cache is not None and not cross_cached

        xc = _tokens_whole(x.to(cd))
        q = _matmul(xc, p["wq"].to(cd))
        if cfg.qkv_bias:
            q = q + p["bq"].to(cd)
        if cross_cached:
            k, v = cache["k"].to(cd), cache["v"].to(cd)
        else:
            src = _tokens_whole(kv_x.to(cd)) if kv_x is not None else xc
            k = _matmul(src, p["wk"].to(cd))
            v = _matmul(src, p["wv"].to(cd))
            if cfg.qkv_bias:
                k = k + p["bk"].to(cd)
                v = v + p["bv"].to(cd)
            k, v = _kv_whole(k), _kv_whole(v)

        if cfg.qk_norm:
            q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
            if not cross_cached:
                k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)

        if rope is not None:
            tracing.count(f"rope.{cfg.rope_style}")
            with tracing.span("rope"):
                q = apply_rope(q, *rope, cfg.rope_style)
                if kv_x is None and not static_cache:
                    k = apply_rope(k, *rope, cfg.rope_style)

        if self_cached:
            assert cache_index is not None
            _write_cache(cache, k, v, cache_index)
            k, v = cache["k"].to(cd), cache["v"].to(cd)

        T = k.shape[1]
        if q_pos is None:
            q_pos = torch.arange(S, device=x.device).expand(B, S)
        if k_pos is None:
            k_pos = torch.arange(T, device=x.device).expand(B, T)
        if mask is None:
            mask = MaskSpec(everything=True)

        wo = p["wo"].to(cd).reshape(H * hd, -1)
        # K5, where the docstring says.  Like the JAX package's Pallas
        # kernel it assumes q_pos is the plain 0..S-1 range and ignores
        # attn_logit_softcap and attn_q_chunk, so a cached prefill with a
        # softcap stays plain.  It reads the (B, S, H, hd) projections and
        # the cache through strides and returns its output in q's memory
        # order.  On a mesh it runs on each device's local tensors
        # (``_attend_sharded``).
        fresh = cache is None or (
            self_cached and isinstance(cache_index, int) and cache_index == 0
            and 1 < S <= T and not cfg.attn_logit_softcap)
        k5 = (cfg.attn_impl == "pallas" and kv_x is None and fresh
              and not mask.everything and mask.prefix_len == 0 and mask.causal)
        tracing.count("attn.k5" if k5 else "attn.plain")
        if is_dtensor(q):
            ctx = _attend_sharded(q, k, v, q_pos, k_pos, mask, cfg, k5)
        elif k5:
            ctx = kops.flash_attention(
                q.transpose(1, 2), k[:, :S].transpose(1, 2), v[:, :S].transpose(1, 2),
                causal=True, window=mask.window).transpose(1, 2)
        else:
            ctx = _attend(q.reshape(B, S, K, G, hd), k, v, q_pos, k_pos, mask, cfg)
        out = torch.matmul(ctx.reshape(B, S, H * hd), wo)
        return out, cache if self_cached else None


def _attend(qg, k, v, q_pos, k_pos, mask: MaskSpec, cfg: ModelConfig):
    """The plain attention over grouped queries qg (B, S, K, G, hd) ->
    (B, S, K, G, hd); q-chunked when ``cfg.attn_q_chunk`` divides S."""
    S = qg.shape[1]
    qc = cfg.attn_q_chunk
    if qc and S > qc and S % qc == 0:
        # blockwise attention: loop over q chunks; scores stay (B,qc,T)
        return torch.cat([
            _sdpa(qg[:, i:i + qc], k, v, mask.build(q_pos[:, i:i + qc], k_pos), cfg)
            for i in range(0, S, qc)], dim=1)
    return _sdpa(qg, k, v, mask.build(q_pos, k_pos), cfg)


def _attend_sharded(q, k, v, q_pos, k_pos, mask: MaskSpec, cfg: ModelConfig,
                    k5: bool = False):
    """Attention of DTensor q (B, S, H, hd) over k, v (B, T, K, hd) in an
    explicit local region: each device attends its batch rows (split over
    the data axes) with its block of query heads (split over "model" when
    the heads divide, each block with the kv heads it reads, which are
    gathered over "model" when they do not split with it).  The result is
    (B, S, H, hd), laid out as the region's q.  Positions and the mask are
    the device's rows.  With ``k5`` (``attn_apply``'s gate, one for both
    paths) the kernel K5 attends the local tensors, over their first S keys
    (all of them without a cache; a cached prefill's rows just written)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    names, dp_axes, tp = _region_axes(mesh)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    dp = 1
    for a in dp_axes:
        dp *= mesh.size(names.index(a))
    n_tp = mesh.size(names.index(tp)) if tp else 1
    split_b = B % dp == 0
    H_loc = H // n_tp if tp and H % n_tp == 0 else H
    if H_loc % G == 0:
        K_loc, G_loc = H_loc // G, G
    elif G % H_loc == 0:
        K_loc, G_loc = 1, H_loc
    else:
        H_loc, K_loc, G_loc = H, K, G
    split_h = H_loc < H
    split_kv = split_h and K % n_tp == 0 and K_loc == K // n_tp

    def pl(head_split):
        out = [Replicate() for _ in names]
        for a in dp_axes:
            if split_b:
                out[names.index(a)] = Shard(0)
        if head_split:
            out[names.index(tp)] = Shard(2)
        return tuple(out)

    q_pl, kv_pl = pl(split_h), pl(split_kv)
    B_loc = B // dp if split_b else B
    b0 = 0
    if split_b:
        for a in dp_axes:
            b0 = b0 * mesh.size(names.index(a)) + mesh.get_local_rank(a)
        b0 *= B_loc
    j = mesh.get_local_rank(tp) if split_h else 0
    k0 = 0 if split_kv or not split_h else (j * H_loc) // G

    # kv heads gathered over "model" are read in part by each device: their
    # gradient is a partial sum over "model"
    kv_grad = tuple(Partial() if split_h and not split_kv and names[i] == tp else p
                    for i, p in enumerate(kv_pl))
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    vl = v.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
    if not split_kv:
        kl, vl = kl[:, :, k0:k0 + K_loc], vl[:, :, k0:k0 + K_loc]
    rows = slice(b0, b0 + B_loc)
    qp = _plain(q_pos)[rows] if q_pos.shape[0] == B else _plain(q_pos)
    kp = _plain(k_pos)[rows] if k_pos.shape[0] == B else _plain(k_pos)
    if k5:
        ctx = kops.flash_attention(
            ql.transpose(1, 2), kl[:, :S].transpose(1, 2), vl[:, :S].transpose(1, 2),
            causal=True, window=mask.window).transpose(1, 2)
    else:
        ctx = _attend(ql.reshape(B_loc, S, K_loc, G_loc, hd), kl, vl, qp, kp,
                      mask, cfg).reshape(B_loc, S, H_loc, hd)
    return _dtensor(ctx.contiguous(), mesh, q_pl, (B, S, H, hd))


def _local_rows(t) -> slice:
    """The rows of dim 0 of the DTensor ``t`` that this device holds."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    n, b0 = 1, 0
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == 0:
            b0 = b0 * mesh.size(i) + mesh.get_local_rank(i)
            n *= mesh.size(i)
    rows = t.shape[0] // n
    return slice(b0 * rows, (b0 + 1) * rows)


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def _region_axes(mesh):
    """(the mesh's dim names, its data axes, its "model" axis or None) for
    an explicit local region, from the active rules' ``shmap`` entry when
    there is one."""
    names = list(mesh.mesh_dim_names)
    info = _ctx.shmap_info()
    dp_axes = tuple(info[0]) if info else tuple(a for a in ("pod", "data") if a in names)
    tp = (info[1] if info else "model") if "model" in names else None
    return names, dp_axes, tp


def _dtensor(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """The DTensor of global ``shape`` (contiguous) whose shard on this
    device is ``local``, with placements ``pl``: a local region's result."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, tuple(pl), run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #


def mlp_init(cfg: ModelConfig, generator, device,
             d_ff: Optional[int] = None) -> Params:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": _init_dense((d, f), dt, generator, device),
            "w_up": _init_dense((d, f), dt, generator, device),
            "w_down": _init_dense((f, d), dt, generator, device),
        }
    # plain gelu (whisper)
    return {
        "w_up": _init_dense((d, f), dt, generator, device),
        "b_up": torch.zeros((f,), dtype=dt, device=device),
        "w_down": _init_dense((f, d), dt, generator, device),
        "b_down": torch.zeros((d,), dtype=dt, device=device),
    }


def mlp_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    with tracing.span("mlp"):
        cd = dtype_of(cfg.compute_dtype)
        x = _tokens_whole(x.to(cd))
        if cfg.mlp in ("swiglu", "geglu"):
            gate = torch.matmul(x, p["w_gate"].to(cd))
            up = torch.matmul(x, p["w_up"].to(cd))
            act = F.silu(gate) if cfg.mlp == "swiglu" else F.gelu(gate, approximate="tanh")
            return torch.matmul(act * up, p["w_down"].to(cd))
        h = torch.matmul(x, p["w_up"].to(cd)) + p["b_up"].to(cd)
        h = F.gelu(h, approximate="tanh")
        return torch.matmul(h, p["w_down"].to(cd)) + p["b_down"].to(cd)


# --------------------------------------------------------------------------- #
# Mixture of Experts
# --------------------------------------------------------------------------- #


def moe_init(cfg: ModelConfig, generator, device) -> Dict:
    m = cfg.moe
    assert m is not None
    dt = dtype_of(cfg.param_dtype)
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    p = {
        "router": _init_dense((d, E), dt, generator, device),
        # 1/sqrt(E): the JAX package scales by the leading dim
        "w_gate": _init_dense((E, d, f), dt, generator, device),
        "w_up": _init_dense((E, d, f), dt, generator, device),
        "w_down": _init_dense((E, f, d), dt, generator, device, scale=1.0 / math.sqrt(f)),
    }
    if m.n_shared_experts:
        fs = m.d_ff_shared * m.n_shared_experts
        p["shared"] = {
            "w_gate": _init_dense((d, fs), dt, generator, device),
            "w_up": _init_dense((d, fs), dt, generator, device),
            "w_down": _init_dense((fs, d), dt, generator, device),
        }
        p["shared_gate"] = _init_dense((d, 1), dt, generator, device)
    return p


def moe_apply(p: Mapping, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE.  x: (B, S, D) -> (y, aux_loss f32 scalar).

    impl="gmm": sort the T*k (token, expert) rows by expert (a stable sort,
    as ``jnp.argsort``) and run one matmul per expert that has rows on its
    contiguous slice -- the JAX package's ``lax.ragged_dot`` -- then add
    each row, weighted by its gate, back to its token.  Only those experts'
    weights are cast to the compute dtype.  impl="dense": every expert on
    every token.  impl="capacity": ``_moe_capacity``."""
    with tracing.span("moe"):
        if is_dtensor(x):
            return _moe_sharded(p, cfg, x)
        cd = dtype_of(cfg.compute_dtype)
        B, S, D = x.shape
        xt = x.reshape(B * S, D).to(cd)
        gates, idx, aux = _route(p, cfg, xt)
        return _experts(p, cfg, xt, gates, idx).reshape(B, S, D), aux


def _route(p: Mapping, cfg: ModelConfig, xt: torch.Tensor):
    """The router over tokens xt (T, D): -> (gates (T, k) f32, their
    experts (T, k), the Switch aux loss)."""
    m = cfg.moe
    assert m is not None
    cd = xt.dtype
    E, k = m.n_experts, m.top_k

    logits = torch.matmul(xt, p["router"].to(cd)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                 # (T, k)
    gates = gates / gates.sum(-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    # one-hot by comparison (F.one_hot validates its input on the CPU and
    # the card but not on meta, so its operations would differ by device)
    density = (idx[:, :1] == torch.arange(E, device=idx.device)).float().mean(0)
    router_prob = probs.mean(0)
    aux = (density * router_prob).sum() * E * m.aux_loss_weight
    return gates, idx, aux


def _shared_gate(p: Mapping, cfg: ModelConfig, xt: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(torch.matmul(xt, p["shared_gate"].to(xt.dtype)).float()
                         ).to(xt.dtype)


def _experts(p: Mapping, cfg: ModelConfig, xt: torch.Tensor, gates, idx,
             sg=None) -> torch.Tensor:
    """The routed experts (and the shared ones, weighted by ``sg``, their
    gate, computed here when not given) over tokens xt (T, D) -> (T, D)."""
    m = cfg.moe
    cd = xt.dtype
    T = xt.shape[0]
    E, k = m.n_experts, m.top_k
    act = F.silu if cfg.mlp == "swiglu" else functools.partial(F.gelu, approximate="tanh")
    if m.impl == "dense":
        # (T, E, f) -- every expert everywhere; only for tiny configs.
        h_g = torch.einsum("td,edf->tef", xt, p["w_gate"].to(cd))
        h_u = torch.einsum("td,edf->tef", xt, p["w_up"].to(cd))
        y_all = torch.einsum("tef,efd->ted", act(h_g) * h_u, p["w_down"].to(cd))
        combine = torch.zeros((T, E), dtype=cd, device=xt.device).scatter_add_(
            1, idx, gates.to(cd))
        y = torch.einsum("ted,te->td", y_all, combine)
    elif m.impl == "capacity":
        y = _moe_capacity(p, cfg, xt, gates, idx, act)
    else:
        flat_e = idx.reshape(-1)                               # (T*k,)
        order = torch.argsort(flat_e, stable=True)
        token_of = order // k
        xs = xt[token_of]                                      # (T*k, D) grouped
        sizes = _expert_sizes(flat_e, E)
        # each expert's rows in turn, joined by one cat (whose backward
        # splits, where slice writes would make per-expert zero fills)
        parts = []
        start = 0
        for e, n in enumerate(sizes):
            if n:
                rows = slice(start, start + n)
                h = act(torch.matmul(xs[rows], p["w_gate"][e].to(cd))) \
                    * torch.matmul(xs[rows], p["w_up"][e].to(cd))
                parts.append(torch.matmul(h, p["w_down"][e].to(cd)))
                start += n
        out = torch.cat(parts) if parts else torch.empty_like(xs)
        w = gates.reshape(-1)[order].to(cd)[:, None]
        y = _combine(out * w, order, T, k)

    if m.n_shared_experts:
        sh = p["shared"]
        g = torch.matmul(xt, sh["w_gate"].to(cd))
        u = torch.matmul(xt, sh["w_up"].to(cd))
        ys = torch.matmul(act(g) * u, sh["w_down"].to(cd))
        if sg is None:
            sg = _shared_gate(p, cfg, xt)
        y = y + ys * sg
    return y


def _moe_sharded(p: Mapping, cfg: ModelConfig, x):
    """``moe_apply`` of a DTensor x (B, S, D), the JAX package's Megatron-MoE
    dataflow: the router (and the shared experts' gate) runs as DTensor
    operations on the tokens, split over the data axes and whole over
    "model"; then, in an explicit local region (its ``shard_map``), each
    device sends its data shard's tokens (one routing group a shard)
    through every expert's slice of the ffn dim (split over "model"; the
    experts' other splits are gathered), combines them with their gates
    into token-sized partial outputs, and one all-reduce over "model" sums
    them.  The gates' and the tokens' gradients from the region are
    partial sums over "model", the weights' over the data axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    info = _ctx.shmap_info()
    dp_axes = tuple(info[0]) if info else tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    B, S, D = x.shape
    dp = 1
    for a in dp_axes:
        dp *= mesh.size(names.index(a))
    n_tp = mesh.size(names.index(tp)) if tp else 1
    split_b = B % dp == 0
    cd = dtype_of(cfg.compute_dtype)
    m = cfg.moe

    tok_pl = tuple(Shard(0) if split_b and a in dp_axes else Replicate() for a in names)
    xt = x.redistribute(mesh, tok_pl).reshape(B * S, D).to(cd)
    gates, idx, aux = _route(p, cfg, xt)
    sg = _shared_gate(p, cfg, xt) if m.n_shared_experts else None
    split = tp is not None and m.d_ff_expert % n_tp == 0 and (
        not m.n_shared_experts or m.d_ff_shared * m.n_shared_experts % n_tp == 0)
    # what the region reads whole on every "model" rank for its ffn slice
    # gets a partial sum over "model" as its gradient
    part = tuple(Partial() if split and a == tp else q for a, q in zip(names, tok_pl))

    def local(w, dim):
        """w's local block, split over "model" on ``dim`` (when the ffn
        splits); each data shard's tokens make a partial sum of its
        gradient."""
        want = tuple(Shard(dim) if split and a == tp else Replicate() for a in names)
        grad = tuple(Partial() if split_b and a in dp_axes else q
                     for a, q in zip(names, want))
        return w.redistribute(mesh, want).to_local(grad_placements=grad)

    lp = {"w_gate": local(p["w_gate"], 2), "w_up": local(p["w_up"], 2),
          "w_down": local(p["w_down"], 1)}
    if m.n_shared_experts:
        sh = p["shared"]
        lp["shared"] = {"w_gate": local(sh["w_gate"], 1), "w_up": local(sh["w_up"], 1),
                        "w_down": local(sh["w_down"], 0)}
        sg = sg.redistribute(mesh, tok_pl).to_local(grad_placements=part)
    y = _experts(lp, cfg, xt.to_local(grad_placements=part),
                 gates.redistribute(mesh, tok_pl).to_local(grad_placements=part),
                 idx.redistribute(mesh, tok_pl).to_local(), sg)
    y = DTensor.from_local(y, mesh, part, run_check=False, shape=(B * S, D),
                           stride=(D, 1)).redistribute(mesh, tok_pl)
    return y.reshape(B, S, D), aux


def _expert_sizes(flat_e: torch.Tensor, E: int):
    """Rows routed to each of the E experts.  A ``meta`` tensor holds no
    routing, so there the T*k rows are split evenly over the experts: the
    experts' matmul FLOPs are the same for any split, and a real run's
    operation and byte counts equal these whenever every expert gets at
    least one row (``repro_torch.core.costs.OpCounter``)."""
    if flat_e.device.type == "meta":
        n = flat_e.numel()
        return [n // E + (e < n % E) for e in range(E)]
    return torch.bincount(flat_e, minlength=E).tolist()


def _moe_capacity(p: Mapping, cfg: ModelConfig, xt: torch.Tensor,
                  gates: torch.Tensor, idx: torch.Tensor, act) -> torch.Tensor:
    """Capacity-based MoE dispatch (the GShard / Switch dataflow): each
    expert takes at most C rows, in sorted order, into an (E, C, D) buffer
    and the experts run as one batched product; rows past C are dropped.
    One routing group: outside a mesh the JAX package's
    ``data_parallel_groups()`` is 1."""
    m = cfg.moe
    cd = xt.dtype
    T, D = xt.shape
    E, k = m.n_experts, m.top_k
    C = min(T * k, int(-(-T * k * m.capacity_factor // E)))
    dev = xt.device

    flat_e = idx.reshape(-1)                                   # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    token_of = order // k
    counts = (torch.bincount(flat_e, minlength=E) if dev.type != "meta"
              else flat_e.new_empty(E))   # no routing on meta: shapes only
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=dev) - starts[sorted_e]  # rank within expert
    keep = slot < C
    buf = torch.zeros((E, C, D), dtype=cd, device=dev)
    if dev.type == "meta":
        # no routing to drop rows by: every row is written (into slot
        # C - 1 past C), so a meta count of this dispatch's scatter moves
        # T*k rows where a real run moves the kept ones
        buf[sorted_e, slot.clamp_max(C - 1)] = xt[token_of]
    else:
        buf[sorted_e[keep], slot[keep]] = xt[token_of[keep]]   # past C: dropped
    h = act(torch.matmul(buf, p["w_gate"].to(cd))) * torch.matmul(buf, p["w_up"].to(cd))
    out = torch.matmul(h, p["w_down"].to(cd))                  # (E, C, D)
    rows = out[sorted_e, slot.clamp_max(C - 1)]
    w = gates.to(cd).reshape(-1)[order] * keep.to(cd)
    return _combine(rows * w[:, None], order, T, k)


def _combine(rows: torch.Tensor, order: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Each token's k weighted expert rows, given in expert order (``order``
    the sort that put them there), summed per token in its own top-k order.
    The JAX package scatter-adds them; a sum in a fixed order is the same
    up to rounding and, unlike a scatter-add on the card, deterministic."""
    by_token = torch.empty_like(rows)
    by_token[order] = rows
    return by_token.view(T, k, -1).sum(1)


# --------------------------------------------------------------------------- #
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------- #

_LRU_BLOCKS = 8      # block-diagonal gate structure
_LRU_C = 8.0


def rglru_init(cfg: ModelConfig, generator, device) -> Params:
    h = cfg.hybrid
    assert h is not None
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    w = h.lru_width or d
    wb = w // _LRU_BLOCKS
    return {
        "w_x": _init_dense((d, w), dt, generator, device),
        "w_y": _init_dense((d, w), dt, generator, device),
        "conv_w": _init_dense((h.conv_width, w), dt, generator, device, scale=0.1),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "gate_a": _init_dense((_LRU_BLOCKS, wb, wb), dt, generator, device),
        "gate_x": _init_dense((_LRU_BLOCKS, wb, wb), dt, generator, device),
        "lambda": torch.full((w,), 2.0, dtype=dt, device=device),  # softplus param for decay a
        "w_out": _init_dense((w, d), dt, generator, device),
    }


def _differentiated(*tensors: torch.Tensor) -> bool:
    """True when autograd records ops on ``tensors``: the step loops then
    build each step's state as a new tensor (``out=`` writes cannot be
    differentiated) and take the steps' inputs by ``unbind``, whose
    backward is one stack where indexing each step would fill a zero
    tensor of the whole sequence per step; the values are the same."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _lru_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t over axis 1, step by step as the JAX
    package's ``lax.scan`` (no reassociated parallel scan, which would
    round otherwise).  a, bx: (B, S, W) f32 -> (ys (B, S, W), hT (B, W))."""
    a_t = a.transpose(0, 1).contiguous()
    b_t = bx.transpose(0, 1).contiguous()
    if _differentiated(a_t, b_t, h0):
        steps = []
        h = h0
        for a_s, b_s in zip(a_t.unbind(0), b_t.unbind(0)):
            h = torch.addcmul(b_s, a_s, h)
            steps.append(h)
        return torch.stack(steps, 1), h
    hs = torch.empty_like(a_t)
    h = h0
    for t in range(a_t.shape[0]):
        h = torch.addcmul(b_t[t], a_t[t], h, out=hs[t])
    return hs.transpose(0, 1), h


def rglru_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Recurrent block: [x->conv->RG-LRU] gated by GeLU(y-branch), x (B, S,
    D) -> (B, S, D) in the compute dtype.  The gates and the recurrence run
    in float32.  With ``state`` (a layer's ``{"conv": (B, width-1, W),
    "lru": (B, W)}`` cache views) the conv and the recurrence start from it
    and the new states are written back into it in place."""
    h = cfg.hybrid
    assert h is not None
    cd = dtype_of(cfg.compute_dtype)
    x = _tokens_whole(x.to(cd))
    B, S, _ = x.shape
    w = p["w_x"].shape[1]
    wb = w // _LRU_BLOCKS

    xb = torch.matmul(x, p["w_x"].to(cd))
    yb = F.gelu(torch.matmul(x, p["w_y"].to(cd)), approximate="tanh")
    xb, new_conv = causal_conv1d(xb, p["conv_w"], p["conv_b"],
                                 state["conv"] if state is not None else None)

    # block-diagonal gates
    xg = xb.reshape(B, S, _LRU_BLOCKS, wb).float()
    r = torch.sigmoid(torch.einsum("bshw,hwe->bshe", xg, p["gate_a"].float())
                      .reshape(B, S, w))
    i = torch.sigmoid(torch.einsum("bshw,hwe->bshe", xg, p["gate_x"].float())
                      .reshape(B, S, w))

    log_a = -_LRU_C * kref.softplus(p["lambda"].float()) * r
    a = torch.exp(log_a)
    gated = i * xb.float()
    bx = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-8)) * gated

    h0 = state["lru"] if state is not None else x.new_zeros((B, w), dtype=torch.float32)
    ys, hT = _lru_scan(a, bx, h0)
    if state is not None:
        state["conv"].copy_(new_conv)
        state["lru"].copy_(hT)
    return torch.matmul(ys.to(cd) * yb, p["w_out"].to(cd))


# --------------------------------------------------------------------------- #
# Mamba-1 block (falcon-mamba)
# --------------------------------------------------------------------------- #


def mamba_init(cfg: ModelConfig, generator, device) -> Params:
    s = cfg.ssm
    assert s is not None
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = s.dt_rank or -(-d // 16)
    n = s.state_dim
    u = (torch.empty((d_in,), device=device) if torch.device(device).type == "meta"
         else torch.rand((d_in,), generator=generator, device=device))
    return {
        "w_in": _init_dense((d, 2 * d_in), dt, generator, device),
        "conv_w": _init_dense((s.conv_width, d_in), dt, generator, device, scale=0.5),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=device),
        "w_xdbc": _init_dense((d_in, dt_rank + 2 * n), dt, generator, device),
        "w_dt": _init_dense((dt_rank, d_in), dt, generator, device),
        "dt_bias": torch.log(torch.expm1(
            (u * 0.1 + 0.001).clamp_min(1e-4))).to(dt),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device)
                           ).repeat(d_in, 1).to(dt),
        "D": torch.ones((d_in,), dtype=dt, device=device),
        "w_out": _init_dense((d_in, d), dt, generator, device),
    }


def _ssm_scan(xi: torch.Tensor, dt_in: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, w_dt: torch.Tensor, dt_bias: torch.Tensor,
              A: torch.Tensor, h0: torch.Tensor, chunk: int = 256
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain selective-scan core (``attn_impl="xla"``) -> (y f32
    (B, S, Din), hT f32 (B, Din, N)).

    Chunked as the JAX package's ``_ssm_scan``: each chunk's discretised
    dA / dBx (chunk, B, Din, N) are computed for that chunk only, then the
    recurrence steps through it.  ``softplus`` is JAX's
    (``repro_torch.kernels.ref.softplus``)."""
    B, S, Din = xi.shape
    if S % chunk != 0:
        chunk = S   # one chunk for odd sizes (decode, tests)
    h = h0.float()
    wf, bf = w_dt.float(), dt_bias.float()
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dt = kref.softplus(torch.matmul(dt_in[:, sl].float(), wf) + bf)
        dt = dt.transpose(0, 1)                                  # (chunk, B, Din)
        dA = torch.exp(dt[..., None] * A)                        # (chunk, B, Din, N)
        dBx = (dt * xi[:, sl].float().transpose(0, 1))[..., None] \
            * Bm[:, sl].float().transpose(0, 1)[:, :, None, :]
        if _differentiated(dA, dBx, h):
            steps = []
            for dA_s, dBx_s in zip(dA.unbind(0), dBx.unbind(0)):
                h = torch.addcmul(dBx_s, dA_s, h)
                steps.append(h)
            hs = torch.stack(steps)
        else:
            hs = torch.empty_like(dA)
            for t in range(dA.shape[0]):
                h = torch.addcmul(dBx[t], dA[t], h, out=hs[t])
        Cf = Cm[:, sl].float().transpose(0, 1)                   # (chunk, B, N)
        ys.append(torch.einsum("tbdn,tbn->btd", hs, Cf))
    return torch.cat(ys, dim=1), h


def _scan_sharded(xi, dt_raw, Bm, Cm, A, h0):
    """K8 in an explicit local region, for DTensor inputs: each device scans
    its (B_loc, S, Din_loc) block -- its batch rows (split over the data
    axes) and its channels (split over "model"), each channel independent
    of the others -- reading ``Bm`` and ``Cm`` (B, S, N) whole over "model".
    ``h0``, a layer's view of the cache's "ssm" entry (the "ssm_state"
    layout: rows over the data axes, channels over "model"), is read and
    written in place in this device's shard.  -> y (B, S, Din) float32,
    laid out as the region's xi."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = xi.device_mesh
    names, dp_axes, tp = _region_axes(mesh)
    B, S, Din = xi.shape
    dp = math.prod(mesh.size(names.index(a)) for a in dp_axes)
    split_b = B % dp == 0
    split_d = tp is not None and Din % mesh.size(names.index(tp)) == 0

    def pl(b_dim, d_dim):
        out = [Replicate() for _ in names]
        for a in dp_axes if split_b and b_dim is not None else ():
            out[names.index(a)] = Shard(b_dim)
        if split_d and d_dim is not None:
            out[names.index(tp)] = Shard(d_dim)
        return tuple(out)

    def local(t, placements):
        return t.redistribute(mesh, placements).to_local()

    x_pl, h_pl, bc_pl = pl(0, 2), pl(0, 1), pl(0, None)
    hl = None
    if h0 is not None:
        if not is_dtensor(h0) or tuple(h0.placements) != h_pl:
            raise ValueError("the sharded scan writes its state in place into "
                             f"the cache's shard laid out as {h_pl}; got "
                             f"{getattr(h0, 'placements', 'a plain tensor')}")
        hl = h0.to_local()
    y, _ = kops.selective_scan(local(xi, x_pl), local(dt_raw, x_pl), local(Bm, bc_pl),
                               local(Cm, bc_pl), local(A, pl(None, 0)).contiguous(),
                               hl, y_dtype=torch.float32, out_state=hl)
    return _dtensor(y, mesh, x_pl, (B, S, Din))


def mamba_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                scan_chunk: int = 256) -> torch.Tensor:
    """The Mamba-1 mixer over x (B, S, D) -> (B, S, D) in the compute dtype.

    With ``state`` (a layer's ``{"conv": (B, width-1, Din), "ssm": (B, Din,
    N)}`` cache views) the conv and scan start from it and the new states
    are written back into it in place.  Under ``cfg.attn_impl == "pallas"``
    the scan is the kernel K8, fed float32 ``dt_raw = dt_in @ w_dt +
    dt_bias`` and asked for float32 ``y`` (on a mesh in a local region,
    ``_scan_sharded``); otherwise the plain ``_ssm_scan``.  Under
    ``"pallas"`` the conv, its bias and SiLU on a plain tensor are one
    kernel (``kops.causal_conv_silu``, the plain result bit for bit) unless
    autograd records them or the conv's width is not the kernel's 4; a
    DTensor and the ``"xla"`` path take the plain ``causal_conv1d`` and
    ``F.silu``.  Each call counts ``conv.fused`` (the
    kernel ran) or ``conv.plain``."""
    with tracing.span("mixer"):
        s = cfg.ssm
        assert s is not None
        cd = dtype_of(cfg.compute_dtype)
        x = _tokens_whole(x.to(cd))
        n = s.state_dim
        dt_rank = p["w_dt"].shape[0]

        xz = torch.matmul(x, p["w_in"].to(cd))
        xi, z = xz.chunk(2, dim=-1)

        conv_state = state["conv"] if state is not None else None
        with tracing.span("conv"):
            fused = (cfg.attn_impl == "pallas" and not is_dtensor(xi)
                     and p["conv_w"].shape[0] == kconv.WIDTH
                     and not _differentiated(xi, p["conv_w"], p["conv_b"]))
            if fused:
                xi, new_conv = kops.causal_conv_silu(xi, p["conv_w"], p["conv_b"],
                                                     conv_state)
            else:
                xi, new_conv = causal_conv1d(xi, p["conv_w"], p["conv_b"], conv_state)
                xi = F.silu(xi)
            tracing.count("conv.fused" if fused and xi.is_cuda else "conv.plain")

        dbc = torch.matmul(xi, p["w_xdbc"].to(cd))
        if cfg.attn_impl == "pallas":
            # K8 reads B and C whole on every device of a mesh: the partial sums
            # of the Din-split product are reduced once, before its region
            dbc = _tokens_whole(dbc)
        dt_in, Bm, Cm = torch.split(dbc, [dt_rank, n, n], dim=-1)

        A = -torch.exp(p["A_log"].float())                          # (Din, N)
        h0 = state["ssm"] if state is not None else None
        if cfg.attn_impl == "pallas":
            dt_raw = torch.matmul(dt_in.float(), p["w_dt"].float()) + p["dt_bias"].float()
            with tracing.span("scan"):
                if is_dtensor(xi):
                    y = _scan_sharded(xi, dt_raw, Bm, Cm, A, h0)
                else:
                    y, _ = kops.selective_scan(xi, dt_raw, Bm, Cm, A, h0,
                                               y_dtype=torch.float32, out_state=h0)
        else:
            if h0 is None:
                h0 = x.new_zeros((x.shape[0], xi.shape[-1], n), dtype=torch.float32)
            with tracing.span("scan"):
                y, hT = _ssm_scan(xi, dt_in, Bm, Cm, p["w_dt"], p["dt_bias"], A, h0,
                                  chunk=scan_chunk)
            if state is not None:
                state["ssm"].copy_(hT)
        if state is not None:
            state["conv"].copy_(new_conv)
        y = y + p["D"].float() * xi.float()
        y = y.to(cd) * F.silu(z)
        return torch.matmul(y, p["w_out"].to(cd))


# --------------------------------------------------------------------------- #
# Logical axes (the JAX package's ``*_init`` second results)
# --------------------------------------------------------------------------- #
#
# Each layer's parameters carry a tuple of logical axis names per tensor
# ("embed", "heads", "mlp", "experts", "vocab", ...), which the sharding
# rules (``repro_torch.distributed.sharding``) map onto mesh axes.  The
# trees mirror the ``*_init`` dicts above key for key.


def norm_axes(cfg: ModelConfig) -> Dict:
    a = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        a["bias"] = ("embed",)
    return a


def embed_axes(cfg: ModelConfig) -> Dict:
    a = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["unembed"] = ("embed", "vocab")
    return a


def attn_axes(cfg: ModelConfig) -> Dict:
    a = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        a.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    if cfg.qk_norm:
        a.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return a


def mlp_axes(cfg: ModelConfig) -> Dict:
    if cfg.mlp in ("swiglu", "geglu"):
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
    return {"w_up": ("embed", "mlp"), "b_up": ("mlp",),
            "w_down": ("mlp", "embed"), "b_down": ("embed",)}


def moe_axes(cfg: ModelConfig) -> Dict:
    a = {"router": ("embed", None),
         "w_gate": ("experts", "embed", "mlp"),
         "w_up": ("experts", "embed", "mlp"),
         "w_down": ("experts", "mlp", "embed")}
    if cfg.moe.n_shared_experts:
        a["shared"] = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                       "w_down": ("mlp", "embed")}
        a["shared_gate"] = ("embed", None)
    return a


def rglru_axes(cfg: ModelConfig) -> Dict:
    return {"w_x": ("embed", "mlp"), "w_y": ("embed", "mlp"),
            "conv_w": ("conv", "mlp"), "conv_b": ("mlp",),
            "gate_a": (None, "mlp_block", "mlp_block"),
            "gate_x": (None, "mlp_block", "mlp_block"),
            "lambda": ("mlp",), "w_out": ("mlp", "embed")}


def mamba_axes(cfg: ModelConfig) -> Dict:
    return {"w_in": ("embed", "mlp"), "conv_w": ("conv", "mlp"),
            "conv_b": ("mlp",), "w_xdbc": ("mlp", None), "w_dt": (None, "mlp"),
            "dt_bias": ("mlp",), "A_log": ("mlp", "state"), "D": ("mlp",),
            "w_out": ("mlp", "embed")}

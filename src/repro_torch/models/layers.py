"""Neural net layers of the dense and SSM model stacks, in PyTorch.

The dense and SSM subset of the JAX package's ``repro/models/layers.py``:
norms, rotary embeddings, embedding and unembedding, GQA attention (causal,
sliding-window and prefix-LM masks; q-chunked; KV-cached with a scalar or
per-row write index; or the flash-attention kernel K5), the MLPs, the
depthwise causal conv and the Mamba-1 mixer (the plain chunked scan, or the
selective-scan kernel K8).  The MoE and RG-LRU blocks come with a later
slice (ROADMAP.md, Queue 1).

Parameters keep the JAX layout -- ``wq`` is ``(d, H, hd)``, ``wo`` is
``(H, hd, d)``, ``w_gate`` is ``(d, f)``, never ``nn.Linear``'s transposed
``(out, in)`` -- so weights carry across by copying.  Every ``*_apply``
takes a mapping of tensors (a dict or an ``nn.ParameterDict``); every
``*_init`` draws a dict of tensors from a ``torch.Generator`` with the JAX
package's scales.  KV caches and recurrent states are written in place.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _init_dense(shape, dtype, generator, device, scale: Optional[float] = None):
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Contract x's last dim with w's first: ``einsum("...d,d...->...")``."""
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


def embed_apply(p: Mapping, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast: the JAX package's cast-then-gather, elementwise
    x = p["tok"][tokens].to(dtype_of(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    w = p["unembed"] if not cfg.tie_embeddings else p["tok"].T
    return torch.matmul(x.to(cd), w.to(cd))


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
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention.

    x: (B, S, D).  ``mask`` is a MaskSpec evaluated lazily against
    (q_pos, k_pos) -- per q-chunk when ``cfg.attn_q_chunk`` divides S, so the
    full (S, T) mask / score matrices are never materialized at long context.
    With ``cache`` (dict of k/v (B, S_max, K, hd)) and ``cache_index``:
    decode mode -- writes new k/v at cache_index (in place) and attends over
    the cache.  Cross-attention (the JAX package's ``kv_x`` /
    ``static_cache``) comes with the audio family.
    """
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // K

    xc = x.to(cd)
    q = _matmul(xc, p["wq"].to(cd))
    k = _matmul(xc, p["wk"].to(cd))
    v = _matmul(xc, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)

    if cfg.qk_norm:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)

    if rope is not None:
        q = apply_rope(q, *rope, cfg.rope_style)
        k = apply_rope(k, *rope, cfg.rope_style)

    if cache is not None:
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
    # The flash-attention kernel K5, gated as the JAX package gates its
    # Pallas kernel: self-attention without a cache or prefix-LM masking,
    # causal.  Like that kernel it assumes q_pos is the plain 0..S-1 range
    # (full-sequence forward) and ignores attn_logit_softcap and
    # attn_q_chunk.  It reads the (B, S, H, hd) projections through
    # strides and returns its output in the same memory order.
    if (cfg.attn_impl == "pallas" and cache is None and not mask.everything
            and mask.prefix_len == 0 and mask.causal):
        ctx = kops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=mask.window).transpose(1, 2)
        return torch.matmul(ctx.reshape(B, S, H * hd), wo), None

    qg = q.reshape(B, S, K, G, hd)
    qc = cfg.attn_q_chunk
    if qc and S > qc and S % qc == 0:
        # blockwise attention: loop over q chunks; scores stay (B,qc,T)
        ctx = torch.cat([
            _sdpa(qg[:, i:i + qc], k, v, mask.build(q_pos[:, i:i + qc], k_pos), cfg)
            for i in range(0, S, qc)], dim=1)
    else:
        ctx = _sdpa(qg, k, v, mask.build(q_pos, k_pos), cfg)
    out = torch.matmul(ctx.reshape(B, S, H * hd), wo)
    return out, cache


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
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    if cfg.mlp in ("swiglu", "geglu"):
        gate = torch.matmul(x, p["w_gate"].to(cd))
        up = torch.matmul(x, p["w_up"].to(cd))
        act = F.silu(gate) if cfg.mlp == "swiglu" else F.gelu(gate, approximate="tanh")
        return torch.matmul(act * up, p["w_down"].to(cd))
    h = torch.matmul(x, p["w_up"].to(cd)) + p["b_up"].to(cd)
    h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, p["w_down"].to(cd)) + p["b_down"].to(cd)


# --------------------------------------------------------------------------- #
# Depthwise causal conv + Mamba-1 block (falcon-mamba)
# --------------------------------------------------------------------------- #


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over (B, S, C); w: (width, C).

    Returns (y, new_state), the state being the last ``width - 1`` inputs
    for decode.  Accumulates in ``x``'s dtype, tap by tap in the JAX
    package's order, with no convolution library (whose TF32 and summation
    order would differ)."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y, new_state


def mamba_init(cfg: ModelConfig, generator, device) -> Params:
    s = cfg.ssm
    assert s is not None
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_in = s.expand * d
    dt_rank = s.dt_rank or -(-d // 16)
    n = s.state_dim
    u = torch.rand((d_in,), generator=generator, device=device)
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
        hs = torch.empty_like(dA)
        for t in range(dA.shape[0]):
            h = torch.addcmul(dBx[t], dA[t], h, out=hs[t])
        Cf = Cm[:, sl].float().transpose(0, 1)                   # (chunk, B, N)
        ys.append(torch.einsum("tbdn,tbn->btd", hs, Cf))
    return torch.cat(ys, dim=1), h


def mamba_apply(p: Mapping, cfg: ModelConfig, x: torch.Tensor, *,
                state: Optional[Dict[str, torch.Tensor]] = None,
                scan_chunk: int = 256) -> torch.Tensor:
    """The Mamba-1 mixer over x (B, S, D) -> (B, S, D) in the compute dtype.

    With ``state`` (a layer's ``{"conv": (B, width-1, Din), "ssm": (B, Din,
    N)}`` cache views) the conv and scan start from it and the new states
    are written back into it in place.  Under ``cfg.attn_impl == "pallas"``
    the scan is the kernel K8, fed float32 ``dt_raw = dt_in @ w_dt +
    dt_bias`` and asked for float32 ``y``; otherwise the plain
    ``_ssm_scan``."""
    s = cfg.ssm
    assert s is not None
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    n = s.state_dim
    dt_rank = p["w_dt"].shape[0]

    xz = torch.matmul(x, p["w_in"].to(cd))
    xi, z = xz.chunk(2, dim=-1)

    xi, new_conv = causal_conv1d(xi, p["conv_w"], p["conv_b"],
                                 state["conv"] if state is not None else None)
    xi = F.silu(xi)

    dbc = torch.matmul(xi, p["w_xdbc"].to(cd))
    dt_in, Bm, Cm = torch.split(dbc, [dt_rank, n, n], dim=-1)

    A = -torch.exp(p["A_log"].float())                          # (Din, N)
    h0 = state["ssm"] if state is not None else None
    if cfg.attn_impl == "pallas":
        dt_raw = torch.matmul(dt_in.float(), p["w_dt"].float()) + p["dt_bias"].float()
        y, _ = kops.selective_scan(xi, dt_raw, Bm, Cm, A, h0, y_dtype=torch.float32,
                                   out_state=h0)
    else:
        if h0 is None:
            h0 = x.new_zeros((x.shape[0], xi.shape[-1], n), dtype=torch.float32)
        y, hT = _ssm_scan(xi, dt_in, Bm, Cm, p["w_dt"], p["dt_bias"], A, h0,
                          chunk=scan_chunk)
        if state is not None:
            state["ssm"].copy_(hT)
    if state is not None:
        state["conv"].copy_(new_conv)
    y = y + p["D"].float() * xi.float()
    y = y.to(cd) * F.silu(z)
    return torch.matmul(y, p["w_out"].to(cd))

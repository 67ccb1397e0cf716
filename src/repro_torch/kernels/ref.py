"""Plain PyTorch versions of the port's model kernels (the correctness
contract, as ``repro/kernels/ref.py`` is for the JAX package's).

Each ``*_ref`` is the mathematically transparent version its kernel is
held to: the CPU tests run it against the JAX package, and
``chip_smoke.py`` holds the kernel to it on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention_ref(
    q: torch.Tensor,              # (B, H, S, D)
    k: torch.Tensor,              # (B, K, T, D)
    v: torch.Tensor,              # (B, K, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked softmax attention with GQA (query head ``h`` reads KV head
    ``h // (H // K)``), in float32, cast back to ``q``'s dtype.  Masked
    scores are -1e30; rows with no live key come out 0, as the kernel's
    ``l == 0`` rows do."""
    B, H, S, D = q.shape
    _, K, T, _ = k.shape
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, K, G, S, D).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows give uniform probs in softmax; zero them as the
    # kernel does (l == 0 -> output 0)
    probs = probs * mask.any(dim=-1)[:, None]
    out = torch.einsum("bkgst,bktd->bkgsd", probs, vf)
    return out.reshape(B, H, S, D).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in float32,
    cast back to ``x``'s dtype (K6)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_residual_ref(
    x: torch.Tensor, residual: torch.Tensor, scale: torch.Tensor, *,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h = x + residual`` in float32 -> ``(rmsnorm(h) * scale, h)``, both
    in ``x``'s dtype (K7).

    This is what the Pallas kernel computes (``repro/kernels/rmsnorm.py``,
    ``_rmsnorm_residual_kernel``): it normalises the float32 sum ``h``.
    The JAX package's ``ref.rmsnorm_residual_ref`` first rounds ``h`` to
    ``x.dtype`` and normalises that.  The two agree in float32; in bfloat16
    the normed output differs by the rounding of ``h`` (up to one bf16 step
    of the output).  The port follows the kernel.
    """
    h = x.float() + residual.float()
    ms = h.square().mean(-1, keepdim=True)
    normed = (h * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)
    return normed, h.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as JAX's ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``.  Not
    ``torch.nn.functional.softplus``, which returns ``x`` itself above its
    threshold of 20: the scan kernel K8 evaluates this same formula for
    every input, so the plain versions and the kernel agree everywhere."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def selective_scan_ref(
    xi: torch.Tensor,       # (B, S, Din)
    dt_raw: torch.Tensor,   # (B, S, Din) pre-softplus
    Bm: torch.Tensor,       # (B, S, N)
    Cm: torch.Tensor,       # (B, S, N)
    A: torch.Tensor,        # (Din, N), negative
    h0: Optional[torch.Tensor] = None,   # (B, Din, N)
    *,
    y_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan (K8): with ``dt = softplus(dt_raw)``, each
    step is ``h = exp(dt * A) * h + (dt * xi) * B`` and ``y = sum_n h * C``,
    all in float32 from ``h0`` (zeros when None).  Returns ``y`` in
    ``y_dtype`` (``xi``'s dtype by default) and the last state ``hT``
    (B, Din, N) in float32."""
    B, S, Din = xi.shape
    N = A.shape[1]
    h = (torch.zeros((B, Din, N), dtype=torch.float32, device=xi.device)
         if h0 is None else h0.float())
    dt = softplus(dt_raw.float())
    dtx = dt * xi.float()
    Af = A.float()
    Bf, Cf = Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * Af)
        h = dA * h + dtx[:, t, :, None] * Bf[:, t, None, :]
        ys.append((h * Cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) if ys else xi.new_zeros((B, 0, Din), dtype=torch.float32)
    return y.to(y_dtype or xi.dtype), h

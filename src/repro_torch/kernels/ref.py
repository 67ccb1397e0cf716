"""Plain PyTorch versions of the port's model kernels (the correctness
contract, as ``repro/kernels/ref.py`` is for the JAX package's).

Each ``*_ref`` is the mathematically transparent version its kernel is
held to: the CPU tests run it against the JAX package, and
``chip_smoke.py`` holds the kernel to it on the card.
"""

from __future__ import annotations

import math
from typing import Optional

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

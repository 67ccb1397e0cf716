"""K5: flash attention on a hand-written Hopper kernel.

``flash_attention`` launches one of two hand-written kernels (built at
first use by ``repro_torch.core._build``), each of which replaces the JAX
package's Pallas TPU kernel ``repro/kernels/flash_attention.py:_attn_kernel``.
Both compute what that kernel computes -- softmax attention with GQA,
causal and sliding-window masks, (m, l, acc) kept in float32 and rows with
no live key written as 0 -- without its block-size constraint: the kernels
mask the ragged S and T edges themselves.

* ``"wgmma"``, ``src/repro_torch/csrc/flash_attention_sm90.cu``: bf16 on the
  tensor cores (wgmma, K / V streamed by TMA), for bfloat16 q, k, v with a
  head dim of 64, 128 or 256, a positive scale, 16-byte-aligned bases and
  strides that are multiples of 8 elements.  Its CTA takes 128 query rows
  against key tiles of 128 keys at D 64 / 128 and 80 at D 256 (where O
  alone fills half a consumer thread's registers).  It rounds P to bf16
  before P V and sums the rounded P into the row sum.
* ``"fma"``, ``src/repro_torch/csrc/flash_attention.cu``: float32 FMAs, for
  everything else the kernels take: float32 (tensor cores would round it to
  TF32), other head dims up to 256, unaligned bases or strides, a scale
  that is not positive.

``_route`` picks one from the inputs before the launch; a CUDA tensor never
falls back to the plain version, and what neither kernel takes (another
dtype, a non-unit stride along D, a head dim over 256) raises, as does a
DTensor on any device (``refuse_dtensor``).  A CPU tensor
takes the plain version, ``plain_flash_attention``
(``repro_torch.kernels.ref``).  The kernels read q, k and v through their
(batch, head, position) strides, and the output keeps q's layout: a
``(B, S, H, D)`` tensor handed over as its ``transpose(1, 2)`` view comes
back the same way, with no copy on either side.  ``flash_attention.launches``
counts all launches, ``launches_wgmma`` and ``launches_fma`` each kernel's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import refuse_autograd, refuse_dtensor
from repro_torch.kernels.ref import flash_attention_ref as plain_flash_attention

MAX_HEAD_DIM = 256
#: Head dims the tensor-core kernel is built for.
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WINDOW_LIMIT = 2 ** 30   # |window| beyond any sequence the kernel indexes


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, H, S, D) and k, v "
                         f"(B, K, T, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1] != 0:
        raise ValueError(f"query heads {H} are not a multiple of KV heads "
                         f"{k.shape[1]}")


def _on_kernel(q, k, v) -> bool:
    """True when the call goes to the kernel, False for the plain version;
    raises on a DTensor, a mix of devices or on what the kernel does not
    take."""
    refuse_dtensor("the flash-attention kernel K5", q, k, v)
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the flash-attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the flash-attention kernel needs a unit stride "
                         "along the head dim")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if max(q.shape[0], q.shape[1]) > 65535 or max(q.shape[2], k.shape[2]) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} exceeds "
                         "the kernel's grid")
    return True


def _route(dtype: torch.dtype, head_dim: int, kv_len: int, scale: float,
           data_ptrs, strides) -> str:
    """Which kernel takes a CUDA call: ``"wgmma"`` for bf16 with a head dim in
    ``WGMMA_HEAD_DIMS``, keys to attend to, a positive scale (its softmax takes the
    row max before scaling), 16-byte-aligned ``data_ptrs`` and every
    (batch, head, position) stride of a dim longer than 1 (``strides``) a
    positive multiple of 8 elements, as TMA needs; ``"fma"`` otherwise."""
    if (dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS and kv_len > 0
            and scale > 0 and all(p % 16 == 0 for p in data_ptrs)
            and all(s > 0 and s % 8 == 0 for s in strides)):
        return "wgmma"
    return "fma"


def _tma_strides(*tensors: torch.Tensor):
    """The (batch, head, position) strides of each tensor's dims longer
    than 1 (a dim of extent 1 is never stepped along)."""
    return [s for t in tensors for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``(B, H, S, D)`` over k, v ``(B, K, T, D)``; query
    head ``h`` reads KV head ``h // (H // K)``.  Key ``j`` is live for
    query ``i`` when ``j <= i`` (``causal``) and ``i - j < window`` (when
    ``window`` is set).  ``scale`` defaults to ``1 / sqrt(D)``.  Raises
    where autograd would need a backward (``refuse_autograd``)."""
    _check(q, k, v)
    refuse_autograd("the flash-attention kernel K5", q, k, v)
    if not _on_kernel(q, k, v):
        return plain_flash_attention(q, k, v, causal=causal, window=window,
                                     scale=scale)
    return _launch(q, k, v, causal=causal, window=window, scale=scale)


def _launch(q, k, v, *, causal, window, scale) -> torch.Tensor:
    """Launch the kernel ``_route`` picks on CUDA tensors that passed
    ``_on_kernel``."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    has_window = window is not None
    w = max(-_WINDOW_LIMIT, min(_WINDOW_LIMIT, int(window))) if has_window else 0
    route = _route(q.dtype, D, T, scale, [t.data_ptr() for t in (q, k, v, out)],
                   _tma_strides(q, k, v, out))
    from repro_torch.core import _build

    lib = _build.lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, K, S, T, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
            int(has_window), w, scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            err = lib.repro_flash_attention_sm90(*args, stream)
        else:
            err = lib.repro_flash_attention(*args, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel ({route}) launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    if route == "wgmma":
        flash_attention.launches_wgmma += 1
    else:
        flash_attention.launches_fma += 1
    return out


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_wgmma = flash_attention.launches_fma = 0


reset_launch_counts()

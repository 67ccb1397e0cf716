"""The depthwise causal conv of the RG-LRU and Mamba-1 blocks, and the Mamba
mixer's conv, bias and SiLU fused into one hand-written Hopper kernel.

``causal_conv1d`` is the plain conv both blocks run on the ``"xla"`` path
(and the RG-LRU block always).  ``causal_conv_silu`` launches
``src/repro_torch/csrc/causal_conv.cu`` (built at first use by
``repro_torch.core._build``).  It replaces no TPU kernel: it computes what
``causal_conv1d`` followed by ``F.silu`` computes, bit for bit -- taps
from the oldest input, each product and partial sum rounded to ``x``'s
dtype, then the bias, then ATen's ``v / (1 + exp(-v))`` -- in one pass
that reads ``x`` once and writes ``y`` once, where the plain version makes
a dozen passes over (B, S, C).

A CUDA tensor goes to the kernel: ``x`` (B, S, C) float32 or bfloat16 with
a unit stride along C (read through its batch and time strides, so the
mixer's ``xi`` half of ``xz`` goes in without a copy), ``state`` (B, 3, C)
in ``x``'s dtype with a unit stride along C or None for zeros, ``w`` (4,
C) and ``b`` (C,) contiguous, float32 or bfloat16, ``b`` or None: the
kernel's width is ``WIDTH``, every Mamba config's.  Anything else raises,
on every device, as do a DTensor (``refuse_dtensor``) and a call that
would need a backward (``refuse_autograd``).  A CPU tensor takes the plain
version.

Returns ``(y, new_state)`` as ``causal_conv1d`` does: ``y`` contiguous in
``x``'s dtype, ``new_state`` the last 3 rows of the state followed by
``x`` -- a view of ``x`` when S >= 3.  The kernel only reads ``state``; a
caller that writes ``new_state`` into it does so after the launch, on the
same stream.  Kernel launches are counted in ``causal_conv_silu.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import refuse_autograd, refuse_dtensor

WIDTH = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def plain_causal_conv_silu(x, w, b, state=None):
    """The plain composition the kernel is held to: ``causal_conv1d`` and
    then ``F.silu``."""
    y, new_state = causal_conv1d(x, w, b, state)
    return F.silu(y), new_state


def _check(x, w, b, state) -> bool:
    """Raise on what the kernel does not take; True when the call goes to
    the kernel, False for the plain version (a CPU tensor)."""
    refuse_dtensor("the causal-conv kernel", x, w, b, state)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError("causal_conv_silu takes x (B, S, C) and w (width, C); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    B, S, C = x.shape
    if w.shape != (WIDTH, C):
        raise ValueError(f"w {tuple(w.shape)} is not the kernel's width {WIDTH} by {C}")
    if b is not None and b.shape != (C,):
        raise ValueError(f"b {tuple(b.shape)} is not ({C},)")
    if state is not None and state.shape != (B, WIDTH - 1, C):
        raise ValueError(f"state {tuple(state.shape)} is not ({B}, {WIDTH - 1}, {C})")
    present = [t for t in (x, w, b, state) if t is not None]
    if any(t.dtype not in _DTYPE_CODES for t in present):
        raise ValueError("the causal-conv kernel takes float32 or bfloat16 tensors; "
                         f"got {[t.dtype for t in present]}")
    if state is not None and state.dtype != x.dtype:
        raise ValueError(f"the causal-conv kernel takes the state in x's dtype {x.dtype}; "
                         f"got {state.dtype}")
    if any(t.stride(-1) != 1 for t in (x, state) if t is not None and t.shape[-1] > 1):
        raise ValueError("the causal-conv kernel needs a unit stride along C of x "
                         "and state")
    if not all(t.is_contiguous() for t in (w, b) if t is not None):
        raise ValueError("the causal-conv kernel takes a contiguous w and b")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid")
    devices = {t.device for t in present}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _new_state(x, state):
    """The last 3 rows of the state (zeros when None) followed by ``x``: a
    view of ``x`` when it has that many rows."""
    B, S, C = x.shape
    if S >= WIDTH - 1:
        return x[:, S - (WIDTH - 1):]
    if state is None:
        state = x.new_zeros((B, WIDTH - 1, C))
    return torch.cat([state, x], dim=1)[:, -(WIDTH - 1):]


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(silu(causal_conv1d(x, w, b, state)), new_state)``; see the module
    docstring."""
    on_kernel = _check(x, w, b, state)
    refuse_autograd("the causal-conv kernel", x, w, b, state)
    if not on_kernel:
        return plain_causal_conv_silu(x, w, b, state)
    B, S, C = x.shape
    new_state = _new_state(x, state)
    y = torch.empty((B, S, C), dtype=x.dtype, device=x.device)
    if S == 0:
        return y, new_state
    from repro_torch.core import _build

    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.repro_causal_conv_silu(
            x.data_ptr(), state.data_ptr() if state is not None else None, w.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(), B, S, C,
            *x.stride()[:2], *(state.stride()[:2] if state is not None else (0, 0)),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
            _DTYPE_CODES[b.dtype] if b is not None else 0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"causal-conv kernel launch failed: cudaError {err}")
    causal_conv_silu.launches += 1
    return y, new_state


causal_conv_silu.launches = 0

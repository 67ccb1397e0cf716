"""K8: the Mamba-1 selective scan on a hand-written Hopper kernel.

``selective_scan`` launches ``src/repro_torch/csrc/selective_scan.cu``
(built at first use by ``repro_torch.core._build``), which replaces the JAX
package's Pallas TPU kernel ``repro/kernels/selective_scan.py:_scan_kernel``.
It computes what that kernel computes -- ``dt = softplus(dt_raw)``,
``h = exp(dt * A) * h + (dt * xi) * B``, ``y = sum_n h * C``, in float32,
carrying ``h0`` to ``hT`` -- without its ``chunk`` / ``d_block``
divisibility rules: four lanes share a channel's states and walk its whole
sequence, round by round through shared memory.

A CUDA tensor goes to the kernel: ``xi``, ``dt_raw``, ``Bm`` and ``Cm``
float32 or bfloat16 each, with a unit stride along their last dim (the
kernel reads them through their batch and time strides, so the model's
``Bm`` / ``Cm`` column slices go in without a copy); ``A`` (Din, N) and
``h0`` (B, Din, N) contiguous float32, N at most 16; anything else raises,
as does a DTensor, on every device (``refuse_dtensor``).
A CPU tensor takes the plain version (``repro_torch.kernels.ref``).

The reference contract holds by default: ``y`` in ``xi``'s dtype, ``hT``
float32.  ``y_dtype`` asks for another ``y`` dtype (the Mamba mixer takes
float32 ``y``, as the JAX package's ``_ssm_scan`` returns it), and
``out_state`` names a contiguous float32 (B, Din, N) tensor to write ``hT``
into (a decode step's cache slice; it may be ``h0`` itself).  Kernel
launches are counted in ``selective_scan.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import refuse_autograd, refuse_dtensor
from repro_torch.kernels.ref import selective_scan_ref as plain_selective_scan

MAX_STATE = 16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(xi, dt_raw, Bm, Cm, A, h0, out_state) -> None:
    if xi.dim() != 3 or A.dim() != 2:
        raise ValueError("selective_scan takes xi (B, S, Din) and A (Din, N); got "
                         f"{tuple(xi.shape)}, {tuple(A.shape)}")
    B, S, Din = xi.shape
    N = A.shape[1]
    if dt_raw.shape != xi.shape or A.shape[0] != Din:
        raise ValueError(f"dt_raw {tuple(dt_raw.shape)} and A {tuple(A.shape)} "
                         f"do not match xi {tuple(xi.shape)}")
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} are "
                         f"not ({B}, {S}, {N})")
    for name, t in (("h0", h0), ("out_state", out_state)):
        if t is not None and t.shape != (B, Din, N):
            raise ValueError(f"{name} {tuple(t.shape)} is not ({B}, {Din}, {N})")


def _on_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the call goes to the kernel, False for the plain version;
    raises on a DTensor, a mix of devices or on what the kernel does not
    take."""
    refuse_dtensor("the selective-scan kernel K8", *tensors)
    xi, dt_raw, Bm, Cm, A, h0, out_state = tensors
    present = [t for t in tensors if t is not None]
    devices = {t.device for t in present}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if any(t.dtype not in _DTYPE_CODES for t in (xi, dt_raw, Bm, Cm)):
        raise ValueError("the scan kernel takes float32 or bfloat16 xi, dt_raw, "
                         f"Bm, Cm; got {xi.dtype}, {dt_raw.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if any(t.stride(-1) != 1 for t in (xi, dt_raw, Bm, Cm) if t.shape[-1] > 1):
        raise ValueError("the scan kernel needs a unit stride along the last dim "
                         "of xi, dt_raw, Bm and Cm")
    for name, t in (("A", A), ("h0", h0), ("out_state", out_state)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"the scan kernel takes a contiguous float32 {name}; "
                             f"got {t.dtype}")
    if A.shape[1] > MAX_STATE:
        raise ValueError(f"state size {A.shape[1]} exceeds the kernel's "
                         f"{MAX_STATE}")
    if xi.shape[0] > 65535:
        raise ValueError(f"batch {xi.shape[0]} exceeds the kernel's grid")
    return True


def selective_scan(xi: torch.Tensor, dt_raw: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor,
                   h0: Optional[torch.Tensor] = None, *,
                   y_dtype: Optional[torch.dtype] = None,
                   out_state: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (B, S, Din), hT (B, Din, N) float32)``; see the module
    docstring for ``y_dtype`` and ``out_state``."""
    _check(xi, dt_raw, Bm, Cm, A, h0, out_state)
    refuse_autograd("the selective-scan kernel K8", xi, dt_raw, Bm, Cm, A, h0)
    y_dtype = y_dtype or xi.dtype
    if not _on_kernel(xi, dt_raw, Bm, Cm, A, h0, out_state):
        y, hT = plain_selective_scan(xi, dt_raw, Bm, Cm, A, h0, y_dtype=y_dtype)
        if out_state is not None:
            hT = out_state.copy_(hT)
        return y, hT
    if y_dtype not in _DTYPE_CODES:
        raise ValueError(f"the scan kernel writes float32 or bfloat16 y, not {y_dtype}")
    B, S, Din = xi.shape
    N = A.shape[1]
    y = torch.empty((B, S, Din), dtype=y_dtype, device=xi.device)
    hT = out_state if out_state is not None else torch.empty(
        (B, Din, N), dtype=torch.float32, device=xi.device)
    from repro_torch.core import _build

    lib = _build.lib()
    with torch.cuda.device(xi.device):
        err = lib.repro_selective_scan(
            xi.data_ptr(), dt_raw.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A.data_ptr(), h0.data_ptr() if h0 is not None else None,
            y.data_ptr(), hT.data_ptr(), B, S, Din, N,
            *xi.stride()[:2], *dt_raw.stride()[:2], *Bm.stride()[:2],
            *Cm.stride()[:2], *y.stride()[:2],
            _DTYPE_CODES[xi.dtype], _DTYPE_CODES[dt_raw.dtype],
            _DTYPE_CODES[Bm.dtype], _DTYPE_CODES[Cm.dtype], _DTYPE_CODES[y_dtype],
            torch.cuda.current_stream(xi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective-scan kernel launch failed: cudaError {err}")
    selective_scan.launches += 1
    return y, hT


selective_scan.launches = 0

"""K6 and K7: RMSNorm and fused residual RMSNorm on a hand-written Hopper
kernel.

``rmsnorm`` and ``rmsnorm_residual`` launch ``src/repro_torch/csrc/rmsnorm.cu``
(built at first use by ``repro_torch.core._build``), which replaces the JAX
package's Pallas TPU kernels ``repro/kernels/rmsnorm.py:_rmsnorm_kernel``
(K6) and ``_rmsnorm_residual_kernel`` (K7).  They compute what those kernels
compute -- the norm in float32, one cast on the store; K7 normalises the
float32 sum ``x + residual`` and returns it too -- for any row count, with
no ``block_rows`` and no fallback to one row per block.

A CUDA tensor goes to the kernel: ``x`` (and ``residual``, of ``x``'s dtype
and shape) float32 or bfloat16 and contiguous, ``scale`` a contiguous
float32 or bfloat16 vector of length d; anything else raises, as does a
DTensor, on every device (``refuse_dtensor``).  A CPU tensor
takes the plain version (``repro_torch.kernels.ref``).  Outputs are in
``x``'s dtype and shape.  Kernel launches are counted in
``rmsnorm.launches`` and ``rmsnorm_residual.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import refuse_autograd, refuse_dtensor
from repro_torch.kernels.ref import rmsnorm_ref as plain_rmsnorm
from repro_torch.kernels.ref import rmsnorm_residual_ref as plain_rmsnorm_residual

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _on_kernel(x: torch.Tensor, scale: torch.Tensor, *others: torch.Tensor) -> bool:
    """True when the call goes to the kernel, False for the plain version;
    raises on a DTensor, a mix of devices or on what the kernel does not
    take."""
    refuse_dtensor("the RMSNorm kernels K6 / K7", x, scale, *others)
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not match the last "
                         f"dim of x {tuple(x.shape)}")
    for o in others:
        if o.shape != x.shape:
            raise ValueError(f"residual {tuple(o.shape)} does not match x "
                             f"{tuple(x.shape)}")
    devices = {t.device for t in (x, scale, *others)}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise ValueError("the RMSNorm kernel takes float32 or bfloat16 x and "
                         f"scale; got {x.dtype}, {scale.dtype}")
    if any(o.dtype != x.dtype for o in others):
        raise ValueError("the fused residual RMSNorm kernel takes a residual "
                         f"of x's dtype {x.dtype}")
    if not all(t.is_contiguous() for t in (x, scale, *others)):
        raise ValueError("the RMSNorm kernel takes contiguous x, residual and scale")
    if x.numel() // max(x.shape[-1], 1) >= 2 ** 31 or x.shape[-1] >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the kernel's grid")
    return True


def _vec(x: torch.Tensor, *others: torch.Tensor) -> int:
    """1 when the kernel may use 16-byte accesses, else 0."""
    per = 16 // x.element_size()
    return int(x.shape[-1] % per == 0
               and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim (K6)."""
    refuse_autograd("the RMSNorm kernel K6", x, scale)
    if not _on_kernel(x, scale):
        return plain_rmsnorm(x, scale, eps=eps)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return out
    from repro_torch.core import _build

    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
            _vec(x, scale, out), _stream(x))
    if err != 0:
        raise RuntimeError(f"RMSNorm kernel launch failed: cudaError {err}")
    rmsnorm.launches += 1
    return out


def rmsnorm_residual(x: torch.Tensor, residual: torch.Tensor,
                     scale: torch.Tensor, *,
                     eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h = x + residual`` in float32 -> ``(rmsnorm(h) * scale, h)`` in
    ``x``'s dtype (K7)."""
    refuse_autograd("the fused residual RMSNorm kernel K7", x, residual, scale)
    if not _on_kernel(x, scale, residual):
        return plain_rmsnorm_residual(x, residual, scale, eps=eps)
    out, h = torch.empty_like(x), torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        return out, h
    from repro_torch.core import _build

    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.repro_rmsnorm_residual(
            x.data_ptr(), residual.data_ptr(), scale.data_ptr(), out.data_ptr(),
            h.data_ptr(), rows, d, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[scale.dtype],
            _vec(x, residual, scale, out, h), _stream(x))
    if err != 0:
        raise RuntimeError(f"fused residual RMSNorm kernel launch failed: "
                           f"cudaError {err}")
    rmsnorm_residual.launches += 1
    return out, h


rmsnorm.launches = 0
rmsnorm_residual.launches = 0

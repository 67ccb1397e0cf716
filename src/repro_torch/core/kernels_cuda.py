"""The ``cuda`` backend: the congruence sweep path on hand-written kernels.

Four wrappers launch the kernels of ``src/repro_torch/csrc/congruence.cu``
(built at first use by ``repro_torch.core._build``):

  ====================  ================================================
  wrapper               replaces (JAX package, Pallas TPU kernel)
  ====================  ================================================
  ``congruence``        K1 ``kernels_pallas.py:_congruence_body``
  ``step_time``         K2 ``kernels_pallas.py:_step_time_body``
  ``default_beta``      K3 ``kernels_pallas.py:_default_beta_body``
  ``sweep_stats``       K4 ``kernels_pallas.py:PallasBackend.sharded_stats``
  ====================  ================================================

Each takes the stacked float32 layout of the Pallas backend -- a ``(7, A)``
profile+beta stack (``(6, A)`` without beta) and an ``(8, V)`` machine
stack -- with no padding: the kernels mask the ragged variant edge
themselves.  A CUDA tensor always goes to the kernel (float32 only; any
failure raises); a CPU tensor takes the plain version, the shared
``kernels_xp`` math with ``xp=torch`` at the tensor's dtype.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import kernels_xp as K
from repro_torch.core.machine import IDEAL_EPS

P_ROWS = 7     # the 6 ProfileArrays fields + the (A,) beta target
M_ROWS = 8     # the 8 MachineArrays fields
OUT_ROWS = 8   # gamma, 3 alphas, LBCS/HRCS/ICS, aggregate


def _profile_rows(p_stack) -> K.ProfileArrays:
    return K.ProfileArrays(*(p_stack[i] for i in range(6)))


def _machine_rows(m_stack) -> K.MachineArrays:
    return K.MachineArrays(*(m_stack[i] for i in range(M_ROWS)))


def _overlap(timing_model: str) -> int:
    if timing_model not in ("serial", "overlap"):
        raise ValueError(f"unknown timing model {timing_model!r}")
    return int(timing_model == "overlap")


def _on_kernel(*tensors: torch.Tensor) -> bool:
    """True when the tensors go to the kernel, False for the plain version;
    raises on a mix of devices or on a device the port has no kernel for."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous float32 "
                             f"stacks, got {t.dtype} (contiguous="
                             f"{t.is_contiguous()})")
    return True


def _check_stacks(p_stack, m_stack, p_rows: int) -> None:
    if p_stack.dim() != 2 or p_stack.shape[0] < p_rows:
        raise ValueError(f"profile stack must be ({p_rows}, A), got "
                         f"{tuple(p_stack.shape)}")
    if m_stack.dim() != 2 or m_stack.shape[0] != M_ROWS:
        raise ValueError(f"machine stack must be ({M_ROWS}, V), got "
                         f"{tuple(m_stack.shape)}")
    if max(p_stack.shape[1], m_stack.shape[1]) >= 2 ** 31:
        raise ValueError("app and variant counts must fit in int32")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed: cudaError {err}")


def _lib():
    from repro_torch.core import _build

    return _build.lib()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# --------------------------------------------------------------------------- #
# The plain versions: the shared math on the stacks, any dtype, any device
# --------------------------------------------------------------------------- #


def plain_congruence(p_stack, m_stack, timing_model="serial", eps=IDEAL_EPS,
                     clamp=False) -> torch.Tensor:
    out = K.congruence_kernel(torch, _profile_rows(p_stack),
                              _machine_rows(m_stack), p_stack[6],
                              timing_model, eps, clamp)
    return torch.stack([out.gamma, out.alpha_compute, out.alpha_memory,
                        out.alpha_interconnect, out.lbcs, out.hrcs, out.ics,
                        out.aggregate])


def plain_step_time(p_stack, m_stack, timing_model="serial") -> torch.Tensor:
    return K.step_time_kernel(torch, _profile_rows(p_stack),
                              _machine_rows(m_stack), timing_model)


def plain_default_beta(p_stack, m_ref) -> torch.Tensor:
    return K.default_beta_kernel(torch, _profile_rows(p_stack),
                                 _machine_rows(m_ref))


def plain_sweep_stats(p_stack, m_stack, timing_model="serial", clamp=False,
                      eps=IDEAL_EPS):
    return K.sweep_stats_plain(
        plain_congruence(p_stack, m_stack, timing_model, eps, clamp)[7])


# --------------------------------------------------------------------------- #
# The four wrappers
# --------------------------------------------------------------------------- #


def congruence(p_stack: torch.Tensor, m_stack: torch.Tensor,
               timing_model: str = "serial", eps: float = IDEAL_EPS,
               clamp: bool = False) -> torch.Tensor:
    """K1: the fused pass, ``(8, A, V)`` (gamma, 3 alphas, 3 scores,
    aggregate) from a ``(7, A)`` profile+beta and ``(8, V)`` machine stack."""
    _check_stacks(p_stack, m_stack, P_ROWS)
    overlap = _overlap(timing_model)
    if not _on_kernel(p_stack, m_stack):
        return plain_congruence(p_stack, m_stack, timing_model, eps, clamp)
    a, v = p_stack.shape[1], m_stack.shape[1]
    out = torch.empty((OUT_ROWS, a, v), dtype=torch.float32,
                      device=p_stack.device)
    if a and v:
        _launch(_lib().repro_congruence, p_stack.data_ptr(), a,
                m_stack.data_ptr(), v, out.data_ptr(), overlap, float(eps),
                int(bool(clamp)), _stream())
        congruence.launches += 1
    return out


def step_time(p_stack: torch.Tensor, m_stack: torch.Tensor,
              timing_model: str = "serial") -> torch.Tensor:
    """K2: the ``(A, V)`` step time from a ``(6, A)`` profile stack."""
    _check_stacks(p_stack, m_stack, 6)
    overlap = _overlap(timing_model)
    if not _on_kernel(p_stack, m_stack):
        return plain_step_time(p_stack, m_stack, timing_model)
    a, v = p_stack.shape[1], m_stack.shape[1]
    out = torch.empty((a, v), dtype=torch.float32, device=p_stack.device)
    if a and v:
        _launch(_lib().repro_step_time, p_stack.data_ptr(), a,
                m_stack.data_ptr(), v, out.data_ptr(), overlap, _stream())
        step_time.launches += 1
    return out


def default_beta(p_stack: torch.Tensor, m_ref: torch.Tensor) -> torch.Tensor:
    """K3: per-app ``(A,)`` beta against machine column 0 of ``m_ref``."""
    _check_stacks(p_stack, m_ref, 6)
    if m_ref.shape[1] < 1:
        raise ValueError("default_beta needs a reference machine column")
    if not _on_kernel(p_stack, m_ref):
        return plain_default_beta(p_stack, m_ref)
    a = p_stack.shape[1]
    m_ref = m_ref[:, :1].contiguous()
    out = torch.empty((a,), dtype=torch.float32, device=p_stack.device)
    if a:
        _launch(_lib().repro_default_beta, p_stack.data_ptr(), a,
                m_ref.data_ptr(), out.data_ptr(), _stream())
        default_beta.launches += 1
    return out


def sweep_stats(p_stack: torch.Tensor, m_stack: torch.Tensor,
                timing_model: str = "serial", clamp: bool = False,
                eps: float = IDEAL_EPS):
    """K4: the fused pass reduced on the device to the per-variant suite
    mean ``(V,)``, per-app minimum ``(A,)`` and per-app first-occurrence
    argmin ``(A,)`` (int64) of the aggregate; NaN counts as the minimum.
    On the card the mean and the minima are views of one buffer that also
    holds the kernel's scratch."""
    _check_stacks(p_stack, m_stack, P_ROWS)
    overlap = _overlap(timing_model)
    if not _on_kernel(p_stack, m_stack):
        return plain_sweep_stats(p_stack, m_stack, timing_model, clamp, eps)
    a, v = p_stack.shape[1], m_stack.shape[1]
    if not (a and v):
        raise ValueError(f"sweep_stats needs apps and variants, got A={a}, V={v}")
    dev = p_stack.device
    lib = _lib()
    # one float32 allocation holds the mean, the minima and the kernel's
    # (A, blocks) value and index partials (int32, stored in the same words)
    n_part = a * lib.repro_stats_blocks(v)
    buf = torch.empty((v + a + 2 * n_part,), dtype=torch.float32, device=dev)
    app_idx = torch.empty((a,), dtype=torch.int64, device=dev)
    base = buf.data_ptr()
    _launch(lib.repro_sweep_stats, p_stack.data_ptr(), a, m_stack.data_ptr(),
            v, overlap, float(eps), int(bool(clamp)), base,
            base + 4 * (v + a), base + 4 * (v + a + n_part), base + 4 * v,
            app_idx.data_ptr(), _stream())
    sweep_stats.launches += 1
    return buf[:v], buf[v:v + a], app_idx


WRAPPERS = (congruence, step_time, default_beta, sweep_stats)
for _w in WRAPPERS:
    _w.launches = 0


def launch_counts() -> Dict[str, int]:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0


# --------------------------------------------------------------------------- #
# The backend
# --------------------------------------------------------------------------- #


class CudaBackend(K.Backend):
    """Fused float32 evaluation through the four kernels above.

    Fields are stacked on the host in float32 (as the Pallas backend
    stacks them), copied to ``device`` and handed to the wrappers; results
    come back as NumPy.  On ``device="cpu"`` the same stacking runs
    through the wrappers' plain versions.
    """

    name = "cuda"

    def __init__(self, device=K.DEFAULT_DEVICE):
        self.device = K.resolve_device(device)

    def asarray(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32),
                               device=self.device)

    def _stack(self, rows) -> torch.Tensor:
        return self.asarray(np.stack([np.asarray(r, dtype=np.float32)
                                      for r in rows]))

    def step_time(self, p, m, timing_model="serial"):
        return self.to_numpy(step_time(self._stack(p), self._stack(m),
                                       timing_model))

    def default_beta(self, p, m_ref):
        return self.to_numpy(default_beta(self._stack(p), self._stack(m_ref)))

    def congruence(self, p, m, beta, timing_model="serial",
                   eps=IDEAL_EPS, clamp=False) -> K.CongruenceArrays:
        out = self.to_numpy(congruence(
            self._stack(list(p) + [beta]), self._stack(m), timing_model,
            eps, clamp))
        return K.CongruenceArrays(
            gamma=out[0],
            beta=np.asarray(beta),
            alpha_compute=out[1],
            alpha_memory=out[2],
            alpha_interconnect=out[3],
            lbcs=out[4],
            hrcs=out[5],
            ics=out[6],
            aggregate=out[7],
        )

    def sharded_stats(self, p, m, beta, timing_model="serial", clamp=False):
        mean, mins, idx = sweep_stats(self._stack(list(p) + [beta]),
                                      self._stack(m), timing_model, clamp)
        return (self.to_numpy(mean).astype(np.float64),
                self.to_numpy(mins).astype(np.float64),
                self.to_numpy(idx).astype(np.int64))

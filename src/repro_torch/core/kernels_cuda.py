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
counts its kernel launches in ``<wrapper>.launches``.  The wrappers' host
path is kept short: the entry points are looked up once, the stream is
read as a raw handle, and the checks read only shapes, ``is_cuda``, the
card index, dtype and contiguity.  ``launch_floor`` (the least launch,
through a wrapper shaped like ``default_beta``'s) is timed beside K3.
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
    raises on a mix of devices, on a device the port has no kernel for, and
    on a CUDA tensor that is not contiguous float32.  The common case, all
    on one card, reads only ``is_cuda``, ``get_device`` and the layout."""
    first = tensors[0]
    if first.is_cuda:
        card = first.get_device()
        for t in tensors:
            if not t.is_cuda or t.get_device() != card:
                break
            if t.dtype is not torch.float32 or not t.is_contiguous():
                raise ValueError("the CUDA kernels take contiguous float32 "
                                 f"stacks, got {t.dtype} (contiguous="
                                 f"{t.is_contiguous()})")
        else:
            return True
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _check_stacks(p_stack, m_stack, p_rows: int) -> None:
    ps, ms = p_stack.shape, m_stack.shape
    if len(ps) != 2 or ps[0] < p_rows:
        raise ValueError(f"profile stack must be ({p_rows}, A), got {tuple(ps)}")
    if len(ms) != 2 or ms[0] != M_ROWS:
        raise ValueError(f"machine stack must be ({M_ROWS}, V), got {tuple(ms)}")
    if ps[1] >= 2 ** 31 or ms[1] >= 2 ** 31:
        raise ValueError("app and variant counts must fit in int32")


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed: cudaError {err}")


_entry_points: Dict[str, object] = {}


def _fn(name: str):
    """The library's entry point ``name``, looked up once (the library is
    built and loaded at the first launch)."""
    try:
        return _entry_points[name]
    except KeyError:
        from repro_torch.core import _build

        fn = _entry_points[name] = getattr(_build.lib(), name)
        return fn


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card, as the kernels take it: the raw
    handle, without building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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
    out = p_stack.new_empty((OUT_ROWS, a, v))
    if a and v:
        _launch(_fn("repro_congruence"), p_stack.data_ptr(), a,
                m_stack.data_ptr(), v, out.data_ptr(), overlap, float(eps),
                int(bool(clamp)), _stream(p_stack))
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
    out = p_stack.new_empty((a, v))
    if a and v:
        _launch(_fn("repro_step_time"), p_stack.data_ptr(), a,
                m_stack.data_ptr(), v, out.data_ptr(), overlap,
                _stream(p_stack))
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
    if m_ref.shape[1] != 1:  # an (8, 1) column passed the contiguity check
        m_ref = m_ref[:, :1].contiguous()
    out = p_stack.new_empty((a,))
    if a:
        _launch(_fn("repro_default_beta"), p_stack.data_ptr(), a,
                m_ref.data_ptr(), out.data_ptr(), _stream(p_stack))
        default_beta.launches += 1
    return out


def launch_floor(p_stack: torch.Tensor, m_ref: torch.Tensor) -> torch.Tensor:
    """The least launch on the card, through a wrapper shaped like K3's
    (the same checks, output allocation, ``ctypes`` call and stream): one
    block of 32 threads that writes one float.  No sweep path calls it; it
    is timed beside K3 as the floor under any launch, and its launches are
    not counted.  Its plain version is that float, 0."""
    _check_stacks(p_stack, m_ref, 6)
    if not _on_kernel(p_stack, m_ref):
        return torch.zeros((1,), dtype=torch.float32)
    out = p_stack.new_empty((1,))
    _launch(_fn("repro_launch_floor"), out.data_ptr(), _stream(p_stack))
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
    # one float32 allocation holds the mean, the minima and the kernel's
    # (A, blocks) value and index partials (int32, stored in the same words)
    n_part = a * _fn("repro_stats_blocks")(v)
    buf = p_stack.new_empty((v + a + 2 * n_part,))
    app_idx = torch.empty((a,), dtype=torch.int64, device=p_stack.device)
    base = buf.data_ptr()
    _launch(_fn("repro_sweep_stats"), p_stack.data_ptr(), a, m_stack.data_ptr(),
            v, overlap, float(eps), int(bool(clamp)), base,
            base + 4 * (v + a), base + 4 * (v + a + n_part), base + 4 * v,
            app_idx.data_ptr(), _stream(p_stack))
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


def pack_beta(p, m_ref) -> np.ndarray:
    """The six profile rows (A each) and column 0 of the eight reference
    machine rows, packed into one float32 host buffer of 6 A + 8 floats:
    the ``(6, A)`` stack, then the column."""
    a = len(p[0])
    host = np.empty(6 * a + M_ROWS, dtype=np.float32)
    stack = host[:6 * a].reshape(6, a)
    for i, row in enumerate(p):
        stack[i] = row
    if np.size(m_ref[0]) < 1:
        raise ValueError("default_beta needs a reference machine column")
    host[6 * a:] = [np.ravel(f)[0] for f in m_ref]
    return host


def beta_views(buf: torch.Tensor):
    """The ``(6, A)`` profile stack and ``(8, 1)`` reference column that
    ``pack_beta``'s buffer holds, as contiguous views of ``buf``."""
    a = (buf.shape[0] - M_ROWS) // 6
    return buf[:6 * a].view(6, a), buf[6 * a:].view(M_ROWS, 1)


class CudaBackend(K.Backend):
    """Fused float32 evaluation through the four kernels above.

    Fields are stacked on the host in float32 (as the Pallas backend
    stacks them), copied to ``device`` and handed to the wrappers; results
    come back as NumPy.  ``default_beta`` packs its profile rows and
    reference column into one buffer, so it makes one H2D copy.  On
    ``device="cpu"`` the same stacking runs through the wrappers' plain
    versions.
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
        """K3 on one H2D copy: the profile rows and the reference column,
        packed into one host buffer, go to the wrapper as two views."""
        host = pack_beta(p, m_ref)
        buf = torch.from_numpy(host).to(self.device)
        return self.to_numpy(default_beta(*beta_views(buf)))

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

"""Backend-agnostic congruence math -- ONE copy of the timing/Eq. 1 math.

The roofline terms, Eq. 1, the default-beta rule and the L2 aggregate are
written once against an array-namespace handle ``xp`` (``torch`` on the
sweep path, ``numpy`` for the host-side scalar adapters in ``timing`` and
``congruence``) and evaluated through a registered ``Backend``:

  * ``cuda``  -- the Hopper kernels in ``repro_torch.core.kernels_cuda``
    (f32, one fused pass).  The default.
  * ``torch`` -- the plain version: these functions called with
    ``xp=torch`` at any dtype (float64 by default) on any device.  The
    tests hold it against the JAX package; ``chip_smoke.py`` holds the
    kernels against it on the card.

Selection: an explicit ``backend=`` (name or ``Backend`` instance), else
``cuda`` on a CUDA device and ``torch`` when the caller passed
``device="cpu"``.  ``resolve_device`` raises when CUDA is asked for and
absent: nothing falls back to the CPU quietly.

Data layout: kernels consume ``ProfileArrays`` (shape ``(A,)`` per field)
and ``MachineArrays`` (shape ``(V,)`` per field) namedtuples; every
(A,)x(V,) expression broadcasts to ``(A, V)``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.machine import IDEAL_EPS

DEFAULT_DEVICE = "cuda"


class ProfileArrays(NamedTuple):
    """``A`` workload profiles, one array per field the timing model reads.

    ``mem_bytes`` carries the scalar path's fallback (``hbm_bytes`` when
    positive, else raw ``bytes_accessed``) applied at pack time.
    """

    flops: object
    mem_bytes: object
    collective_bytes: object
    pod_collective_bytes: object
    model_flops: object
    num_devices: object


class MachineArrays(NamedTuple):
    """``V`` machine variants, one array per model constant."""

    peak_flops: object
    hbm_bw: object
    ici_bw: object
    ici_links: object
    inter_pod_bw: object
    scale_compute: object
    scale_memory: object
    scale_interconnect: object

    @property
    def ici_bw_total(self):
        return self.ici_bw * self.ici_links


class CongruenceArrays(NamedTuple):
    """One full congruence pass as ``(A, V)`` arrays (``beta`` is the
    ``(A,)`` per-app target)."""

    gamma: object
    beta: object
    alpha_compute: object
    alpha_memory: object
    alpha_interconnect: object
    lbcs: object
    hrcs: object
    ics: object
    aggregate: object


# --------------------------------------------------------------------------- #
# The math (single source of truth for the paper's equations in the port)
# --------------------------------------------------------------------------- #


def raw_times(xp, p: ProfileArrays, m: MachineArrays) -> Tuple[object, object, object]:
    """Unscaled per-subsystem roofline terms, each shaped ``(A, V)``.

    compute      = per-device HLO FLOPs / peak FLOP/s
    memory       = per-device HLO bytes / HBM BW
    interconnect = per-device collective bytes / ICI BW, with traffic that
                   crosses the pod axis charged at the slower inter-pod rate.
    """
    raw_c = p.flops[:, None] / m.peak_flops[None, :]
    raw_m = p.mem_bytes[:, None] / m.hbm_bw[None, :]
    ici_bytes = p.collective_bytes - p.pod_collective_bytes
    t_ici = ici_bytes[:, None] / m.ici_bw_total[None, :]
    pod = p.pod_collective_bytes[:, None]
    t_pod = xp.where(pod != 0.0, pod / m.inter_pod_bw[None, :], 0.0)
    raw_i = t_ici + t_pod
    return raw_c, raw_m, raw_i


def scaled_times(xp, p: ProfileArrays, m: MachineArrays) -> Tuple[object, object, object]:
    """Per-subsystem times under the machine's (possibly idealized) scales."""
    raw_c, raw_m, raw_i = raw_times(xp, p, m)
    return (m.scale_compute[None, :] * raw_c,
            m.scale_memory[None, :] * raw_m,
            m.scale_interconnect[None, :] * raw_i)


def combine(xp, tc, tm, ti, timing_model: str):
    """Fold the three terms into a step time.

    ``serial``  -- t = tc + tm + ti (paper critical-path semantics).
    ``overlap`` -- t = max(terms), the Roofline ideal.
    """
    if timing_model == "serial":
        return tc + tm + ti
    if timing_model == "overlap":
        return xp.maximum(xp.maximum(tc, tm), ti)
    raise ValueError(f"unknown timing model {timing_model!r}")


def step_time_kernel(xp, p: ProfileArrays, m: MachineArrays,
                     timing_model: str = "serial"):
    """``(A, V)`` step-time matrix."""
    return combine(xp, *scaled_times(xp, p, m), timing_model)


def eq1(xp, alpha, gamma, beta):
    """Paper Eq. 1 over arrays, with the gamma == beta degeneracy -> 0.

        Score_i = 1 - (alpha_i - beta_i) / (gamma_i - beta_i)
    """
    denom = gamma - beta
    safe = xp.where(denom == 0.0, 1.0, denom)
    return xp.where(denom == 0.0, 0.0, 1.0 - (alpha - beta) / safe)


def default_beta_kernel(xp, p: ProfileArrays, m_ref: MachineArrays):
    """Per-app default target beta against reference variant column 0.

    The ideal-compute time (useful model FLOPs at full peak), floored at
    half the reference gamma so Eq. 1 stays meaningful, with a
    5%-of-gamma fallback when model FLOPs are unknown.  Always evaluated
    against the *serial* baseline, matching ``congruence.default_beta``.
    """
    tc, tm, ti = scaled_times(xp, p, m_ref)
    gamma_ref = (tc + tm + ti)[:, 0]
    valid = (p.model_flops > 0) & (p.num_devices > 0)
    denom = xp.where(valid, p.num_devices * m_ref.peak_flops[0], 1.0)
    t_ideal = xp.where(valid, p.model_flops / denom, xp.inf)
    return xp.where(valid, xp.minimum(t_ideal, 0.5 * gamma_ref),
                    0.05 * gamma_ref)


def congruence_kernel(
    xp,
    p: ProfileArrays,
    m: MachineArrays,
    beta,
    timing_model: str = "serial",
    eps: float = IDEAL_EPS,
    clamp: bool = False,
) -> CongruenceArrays:
    """One full congruence pass over the ``(A, V)`` cross-product.

    gamma, the three idealized alphas (each a scale substitution on the
    precomputed raw terms), the Eq. 1 scores and the L2 aggregate (paper
    §III-C: lower = smaller radar area = better fit).  ``beta`` is the
    ``(A,)`` per-app target.
    """
    raw = raw_times(xp, p, m)
    scales = (m.scale_compute, m.scale_memory, m.scale_interconnect)
    scaled = tuple(s[None, :] * r for s, r in zip(scales, raw))
    gamma = combine(xp, *scaled, timing_model)
    beta_col = beta[:, None]

    alphas = []
    scores = []
    for k in range(3):
        terms = list(scaled)
        terms[k] = eps * raw[k]
        alpha = combine(xp, *terms, timing_model)
        score = eq1(xp, alpha, gamma, beta_col)
        if clamp:
            score = xp.clip(score, 0.0, 1.0)
        alphas.append(alpha)
        scores.append(score)

    aggregate = xp.sqrt(scores[0] ** 2 + scores[1] ** 2 + scores[2] ** 2)
    return CongruenceArrays(
        gamma=gamma,
        beta=beta,
        alpha_compute=alphas[0],
        alpha_memory=alphas[1],
        alpha_interconnect=alphas[2],
        lbcs=scores[0],
        hrcs=scores[1],
        ics=scores[2],
        aggregate=aggregate,
    )


def sweep_stats_plain(aggregate: torch.Tensor):
    """The shard statistics of one ``(A, V)`` aggregate tile.

    Per-variant suite mean ``(V,)``, per-app minimum ``(A,)`` and per-app
    argmin ``(A,)`` under ``np.argmin``'s rules: the first occurrence wins
    a tie, and a NaN counts as the minimum (the first NaN wins).  The plain
    version of kernel K4's reduction.
    """
    nan = torch.isnan(aggregate)
    idx = torch.where(nan.any(dim=1), nan.to(torch.int8).argmax(dim=1),
                      aggregate.argmin(dim=1))
    mins = aggregate.gather(1, idx[:, None])[:, 0]
    return aggregate.mean(dim=0), mins, idx


# --------------------------------------------------------------------------- #
# Devices and the backend registry
# --------------------------------------------------------------------------- #


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is false (no quiet CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain version on the host")
    return dev


class Backend:
    """One evaluation strategy for the math above.

    Entry points take NumPy (or array-like) fields and return NumPy arrays;
    a backend converts on the way in (``asarray``) and out (``to_numpy``).
    """

    name: str = "abstract"
    device: torch.device = torch.device("cpu")

    # -- conversions ---------------------------------------------------- #

    def asarray(self, a):
        raise NotImplementedError

    def to_numpy(self, a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    def profile_arrays(self, p: ProfileArrays) -> ProfileArrays:
        return ProfileArrays(*(self.asarray(f) for f in p))

    def machine_arrays(self, m: MachineArrays) -> MachineArrays:
        return MachineArrays(*(self.asarray(f) for f in m))

    # -- kernel entry points -------------------------------------------- #

    def step_time(self, p: ProfileArrays, m: MachineArrays,
                  timing_model: str = "serial") -> np.ndarray:
        raise NotImplementedError

    def default_beta(self, p: ProfileArrays, m_ref: MachineArrays) -> np.ndarray:
        raise NotImplementedError

    def congruence(self, p: ProfileArrays, m: MachineArrays, beta,
                   timing_model: str = "serial", eps: float = IDEAL_EPS,
                   clamp: bool = False) -> CongruenceArrays:
        """Run the full pass and return *NumPy* ``CongruenceArrays``."""
        raise NotImplementedError

    def sharded_stats(self, p: ProfileArrays, m: MachineArrays, beta,
                      timing_model: str = "serial", clamp: bool = False):
        """Statistics pass over one variant chunk, reduced on the device.

        Returns per-variant suite-mean aggregates ``(V_chunk,)``, per-app
        minima ``(A,)`` and per-app first-occurrence argmin indices
        ``(A,)`` (0-based within the chunk), as float64/float64/int64
        NumPy arrays -- the three rows ``shard_sweep`` merges.  The
        ``(A, V_chunk)`` score tile is never returned.  A backend without
        such a pass returns ``None`` and ``shard_sweep`` reduces a full
        ``congruence`` result on the host instead.
        """
        return None


class TorchBackend(Backend):
    """The plain version: the shared math with ``xp=torch``.

    float64 by default (equal to the JAX package's NumPy backend to
    ~1e-16); ``dtype=torch.float32`` reproduces the kernels' precision.
    """

    name = "torch"

    def __init__(self, device=DEFAULT_DEVICE, dtype: torch.dtype = torch.float64):
        self.device = resolve_device(device)
        self.dtype = dtype

    def asarray(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device).to(self.dtype)

    def step_time(self, p, m, timing_model="serial"):
        return self.to_numpy(step_time_kernel(
            torch, self.profile_arrays(p), self.machine_arrays(m), timing_model))

    def default_beta(self, p, m_ref):
        return self.to_numpy(default_beta_kernel(
            torch, self.profile_arrays(p), self.machine_arrays(m_ref)))

    def congruence(self, p, m, beta, timing_model="serial",
                   eps=IDEAL_EPS, clamp=False):
        out = congruence_kernel(torch, self.profile_arrays(p),
                                self.machine_arrays(m), self.asarray(beta),
                                timing_model, eps, clamp)
        return CongruenceArrays(*(self.to_numpy(f) for f in out))

    def sharded_stats(self, p, m, beta, timing_model="serial", clamp=False):
        out = congruence_kernel(torch, self.profile_arrays(p),
                                self.machine_arrays(m), self.asarray(beta),
                                timing_model, IDEAL_EPS, clamp)
        mean, mins, idx = sweep_stats_plain(out.aggregate)
        return (self.to_numpy(mean).astype(np.float64),
                self.to_numpy(mins).astype(np.float64),
                self.to_numpy(idx).astype(np.int64))


def _cuda_backend(device=DEFAULT_DEVICE) -> Backend:
    from repro_torch.core.kernels_cuda import CudaBackend

    return CudaBackend(device)


_BACKEND_FACTORIES: Dict[str, Callable[..., Backend]] = {
    "cuda": _cuda_backend,
    "torch": TorchBackend,
}
_BACKEND_CACHE: Dict[Tuple[str, str], Backend] = {}


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    """Register a backend factory, called as ``factory(device)``."""
    _BACKEND_FACTORIES[name] = factory
    for key in [k for k in _BACKEND_CACHE if k[0] == name]:
        del _BACKEND_CACHE[key]


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKEND_FACTORIES))


def validate_backend_name(name) -> None:
    """Reject an unknown backend name with a ``ValueError``.  ``None`` and
    constructed ``Backend`` instances pass."""
    if isinstance(name, Backend) or name is None:
        return
    if name.lower() not in available_backends():
        raise ValueError(f"unknown backend {name!r}; available: "
                         f"{', '.join(available_backends())}")


def validate_backend_arg(parser, name) -> None:
    """argparse wrapper over ``validate_backend_name``."""
    try:
        validate_backend_name(name)
    except ValueError as e:
        parser.error(str(e))


def get_backend(name=None, device=DEFAULT_DEVICE) -> Backend:
    """Resolve a backend on ``device``.

    A ``Backend`` instance is returned unchanged.  With no name, a CUDA
    device gets ``cuda`` (the kernels) and the CPU gets ``torch`` (the
    plain version at float64).  Instances are cached per (name, device).
    """
    if isinstance(name, Backend):
        return name
    dev = resolve_device(device)
    if name is None:
        name = "cuda" if dev.type == "cuda" else "torch"
    name = name.lower()
    if name not in _BACKEND_FACTORIES:
        raise ValueError(
            f"unknown backend {name!r}; have {available_backends()}")
    key = (name, str(dev))
    if key not in _BACKEND_CACHE:
        _BACKEND_CACHE[key] = _BACKEND_FACTORIES[name](dev)
    return _BACKEND_CACHE[key]

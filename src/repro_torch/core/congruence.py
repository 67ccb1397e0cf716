"""Congruence scores -- the paper's Eq. 1 and the three-score report.

    Score_i = 1 - (alpha_i - beta_i) / (gamma_i - beta_i)          (Eq. 1)

  gamma  : unmodified step time (baseline timing result)
  alpha_i: step time with subsystem i idealized (near-zero delay)
  beta_i : user-defined target time

Score -> 1: subsystem i dominates (prime co-design target).
Score -> 0: subsystem i barely affects the critical path.

The aggregate application-architecture congruence score is the L2 magnitude
of the (HRCS, LBCS, ICS) vector (paper §III-C), extensible to n dimensions;
*lower* aggregate = smaller radar area = better overall fit.

The Eq. 1 / roofline arithmetic lives in ``repro_torch.core.kernels_xp``
(one copy shared with the batched sweep engine); this module is the scalar
adapter producing full per-cell ``CongruenceReport`` objects, including the
per-component extended decomposition, on the host with ``xp=numpy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.core import kernels_xp as K
from repro_torch.core.costs import COLLECTIVE_KINDS, WorkloadProfile
from repro_torch.core.machine import (
    ALL_SUBSYSTEMS,
    IDEAL_EPS,
    MachineModel,
    Subsystem,
)
from repro_torch.core.timing import (
    TimingBreakdown,
    machine_arrays,
    profile_arrays,
    subsystem_times,
)

# Paper score names keyed by the TPU subsystem they profile (DESIGN.md §2).
SCORE_NAMES = {
    Subsystem.INTERCONNECT: "ICS",
    Subsystem.MEMORY: "HRCS",
    Subsystem.COMPUTE: "LBCS",
}


def congruence_score(alpha: float, gamma: float, beta: float) -> float:
    """Eq. 1, verbatim.  Degenerate when gamma == beta (no headroom)."""
    denom = gamma - beta
    if denom == 0.0:
        return 0.0
    return 1.0 - (alpha - beta) / denom


@dataclasses.dataclass
class CongruenceReport:
    """Full congruence profile of one (application, machine-variant) pair."""

    name: str
    machine: str
    timing_model: str
    gamma: float                      # baseline step time (s)
    beta: float                       # target step time (s)
    alphas: Dict[str, float]          # subsystem -> idealized step time (s)
    scores: Dict[str, float]          # "ICS"/"HRCS"/"LBCS" -> Eq. 1 score
    extended: Dict[str, float]        # per-component decomposition (paper §II-B)
    baseline: TimingBreakdown

    @property
    def ics(self) -> float:
        return self.scores["ICS"]

    @property
    def hrcs(self) -> float:
        return self.scores["HRCS"]

    @property
    def lbcs(self) -> float:
        return self.scores["LBCS"]

    @property
    def aggregate(self) -> float:
        """L2 magnitude of the (HRCS, LBCS, ICS) vector (paper Table I)."""
        return math.sqrt(self.ics ** 2 + self.hrcs ** 2 + self.lbcs ** 2)

    @property
    def dominant(self) -> str:
        return max(self.scores, key=lambda k: self.scores[k])

    def radar_row(self) -> Dict[str, float]:
        return {"ICS": self.ics, "HRCS": self.hrcs, "LBCS": self.lbcs}

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "machine": self.machine,
            "timing_model": self.timing_model,
            "gamma_s": self.gamma,
            "beta_s": self.beta,
            "alphas_s": dict(self.alphas),
            "scores": dict(self.scores),
            "extended": dict(self.extended),
            "aggregate": self.aggregate,
            "dominant": self.dominant,
        }


def default_beta(
    profile: WorkloadProfile,
    machine: MachineModel,
    baseline: Optional[TimingBreakdown] = None,
) -> float:
    """Default user target: the ideal-compute step time.

    The paper's beta is a user-defined target delay (0.2 ns in §III-C --
    optimistic but nonzero).  Our analogue: the time the step would take if it
    ran useful model FLOPs at full MXU peak -- optimistic, nonzero, and
    workload-scaled.  Falls back to a small fraction of gamma when analytic
    model FLOPs are unavailable.

    Callers that already hold the baseline ``TimingBreakdown`` (e.g.
    ``profile_congruence``) pass it via ``baseline`` so the single timing
    pass is shared instead of re-derived here.
    """
    if baseline is None:
        baseline = subsystem_times(profile, machine)
    gamma = baseline.total_serial
    if profile.model_flops > 0 and profile.num_devices > 0:
        t = profile.model_flops / (profile.num_devices * machine.peak_flops)
        # beta must sit below gamma for Eq. 1 to be meaningful.
        return min(t, 0.5 * gamma)
    return 0.05 * gamma


def profile_congruence(
    profile: WorkloadProfile,
    machine: MachineModel,
    *,
    beta: Optional[float] = None,
    timing_model: str = "serial",
    eps: float = IDEAL_EPS,
    clamp: bool = False,
) -> CongruenceReport:
    """Compute ICS / HRCS / LBCS for one workload on one machine variant.

    This performs the paper's loop: one baseline timing (gamma), then one
    re-timing per subsystem with that subsystem idealized (alpha_i) -- all
    through the shared ``kernels_xp.congruence_kernel`` at batch size 1.
    The compiled artifact is never touched; only the machine model changes.
    """
    baseline = subsystem_times(profile, machine)
    if beta is None:
        beta = default_beta(profile, machine, baseline=baseline)

    with np.errstate(divide="ignore", invalid="ignore"):
        out = K.congruence_kernel(
            np, profile_arrays(profile), machine_arrays(machine),
            np.asarray([beta], dtype=np.float64),
            timing_model, eps, clamp)

    gamma = float(out.gamma[0, 0])
    alphas = {
        Subsystem.COMPUTE.value: float(out.alpha_compute[0, 0]),
        Subsystem.MEMORY.value: float(out.alpha_memory[0, 0]),
        Subsystem.INTERCONNECT.value: float(out.alpha_interconnect[0, 0]),
    }
    scores = {
        "LBCS": float(out.lbcs[0, 0]),
        "HRCS": float(out.hrcs[0, 0]),
        "ICS": float(out.ics[0, 0]),
    }

    extended = extended_decomposition(profile, machine, gamma=gamma, beta=beta,
                                      timing_model=timing_model, eps=eps,
                                      clamp=clamp, times=baseline)

    return CongruenceReport(
        name=profile.name,
        machine=machine.name,
        timing_model=timing_model,
        gamma=gamma,
        beta=beta,
        alphas=alphas,
        scores=scores,
        extended=extended,
        baseline=baseline,
    )


def extended_decomposition(
    profile: WorkloadProfile,
    machine: MachineModel,
    *,
    gamma: float,
    beta: float,
    timing_model: str,
    eps: float = IDEAL_EPS,
    clamp: bool = False,
    times: Optional[TimingBreakdown] = None,
) -> Dict[str, float]:
    """Per-component congruence (paper §II-B: 'the methodology can be extended
    to separately evaluate each component type').

    ICS decomposes per collective kind; LBCS into MXU (dot) vs VPU
    (everything else).  Each sub-score idealizes only that component's share
    of its subsystem's time, via linearity of the timing model.  ``clamp``
    applies the same [0, 1] clip as the top-level scores, so a clamped
    report is clamped throughout.  Callers already holding the baseline
    ``TimingBreakdown`` pass it via ``times`` to skip the re-timing.
    """
    out: Dict[str, float] = {}
    if times is None:
        times = subsystem_times(profile, machine)

    def score(alpha: float) -> float:
        s = congruence_score(alpha, gamma, beta)
        return min(1.0, max(0.0, s)) if clamp else s

    # --- ICS per collective kind ------------------------------------- #
    total_coll = profile.total_collective_bytes
    if total_coll > 0 and times.interconnect > 0:
        for kind in COLLECTIVE_KINDS:
            frac = profile.collective_bytes.get(kind, 0.0) / total_coll
            removed = times.interconnect * frac * (1.0 - eps)
            alpha = _retime_minus(times, timing_model, Subsystem.INTERCONNECT, removed)
            out[f"ICS[{kind}]"] = score(alpha)

    # --- LBCS: MXU vs VPU --------------------------------------------- #
    if profile.flops > 0 and times.compute > 0:
        mxu_frac = min(1.0, profile.dot_flops / profile.flops) if profile.dot_flops else 0.0
        for label, frac in (("mxu", mxu_frac), ("vpu", 1.0 - mxu_frac)):
            removed = times.compute * frac * (1.0 - eps)
            alpha = _retime_minus(times, timing_model, Subsystem.COMPUTE, removed)
            out[f"LBCS[{label}]"] = score(alpha)

    return out


def _retime_minus(
    times: TimingBreakdown, timing_model: str, subsystem: Subsystem, removed: float
) -> float:
    """Step time after shaving ``removed`` seconds off one subsystem term."""
    terms = {
        Subsystem.COMPUTE: times.compute,
        Subsystem.MEMORY: times.memory,
        Subsystem.INTERCONNECT: times.interconnect,
    }
    terms[subsystem] = max(0.0, terms[subsystem] - removed)
    return float(K.combine(
        np, terms[Subsystem.COMPUTE], terms[Subsystem.MEMORY],
        terms[Subsystem.INTERCONNECT], timing_model))

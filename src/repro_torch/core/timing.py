"""Step-time estimation -- the "timing analysis" stage of the paper's flow.

VPR re-runs *only* static timing on the fixed routed netlist when subsystem
delays change.  Our analogue: evaluate a closed-form machine model over the
fixed ``WorkloadProfile`` extracted from the compiled HLO.  Changing machine
constants (including per-subsystem idealization) never triggers recompilation,
which is what makes congruence profiling lightweight.

Two timing models (DESIGN.md §2, adaptation note 1):
  * ``serial``  -- t = t_compute + t_memory + t_interconnect.  Matches the
    paper's critical-path semantics, where zeroing a subsystem removes its
    full contribution.  Default for congruence scores.
  * ``overlap`` -- t = max(terms), the Roofline ideal with perfect
    compute/comm overlap.  Used for optimistic bounds in the DSE tables.

The roofline arithmetic itself lives in ``repro_torch.core.kernels_xp`` (one
copy shared with the batched sweep engine); this module is the scalar
adapter -- it packs one (profile, machine) pair as a batch of size 1 and
unpacks floats.  It runs the shared math with ``xp=numpy`` on the host:
one cell at a time is bookkeeping for the reports (``dse`` cells), not
device work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core import kernels_xp as K
from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.machine import ALL_SUBSYSTEMS, MachineModel, Subsystem

TIMING_MODELS = ("serial", "overlap")


def profile_arrays(profile: WorkloadProfile) -> K.ProfileArrays:
    """Pack one profile as a batch-of-1 ``ProfileArrays`` (the scalar path's
    ``hbm_bytes``-else-``bytes_accessed`` fallback applied here)."""
    mem = profile.hbm_bytes if profile.hbm_bytes > 0 else profile.bytes_accessed
    arr = lambda v: np.asarray([v], dtype=np.float64)
    return K.ProfileArrays(
        flops=arr(profile.flops),
        mem_bytes=arr(mem),
        collective_bytes=arr(profile.total_collective_bytes),
        pod_collective_bytes=arr(profile.pod_collective_bytes),
        model_flops=arr(profile.model_flops),
        num_devices=arr(profile.num_devices),
    )


def machine_arrays(machine: MachineModel) -> K.MachineArrays:
    """Pack one machine model as a batch-of-1 ``MachineArrays``."""
    arr = lambda v: np.asarray([v], dtype=np.float64)
    return K.MachineArrays(
        peak_flops=arr(machine.peak_flops),
        hbm_bw=arr(machine.hbm_bw),
        ici_bw=arr(machine.ici_bw),
        ici_links=arr(machine.ici_links),
        inter_pod_bw=arr(machine.inter_pod_bw),
        scale_compute=arr(machine.scale_for(Subsystem.COMPUTE)),
        scale_memory=arr(machine.scale_for(Subsystem.MEMORY)),
        scale_interconnect=arr(machine.scale_for(Subsystem.INTERCONNECT)),
    )


@dataclasses.dataclass(frozen=True)
class TimingBreakdown:
    """Per-subsystem time (seconds) plus the combined estimate."""

    compute: float
    memory: float
    interconnect: float
    total_serial: float
    total_overlap: float

    def term(self, subsystem: Subsystem) -> float:
        return {
            Subsystem.COMPUTE: self.compute,
            Subsystem.MEMORY: self.memory,
            Subsystem.INTERCONNECT: self.interconnect,
        }[subsystem]

    def total(self, model: str = "serial") -> float:
        if model == "serial":
            return self.total_serial
        if model == "overlap":
            return self.total_overlap
        raise ValueError(f"unknown timing model {model!r}; have {TIMING_MODELS}")

    @property
    def dominant(self) -> Subsystem:
        return max(ALL_SUBSYSTEMS, key=self.term)

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute,
            "memory_s": self.memory,
            "interconnect_s": self.interconnect,
            "serial_s": self.total_serial,
            "overlap_s": self.total_overlap,
        }


def subsystem_times(profile: WorkloadProfile, machine: MachineModel) -> TimingBreakdown:
    """The three roofline terms under ``machine``'s (possibly idealized)
    scales -- the shared ``kernels_xp`` math at batch size 1."""
    with np.errstate(divide="ignore", invalid="ignore"):
        tc, tm, ti = K.scaled_times(
            np, profile_arrays(profile), machine_arrays(machine))
    t_compute = float(tc[0, 0])
    t_memory = float(tm[0, 0])
    t_interconnect = float(ti[0, 0])
    return TimingBreakdown(
        compute=t_compute,
        memory=t_memory,
        interconnect=t_interconnect,
        total_serial=t_compute + t_memory + t_interconnect,
        total_overlap=max(t_compute, t_memory, t_interconnect),
    )


def step_time(
    profile: WorkloadProfile, machine: MachineModel, model: str = "serial"
) -> float:
    """Estimated step time in seconds (the paper's γ / α depending on scales)."""
    return subsystem_times(profile, machine).total(model)

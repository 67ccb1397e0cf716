"""Three-term roofline analysis over dry-run artifacts (required §Roofline).

The JAX package's ``repro/core/roofline.py``, unchanged but for its
imports (the scalar path: NumPy float64 through ``repro_torch.core.timing``).

    compute term      = HLO_FLOPs / (chips x peak_FLOP/s)
    memory term       = HLO_bytes / (chips x HBM_bw)
    collective term   = collective_bytes / (chips x link_bw)

``cost_analysis`` reports per-device work, so dividing per-device work by the
per-chip rate is identical to global work / (chips x rate).

Also reports MODEL_FLOPS = 6*N*D (dense train) / 6*N_active*D (MoE) /
2*N*D (inference), the usefulness ratio MODEL_FLOPS / HLO_FLOPs, the dominant
term, and the roofline fraction (how close the dominant term pins us to peak).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.machine import MachineModel
from repro_torch.core.timing import subsystem_times


@dataclasses.dataclass
class RooflineReport:
    name: str
    arch: str
    shape: str
    mesh: str
    machine: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float          # MODEL_FLOPS / HLO_FLOPs
    mfu_bound: float             # model-FLOPs utilization at the overlap bound
    roofline_fraction: float     # useful compute time / dominant term
    step_time_overlap_s: float
    step_time_serial_s: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_memory_gb: float

    def as_dict(self) -> dict:
        """Strict-JSON-safe dict (inverse: ``from_dict``).

        Zero-rate machines and zero-FLOP cells produce inf/nan terms;
        ``json.dump(..., allow_nan=False)`` rejects those and the default
        ``Infinity``/``NaN`` spellings are not valid JSON anyway.  Non-finite
        floats are encoded as the strings ``"inf"`` / ``"-inf"`` / ``"nan"``,
        which ``from_dict`` turns back into the exact float values.
        """
        out = {}
        for key, value in dataclasses.asdict(self).items():
            if isinstance(value, float) and not math.isfinite(value):
                value = str(value)  # "inf" | "-inf" | "nan"
            out[key] = value
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "RooflineReport":
        """Rebuild a report from ``as_dict`` output (round-trip pinned in
        tests/test_model_zoo.py)."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RooflineReport fields {sorted(unknown)}")
        kw = {}
        for f in dataclasses.fields(cls):
            value = d[f.name]
            if f.type == "float" and isinstance(value, str):
                value = float(value)
            kw[f.name] = value
        return cls(**kw)

    def one_liner(self) -> str:
        return (
            f"{self.name}: compute={self.compute_s:.3e}s memory={self.memory_s:.3e}s "
            f"collective={self.collective_s:.3e}s dominant={self.dominant} "
            f"useful={self.useful_ratio:.2f} frac={self.roofline_fraction:.2f}"
        )


def analyze(profile: WorkloadProfile, machine: MachineModel) -> RooflineReport:
    times = subsystem_times(profile, machine)
    dominant = times.dominant

    # Ideal time = useful model FLOPs at full fleet peak.
    if profile.model_flops > 0 and profile.num_devices > 0:
        ideal_s = profile.model_flops / (profile.num_devices * machine.peak_flops)
    else:
        ideal_s = math.nan

    overlap_s = times.total_overlap
    serial_s = times.total_serial
    useful = profile.useful_flops_ratio
    mfu_bound = ideal_s / overlap_s if overlap_s > 0 and not math.isnan(ideal_s) else math.nan
    frac = (
        ideal_s / times.term(dominant)
        if times.term(dominant) > 0 and not math.isnan(ideal_s)
        else math.nan
    )

    return RooflineReport(
        name=profile.name,
        arch=profile.arch,
        shape=profile.shape,
        mesh=profile.mesh,
        machine=machine.name,
        compute_s=times.compute,
        memory_s=times.memory,
        collective_s=times.interconnect,
        dominant=dominant.value,
        model_flops=profile.model_flops,
        hlo_flops_global=profile.global_flops,
        useful_ratio=useful,
        mfu_bound=mfu_bound,
        roofline_fraction=frac,
        step_time_overlap_s=overlap_s,
        step_time_serial_s=serial_s,
        bytes_per_device=profile.bytes_accessed,
        collective_bytes_per_device=profile.total_collective_bytes,
        peak_memory_gb=profile.peak_memory_bytes / 1e9,
    )


def model_flops_for(
    *,
    params_active: float,
    tokens: int,
    step_kind: str,
) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for training, 2*N*D for inference."""
    mult = 6.0 if step_kind == "train" else 2.0
    return mult * params_active * tokens


def markdown_table(reports: list, *, title: Optional[str] = None) -> str:
    """Render a list of RooflineReports as the EXPERIMENTS.md roofline table."""
    lines = []
    if title:
        lines.append(f"### {title}")
        lines.append("")
    lines.append(
        "| cell | mesh | compute (s) | memory (s) | collective (s) | dominant "
        "| MODEL_FLOPS | useful ratio | roofline frac | peak mem/dev (GB) |"
    )
    lines.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in reports:
        lines.append(
            f"| {r.arch}/{r.shape} | {r.mesh} | {r.compute_s:.3e} | {r.memory_s:.3e} "
            f"| {r.collective_s:.3e} | **{r.dominant}** | {r.model_flops:.3e} "
            f"| {r.useful_ratio:.3f} | {r.roofline_fraction:.3f} "
            f"| {r.peak_memory_gb:.2f} |"
        )
    return "\n".join(lines)

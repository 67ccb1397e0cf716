"""Workload profiles -- the per-cell cost record every congruence pass reads.

A ``WorkloadProfile`` is the analogue of VPR's post-route netlist: the
expensive step (compiling one architecture x shape x mesh cell) runs once,
and every scoring pass afterwards re-times the same recorded costs.  The
JSON format is the JAX package's, field for field, so profiles written
there load here unchanged.  Extraction from a compiled program arrives with
the measurement-loop slice of the port; this module holds the record only.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


@dataclasses.dataclass
class WorkloadProfile:
    """Everything the timing/congruence/roofline passes need for one cell.

    FLOPs/bytes are PER DEVICE (the per-device SPMD program's work).
    Roofline terms therefore divide by per-chip rates; multiply by
    ``num_devices`` for global totals.
    """

    name: str
    arch: str = ""
    shape: str = ""
    mesh: str = ""
    step_kind: str = "train"      # train | prefill | decode
    num_devices: int = 1
    flops: float = 0.0            # per-device HLO FLOPs
    bytes_accessed: float = 0.0   # per-device HLO bytes
    transcendentals: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS}
    )
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    pod_collective_bytes: float = 0.0   # share of traffic crossing the pod axis
    dot_flops: float = 0.0
    dot_count: int = 0
    hbm_bytes: float = 0.0              # per-device HBM-traffic estimate
    peak_memory_bytes: float = 0.0      # per-device
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    model_flops: float = 0.0            # analytic 6*N*D (train) / 2*N*D (infer), GLOBAL
    tokens: int = 0
    params: float = 0.0                 # total parameter count
    params_active: float = 0.0          # active (MoE-aware) parameter count
    compile_seconds: float = 0.0
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    @property
    def global_flops(self) -> float:
        return self.flops * self.num_devices

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs -- catches remat/redundancy waste."""
        if self.global_flops <= 0:
            return math.nan
        return self.model_flops / self.global_flops

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "WorkloadProfile":
        known = {f.name for f in dataclasses.fields(WorkloadProfile)}
        return WorkloadProfile(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @staticmethod
    def load(path: str) -> "WorkloadProfile":
        with open(path) as f:
            return WorkloadProfile.from_json(json.load(f))

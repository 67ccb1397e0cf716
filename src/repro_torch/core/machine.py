"""Machine models for congruence profiling.

The paper idealizes one FPGA subsystem at a time (near-zero delay) and re-runs
only the timing analysis.  Our machine model is the TPU analogue of the VPR
architecture description: a small set of hardware constants per subsystem.
``MachineModel.idealized(subsystem)`` returns a copy with that subsystem's
delay scaled to near zero (``IDEAL_EPS``), mirroring the paper's 0.2 ns
"optimistic ideal delay" rather than an exact zero.

Subsystem mapping (see DESIGN.md §2):
  INTERCONNECT -> ICI collective network        (paper: routing fabric, ICS)
  MEMORY       -> HBM bandwidth                 (paper: H-blocks/BRAM, HRCS)
  COMPUTE      -> MXU/VPU FLOPs                 (paper: general logic, LBCS)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Mapping

# Paper §II: "We set these modified delays near-zero to emulate the Roofline
# ideal for each subsystem" -- the paper uses 0.2ns instead of exactly zero;
# we scale subsystem time by IDEAL_EPS.
IDEAL_EPS = 1e-3


class Subsystem(str, enum.Enum):
    """The three profiled subsystems (paper: interconnect / H-blocks / logic)."""

    COMPUTE = "compute"            # LBCS analogue (MXU/VPU)
    MEMORY = "memory"              # HRCS analogue (HBM)
    INTERCONNECT = "interconnect"  # ICS analogue (ICI)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


ALL_SUBSYSTEMS = (Subsystem.COMPUTE, Subsystem.MEMORY, Subsystem.INTERCONNECT)


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Closed-form hardware model of one chip inside a pod.

    All rates are *per chip*; roofline terms divide per-device work by these
    rates, which is algebraically identical to global-work / (chips * rate).
    """

    name: str
    peak_flops: float          # bf16 FLOP/s per chip (MXU+VPU)
    hbm_bw: float              # HBM bytes/s per chip
    ici_bw: float              # ICI bytes/s per link per chip
    ici_links: int = 1         # effective links engaged per collective step
    inter_pod_bw: float = 25.0e9   # bytes/s per chip across the pod axis (DCN-like)
    mxu_fraction: float = 1.0  # fraction of peak available to non-matmul ops
    # Per-subsystem delay scale factors; 1.0 = nominal, IDEAL_EPS = idealized.
    scale: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {s.value: 1.0 for s in ALL_SUBSYSTEMS}
    )

    # ------------------------------------------------------------------ #

    def scale_for(self, subsystem: Subsystem) -> float:
        return float(self.scale.get(subsystem.value, 1.0))

    def idealized(self, subsystem: Subsystem, eps: float = IDEAL_EPS) -> "MachineModel":
        """Return a copy with ``subsystem``'s delay scaled to near-zero.

        This is the paper's core move: modify the architecture description so
        one subsystem runs at its Roofline ideal, leaving the mapping (for us:
        the compiled HLO and its extracted costs) untouched.
        """
        new_scale: Dict[str, float] = dict(self.scale)
        new_scale[subsystem.value] = eps
        return dataclasses.replace(
            self, name=f"{self.name}+ideal-{subsystem.value}", scale=new_scale
        )

    def with_scales(self, **scales: float) -> "MachineModel":
        new_scale: Dict[str, float] = dict(self.scale)
        for key, value in scales.items():
            Subsystem(key)  # validate
            new_scale[key] = float(value)
        return dataclasses.replace(self, scale=new_scale)

    def with_rates(self, name: str = None, **rates: float) -> "MachineModel":
        """Copy with replaced provisioned rates (the co-design knobs).

        Valid keys: ``peak_flops``, ``hbm_bw``, ``ici_bw``, ``ici_links``,
        ``inter_pod_bw``.  ``ici_links`` is rounded to an int; delay
        ``scale`` factors are preserved (use ``with_scales`` for those).
        """
        allowed = ("peak_flops", "hbm_bw", "ici_bw", "ici_links",
                   "inter_pod_bw")
        for key in rates:
            if key not in allowed:
                raise KeyError(f"unknown rate {key!r}; have {allowed}")
        if "ici_links" in rates:
            rates["ici_links"] = int(round(rates["ici_links"]))
        if name is not None:
            rates["name"] = name
        return dataclasses.replace(self, **rates)

    @property
    def ici_bw_total(self) -> float:
        return self.ici_bw * self.ici_links

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["scale"] = dict(self.scale)
        return d

    @staticmethod
    def from_json(d: dict) -> "MachineModel":
        return MachineModel(**d)


# --------------------------------------------------------------------------- #
# Hardware variants -- the paper's baseline / denser / densest sweep (Table I).
# Baseline constants are the assignment's TPU v5e numbers:
#   197 TFLOP/s bf16 per chip, 819 GB/s HBM, ~50 GB/s per ICI link.
# "denser"/"densest" increase the specialized-resource density the same way
# the paper raises DSP/BRAM ratios (DESIGN.md §4).
# --------------------------------------------------------------------------- #

TPU_V5E = MachineModel(
    name="baseline",
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    ici_links=1,
)

TPU_DENSER = MachineModel(
    name="denser",
    peak_flops=394e12,       # 2x compute density
    hbm_bw=1228e9,           # 1.5x HBM
    ici_bw=50e9,
    ici_links=1,
)

TPU_DENSEST = MachineModel(
    name="densest",
    peak_flops=459e12,       # v5p-like
    hbm_bw=2765e9,
    ici_bw=100e9,
    ici_links=1,
)

VARIANTS = (TPU_V5E, TPU_DENSER, TPU_DENSEST)
VARIANTS_BY_NAME = {m.name: m for m in VARIANTS}


def get_variant(name: str) -> MachineModel:
    try:
        return VARIANTS_BY_NAME[name]
    except KeyError as exc:  # pragma: no cover - defensive
        raise KeyError(
            f"unknown machine variant {name!r}; have {sorted(VARIANTS_BY_NAME)}"
        ) from exc

"""Silicon cost layer: per-subsystem area weights + a dynamic-power term.

A configurable ``CostModel`` -- the PPA axes the paper trades congruence
against when raising DSP/BRAM density (§I) -- so sweeps can rank variants
on a *three*-objective front: (aggregate congruence, area, power).  Copied
from the JAX package so the port imports nothing of it.

Both estimators are deliberately coarse, first-order proxies (this is
*early* design exploration -- the paper's whole premise is ranking designs
before committing to implementation):

  area(m)  = sum_i w_i * rate_i / ref_rate_i          (weights sum to 1)
  power(m) = static + sum_i p_i * (rate_i / ref_rate_i) ** e_i

Area is linear in provisioned throughput (more MXUs / HBM stacks / SerDes
lanes).  Power is superlinear for compute (e = 1.5 by default: rate gains
come partly from frequency/voltage, which cost ~f*V^2) and linear for the
bandwidth subsystems (mostly more parallel lanes at constant clock).  Delay
``scale`` factors model degradation, not provisioned resources, so they
enter neither estimator.

Every method is plain arithmetic on duck-typed rate fields, so it accepts a
``sweep.MachineBatch``, a ``kernels_xp.MachineArrays``, or
a scalar ``MachineModel``.  Rates are host-side NumPy/Python floats here:
the silicon axes are bookkeeping on the host, not kernel work.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core.machine import MachineModel, TPU_V5E

#: The provisioned rates that enter the cost model, in canonical order.
#: Every accepted machine type (MachineModel, MachineBatch, MachineArrays)
#: exposes all four as attributes, ici_bw_total included.
RATE_FIELDS = ("peak_flops", "hbm_bw", "ici_bw_total", "inter_pod_bw")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Relative silicon area + dynamic power estimators vs a reference chip.

    ``area_weights`` are normalized to sum to 1 at evaluation time; the
    default equal split is the plain four-rate mean.

    Example -- the reference chip costs 1.0 area and ``1.0 + static_power``
    power by construction; reweighting changes variant rankings:

    >>> from repro_torch.core import CostModel, TPU_V5E
    >>> cm = CostModel()
    >>> round(float(cm.area(TPU_V5E)), 9)
    1.0
    >>> float(cm.power(TPU_V5E)) == 1.0 + cm.static_power
    True
    >>> compute_heavy = CostModel(area_weights={"peak_flops": 3.0,
    ...                                         "hbm_bw": 1.0})
    >>> denser = TPU_V5E.with_rates(name="2x", peak_flops=2 * TPU_V5E.peak_flops)
    >>> float(compute_heavy.area(denser)) > float(cm.area(denser))
    True
    """

    reference: MachineModel = TPU_V5E
    area_weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {f: 1.0 for f in RATE_FIELDS})
    power_weights: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {f: 1.0 for f in RATE_FIELDS})
    power_exponents: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"peak_flops": 1.5, "hbm_bw": 1.0,
                                 "ici_bw_total": 1.0, "inter_pod_bw": 1.0})
    static_power: float = 0.1

    def __post_init__(self) -> None:
        for mapping in (self.area_weights, self.power_weights,
                        self.power_exponents):
            for field in mapping:
                if field not in RATE_FIELDS:
                    raise KeyError(
                        f"unknown rate field {field!r}; have {RATE_FIELDS}")
        for name, mapping in (("area_weights", self.area_weights),
                              ("power_weights", self.power_weights)):
            if sum(mapping.get(f, 0.0) for f in RATE_FIELDS) <= 0.0:
                raise ValueError(
                    f"{name} must have a positive total over {RATE_FIELDS}")

    # ------------------------------------------------------------------ #

    def _norms(self, machines):
        """Per-rate throughput normalized to the reference chip."""
        return {f: getattr(machines, f) / getattr(self.reference, f)
                for f in RATE_FIELDS}

    def area(self, machines):
        """Relative silicon/cost proxy (1.0 = the reference chip)."""
        norms = self._norms(machines)
        total_w = sum(self.area_weights.get(f, 0.0) for f in RATE_FIELDS)
        return sum(self.area_weights.get(f, 0.0) * norms[f]
                   for f in RATE_FIELDS) / total_w

    def subsystem_area(self, machines, field: str):
        """One subsystem's relative area: ``rate_field / reference rate``.

        This is the quantity a per-subsystem area *envelope* budgets
        (``constrained_codesign(area_envelope={field: b})`` keeps it
        ``<= b``).  The ``area_weights`` deliberately do not enter: an
        envelope bounds the subsystem's provisioned throughput directly,
        while the weights only say how subsystems aggregate into the one
        scalar die-area proxy.  Consequence: a single-key envelope on
        ``field`` budgets exactly what a scalar ``area_budget`` under
        ``CostModel(area_weights={field: 1.0})`` budgets.

        >>> from repro_torch.core import CostModel, TPU_V5E
        >>> cm = CostModel()
        >>> float(cm.subsystem_area(TPU_V5E, "peak_flops"))
        1.0
        >>> single = CostModel(area_weights={"hbm_bw": 1.0})
        >>> denser = TPU_V5E.with_rates(name="2x", hbm_bw=2 * TPU_V5E.hbm_bw)
        >>> float(cm.subsystem_area(denser, "hbm_bw")) == float(single.area(denser))
        True
        """
        if field not in RATE_FIELDS:
            raise KeyError(f"unknown rate field {field!r}; have {RATE_FIELDS}")
        return getattr(machines, field) / getattr(self.reference, field)

    def power(self, machines):
        """Relative dynamic power proxy (1.0 + static at the reference)."""
        norms = self._norms(machines)
        total_w = sum(self.power_weights.get(f, 0.0) for f in RATE_FIELDS)
        dyn = sum(self.power_weights.get(f, 0.0)
                  * norms[f] ** self.power_exponents.get(f, 1.0)
                  for f in RATE_FIELDS) / total_w
        return self.static_power + dyn

    def objectives(self, machines):
        """(area, power) pair -- the two silicon axes of the 3-D front."""
        return self.area(machines), self.power(machines)


#: Default model: equal area weights (four-rate mean), DVFS-flavored power.
DEFAULT_COST_MODEL = CostModel()

"""One request object for every co-design entry point.

Five entry points (``run_sweep``, ``constrained_codesign``,
``joint_codesign``, ``frontier_codesign`` and the DSE ``evaluate``) grew
keyword surfaces that drifted apart; a serving front door cannot forward
five different signatures.  ``CodesignSpec`` is the unified request: one
frozen dataclass carrying budgets, envelopes, the frontier schedule,
descent knobs and the kernel backend, accepted by the co-design entry
points via ``spec=``.  The port of the JAX package's spec module; of its
consumers, ``constrained_codesign`` and ``joint_codesign`` are ported.

Resolution order is fixed and explicit everywhere: an explicitly-passed
keyword wins, then the spec's field, then the entry point's historical
default -- so ``constrained_codesign(..., spec=s, steps=5)`` runs 5 steps
no matter what ``s.steps`` says, and legacy keyword-only call sites are
byte-identical to their pre-spec behaviour (pinned in
tests/test_torch_constrained.py).

Validation is the ONE shared path: ``CodesignSpec.validate()`` delegates
to the same ``validate_area_envelope`` / ``_validate_budget_schedule`` /
``validate_backend_name`` / ``validate_suite_name`` checks the entry
points themselves run, so a spec that validates cannot fail parameter
checks downstream.  Backend names are the port's (``cuda``, ``torch``).

>>> spec = CodesignSpec(area_budget=1.0, steps=5)
>>> spec.validate().area_budget
1.0
>>> CodesignSpec.from_json(spec.to_json()) == spec
True
>>> CodesignSpec(projection="bogus").validate()
Traceback (most recent call last):
    ...
ValueError: unknown projection 'bogus'; have ('shift', 'euclidean')
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.kernels_xp import validate_backend_name

#: Constraint modes ``constrained_codesign`` accepts.
CONSTRAINED_MODES = ("projected", "lagrangian")
#: Selection modes ``joint_codesign`` accepts.
JOINT_MODES = ("alternate", "softmax")
#: Budget-projection retractions.
PROJECTIONS = ("shift", "euclidean")
#: Population generators ``run_sweep``/``shard_sweep`` accept.
SWEEP_MODES = ("random", "grid")


@dataclasses.dataclass(frozen=True)
class CodesignSpec:
    """Unified co-design request.

    Every field is optional; ``None`` means "use the entry point's
    default".  Fields irrelevant to an entry point are ignored there
    (``budgets`` only drives ``frontier_codesign``; ``n``/``sweep_mode``/
    ``seed`` only drive sweep requests), so one spec can describe a whole
    exploration session and be handed to each stage unchanged.
    """

    # ---- constraint set -------------------------------------------------
    area_budget: Optional[float] = None
    power_budget: Optional[float] = None
    area_envelope: Optional[Mapping[str, float]] = None
    budgets: Optional[Sequence[float]] = None   # frontier schedule
    # ---- descent knobs --------------------------------------------------
    mode: Optional[str] = None                  # constrained OR joint mode
    projection: Optional[str] = None
    steps: Optional[int] = None
    refine_steps: Optional[int] = None
    lr: Optional[float] = None
    span: Optional[float] = None
    warm_start: Optional[bool] = None
    optimize_links: Optional[bool] = None
    w_area: Optional[float] = None
    w_power: Optional[float] = None
    # ---- scoring --------------------------------------------------------
    beta: Optional[float] = None
    timing_model: Optional[str] = None
    cost_model: Optional[CostModel] = None
    backend: Optional[str] = None
    clamp: Optional[bool] = None
    # ---- sweep population ----------------------------------------------
    n: Optional[int] = None
    sweep_mode: Optional[str] = None
    seed: Optional[int] = None
    # ---- multi-tenant packing ------------------------------------------
    num_machines: Optional[int] = None          # pack_codesign fleet size
    # ---- bilevel budget descent (implicit.py) ---------------------------
    total_budget: Optional[float] = None        # split across area + power
    split0: Optional[float] = None              # initial area share, (0, 1)
    outer_steps: Optional[int] = None           # outer descent iterations
    outer_lr: Optional[float] = None            # outer step size on the split
    # ---- workload suite -------------------------------------------------
    suite: Optional[str] = None      # zoo[-smoke][:scenario] | gen:<count>

    # ------------------------------------------------------------------ #

    def validate(self) -> "CodesignSpec":
        """Run the shared validation path; returns a normalized copy.

        Delegates to the same checks the entry points run --
        ``validate_area_envelope`` (constrained), the budget-schedule
        validator (frontier) and ``validate_backend_name`` (kernels) --
        so validating here IS validating everywhere.
        """
        from repro_torch.core.constrained import validate_area_envelope
        from repro_torch.core.suites import validate_suite_name

        validate_suite_name(self.suite)
        envelope = validate_area_envelope(self.area_envelope)
        budgets: Optional[Tuple[float, ...]] = None
        if self.budgets is not None:
            budgets = tuple(_validate_budget_schedule(self.budgets))
        validate_backend_name(self.backend)
        for name, value in (("area_budget", self.area_budget),
                            ("power_budget", self.power_budget)):
            if value is not None and not value > 0.0:
                raise ValueError(f"{name} must be positive, got {value!r}")
        if (self.mode is not None
                and self.mode not in CONSTRAINED_MODES + JOINT_MODES):
            raise ValueError(
                f"unknown mode {self.mode!r}; have "
                f"{CONSTRAINED_MODES + JOINT_MODES}")
        if self.projection is not None and self.projection not in PROJECTIONS:
            raise ValueError(f"unknown projection {self.projection!r}; "
                             f"have {PROJECTIONS}")
        if self.sweep_mode is not None and self.sweep_mode not in SWEEP_MODES:
            raise ValueError(f"unknown sweep_mode {self.sweep_mode!r}; "
                             f"have {SWEEP_MODES}")
        for name in ("steps", "refine_steps", "n", "num_machines",
                     "outer_steps"):
            value = getattr(self, name)
            if value is not None and not int(value) > 0:
                raise ValueError(f"{name} must be positive, got {value!r}")
        for name in ("total_budget", "outer_lr"):
            value = getattr(self, name)
            if value is not None and not value > 0.0:
                raise ValueError(f"{name} must be positive, got {value!r}")
        if self.split0 is not None and not 0.0 < self.split0 < 1.0:
            raise ValueError("split0 must lie strictly inside (0, 1), "
                             f"got {self.split0!r}")
        return dataclasses.replace(self, area_envelope=envelope,
                                   budgets=budgets)

    # ------------------------------------------------------------------ #

    def to_json(self) -> dict:
        """Plain-JSON form (``None`` fields omitted; the default cost
        model is omitted too -- a custom one serializes structurally)."""
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            value = getattr(self, f.name)
            if value is None:
                continue
            if f.name == "cost_model":
                value = {
                    "reference": value.reference.to_json(),
                    "area_weights": dict(value.area_weights),
                    "power_weights": dict(value.power_weights),
                    "power_exponents": dict(value.power_exponents),
                    "static_power": value.static_power,
                }
            elif f.name == "area_envelope":
                value = dict(value)
            elif f.name == "budgets":
                value = [float(b) for b in value]
            out[f.name] = value
        return out

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "CodesignSpec":
        from repro_torch.core.machine import MachineModel

        kw = dict(d)
        cm = kw.get("cost_model")
        if isinstance(cm, Mapping):
            kw["cost_model"] = CostModel(
                reference=MachineModel.from_json(cm["reference"]),
                area_weights=dict(cm["area_weights"]),
                power_weights=dict(cm["power_weights"]),
                power_exponents=dict(cm["power_exponents"]),
                static_power=float(cm["static_power"]),
            )
        if kw.get("budgets") is not None:
            kw["budgets"] = tuple(float(b) for b in kw["budgets"])
        known = {f.name for f in dataclasses.fields(CodesignSpec)}
        unknown = set(kw) - known
        if unknown:
            raise ValueError(f"unknown CodesignSpec fields {sorted(unknown)}")
        return CodesignSpec(**kw)

    def __eq__(self, other) -> bool:
        if not isinstance(other, CodesignSpec):
            return NotImplemented
        norm = lambda s: tuple(
            (f.name, _normalize(getattr(s, f.name)))
            for f in dataclasses.fields(s))
        return norm(self) == norm(other)


def _validate_budget_schedule(budgets) -> List[float]:
    """Ascending, deduplicated, all-positive budget schedule as floats.

    The frontier's own validator; it moves to the port's ``frontier.py``
    when the feasibility frontier is ported (ROADMAP.md Queue 1 item 4)."""
    try:
        out = sorted({float(b) for b in budgets})
    except TypeError as exc:
        raise ValueError(
            f"budgets must be an iterable of numbers, got {budgets!r}"
        ) from exc
    if not out:
        raise ValueError("frontier_codesign needs at least one budget")
    for b in out:
        if not b > 0.0:
            raise ValueError(f"budgets must be positive, got {b!r}")
    return out


def _normalize(value):
    if isinstance(value, Mapping):
        return tuple(sorted(value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(value)
    return value


def resolve_spec(spec: Optional[CodesignSpec], defaults: Mapping[str, Any],
                 explicit: Mapping[str, Any]) -> Dict[str, Any]:
    """Final parameter values for one entry point.

    For each name in ``defaults``: an explicitly-passed (non-None) keyword
    wins, then the spec's field, then the default.  ``sweep_mode`` on the
    spec feeds a plain ``mode`` parameter on sweep entry points via the
    name itself -- callers pass the mapping they need.
    """
    out: Dict[str, Any] = {}
    for name, default in defaults.items():
        value = explicit.get(name)
        if value is None and spec is not None:
            value = getattr(spec, name, None)
        out[name] = default if value is None else value
    return out

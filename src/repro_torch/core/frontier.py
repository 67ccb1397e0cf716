"""Feasibility frontier J*(budget): warm-started budget continuation.

``constrained_codesign`` answers "what is the best machine under THIS
budget?"; early design exploration asks the inverse question -- "how much
fabric do I actually need?" -- which is the feasibility frontier

    J*(b) = min { J(m) : CostModel.area(m) <= b, m in the span box }

traced over a whole schedule of area budgets.  Running one cold
constrained descent per budget answers it at n times the price; this
module traces the entire frontier for little more than ONE constrained
run by warm-started continuation:

  * budgets are visited loosest -> tightest;
  * the first (loosest) budget gets a full descent from the seeds;
  * each tighter budget starts from the previous optimum, RE-PROJECTED
    onto the smaller feasible set (the projection is the first thing the
    shared descent loop applies), and only a short refinement descent
    runs -- the optimum under budget ``b`` is almost always a short
    projected step from the optimum under the next-looser budget;
  * the active budget enters the retraction as an ARGUMENT
    (``backtracking_descent``'s ``retract_args``), so the whole sweep
    shares one objective/gradient/projection -- continuation pays n small
    descents where n cold runs would pay n full descents.

Monotonicity is enforced BY CONSTRUCTION, not hoped for: the feasible
sets are nested (``b <= b'`` implies ``S(b) ⊆ S(b')``), so any machine
found under a tighter budget is also feasible under every looser one --
after the trace, solutions are propagated tightest -> loosest and a
looser budget adopts a tighter budget's machine whenever it scored
better.  The returned ``J*`` is therefore non-increasing in the budget
across every FEASIBLE point, exactly like the true frontier.
(Unattainable budgets -- below the span box's area floor -- are flagged
``feasible=False`` and record the floor point as a best effort; a floor
point violates its budget, so its J sits outside the frontier and is
excluded from the monotonicity contract, pinned in
tests/test_torch_frontier.py.)

``SweepResult.frontier`` bridges population sweeps into frontier traces
via the ``seed_codesign`` warm starts.

The port of the JAX package's frontier module.  The descent runs the
shared math in float64 torch on ``device`` (``"cuda"`` unless the caller
passes ``device="cpu"``; without a card it raises); the active budget
enters the retraction as a ``retract_args`` float, so the whole schedule
shares one objective, gradient and projection.  The monotone propagation
and the continuation state stay on the host in NumPy, so a cached
continuation (the co-design service's) holds no card memory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core import kernels_xp as K
from repro_torch.core.codesign import (
    OPT_FIELDS,
    _as_batches,
    _objective_terms,
    backtracking_descent,
    machine_arrays_from_theta,
    params_of_theta,
    resolve_beta,
    theta_box,
)
from repro_torch.core.constrained import (
    FEASIBLE_RTOL,
    budget_feasible,
    project_to_budgets,
    validate_area_envelope,
)
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.machine import MachineModel


def _validate_budget_schedule(budgets) -> List[float]:
    """Ascending, deduplicated, all-positive budget schedule as floats."""
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


@dataclasses.dataclass
class FrontierResult:
    """One traced feasibility frontier (all arrays indexed by budget,
    ascending -- so ``objective`` is non-increasing left to right over
    the ``feasible`` points; infeasible rows are best-effort floor
    points).

    ``per_seed_objective`` keeps the RAW per-(budget, seed) descent
    outcomes before the monotone propagation, for diagnostics; the
    ``objective``/``best_*`` fields are the frontier proper.

    >>> import numpy as np
    >>> r = FrontierResult(
    ...     budgets=np.array([0.5, 1.0, 2.0]),
    ...     objective=np.array([3.0, 1.2, 1.0]),
    ...     best_names=["a", "a", "b"],
    ...     best_params=[{"peak_flops": 1e14, "hbm_bw": 1e11, "ici_bw": 1e10,
    ...                   "ici_links": 4.0, "inter_pod_bw": 1e10,
    ...                   "scale_compute": 1.0, "scale_memory": 1.0,
    ...                   "scale_interconnect": 1.0}] * 3,
    ...     area=np.array([0.5, 1.0, 1.6]), power=np.array([0.6, 1.1, 1.7]),
    ...     feasible=np.array([True, True, True]),
    ...     per_seed_objective=np.array([[3.0], [1.2], [1.0]]),
    ...     seed_names=["a"], steps=4, refine_steps=2, warm_start=True)
    >>> len(r)
    3
    >>> float(r.knee())               # diminishing returns set in at 1.0
    1.0
    >>> r.best_at(1.5).name           # largest traced budget <= 1.5
    'a+frontier@1'
    >>> bool(np.all(np.diff(r.objective) <= 0))
    True
    """

    budgets: np.ndarray              # (N,) ascending area budgets
    objective: np.ndarray            # (N,) J*(budget); non-increasing
                                     # across the feasible points
    best_names: List[str]            # (N,) winning seed name per budget
    best_params: List[Dict[str, float]]  # (N,) full machine params
    area: np.ndarray                 # (N,) CostModel.area of the winner
    power: np.ndarray                # (N,) CostModel.power of the winner
    feasible: np.ndarray             # (N,) bool (False: budget unattainable)
    per_seed_objective: np.ndarray   # (N, V) raw continuation outcomes
    seed_names: List[str]
    steps: int
    refine_steps: int
    warm_start: bool
    power_budget: Optional[float] = None
    area_envelope: Optional[Dict[str, float]] = None
    suffix: str = "+frontier"
    # Continuation state (``keep_state=True``): raw per-budget theta plus
    # the final backtracking learning rate, so a later trace can warm-start
    # from the nearest already-solved budget (the serving front door's
    # frontier cache).
    continuation: Optional[Dict[float, np.ndarray]] = None
    final_lr: Optional[np.ndarray] = None    # (V,) per-variant backtracking lr
    # Implicit sensitivities, attached by ``frontier_codesign``
    # unless ``sensitivities=False``: per-budget ``dJ*/d(area budget)``
    # (zero on propagated flat segments -- the area constraint is slack
    # there), the full per-constraint shadow prices, and the constraint
    # column names.  NaN rows are infeasible floor points.
    dJ_dbudget: Optional[np.ndarray] = None          # (N,)
    shadow_prices: Optional[np.ndarray] = None       # (N, C)
    sensitivity_constraints: Optional[Tuple[str, ...]] = None

    def __len__(self) -> int:
        return len(self.budgets)

    def _sensitivity_blob(self, i: int) -> dict:
        """Per-point sensitivity keys for ``to_json`` ({} when absent or
        the row is an infeasible floor point)."""
        if (self.dJ_dbudget is None
                or not np.isfinite(self.dJ_dbudget[i])):
            return {}
        return {
            "dJ_dbudget": float(self.dJ_dbudget[i]),
            "shadow_prices": {
                c: float(self.shadow_prices[i, j])
                for j, c in enumerate(self.sensitivity_constraints)},
        }

    def _rows(self, top_k: Optional[int]) -> List[int]:
        """Budget rows to report: all, or the ``top_k`` best-objective
        points (ascending budget order preserved)."""
        if top_k is None:
            return list(range(len(self)))
        keep = sorted(range(len(self)),
                      key=lambda i: (float(self.objective[i]), i))[:top_k]
        return sorted(keep)

    # --------------------------- extractions -------------------------- #

    def best_model(self, i: int) -> MachineModel:
        """The frontier machine at budget index ``i`` (name carries the
        budget so sweeping several frontiers stays unambiguous)."""
        p = self.best_params[i]
        return MachineModel(
            name=f"{self.best_names[i]}{self.suffix}"
                 f"@{self.budgets[i]:g}",
            peak_flops=p["peak_flops"],
            hbm_bw=p["hbm_bw"],
            ici_bw=p["ici_bw"],
            ici_links=int(round(p["ici_links"])),
            inter_pod_bw=p["inter_pod_bw"],
            scale={"compute": p["scale_compute"],
                   "memory": p["scale_memory"],
                   "interconnect": p["scale_interconnect"]},
        )

    def best_at(self, budget: float) -> MachineModel:
        """Best traced machine affordable within ``budget``: the frontier
        point at the largest traced budget ``<= budget`` (feasible sets
        are nested, so that machine fits under ``budget`` too).  Raises
        when ``budget`` is below every traced point or only unattainable
        points fit."""
        idx = [i for i in range(len(self)) if
               self.budgets[i] <= budget * (1.0 + FEASIBLE_RTOL)
               and bool(self.feasible[i])]
        if not idx:
            raise ValueError(
                f"no feasible frontier point within budget {budget!r}; "
                f"traced budgets: {np.round(self.budgets, 4).tolist()}")
        return self.best_model(idx[-1])

    def knee(self) -> float:
        """The budget where diminishing returns set in: the feasible point
        farthest from the chord joining the tightest and loosest feasible
        frontier points in the normalized (budget, J*) plane -- the classic
        max-distance-to-chord knee.  A flat frontier's knee is its
        tightest feasible budget (spending more buys nothing); fewer than
        three feasible points degenerate the chord, returning the loosest.
        """
        idx = np.nonzero(self.feasible)[0]
        if len(idx) == 0:
            raise ValueError("no feasible frontier points")
        b, j = self.budgets[idx], self.objective[idx]
        if len(idx) < 3:
            return float(b[-1])
        bn = (b - b[0]) / ((b[-1] - b[0]) or 1.0)
        jn = (j - j[-1]) / ((j[0] - j[-1]) or 1.0)
        # Chord runs (0, 1) -> (1, 0); distance is |bn + jn - 1| / sqrt(2).
        dist = np.abs(bn + jn - 1.0)
        return float(b[int(np.argmax(dist))])

    # ----------------------------- reports ---------------------------- #

    def markdown(self, top_k: Optional[int] = None) -> str:
        knee = self.knee() if bool(np.any(self.feasible)) else None
        lines = [
            f"feasibility frontier: {len(self)} area budgets, "
            f"{len(self.seed_names)} seeds, "
            f"{'warm-started continuation' if self.warm_start else 'cold starts'} "
            f"({self.steps} + {self.refine_steps}/budget steps)",
            "",
            "| area budget | J*(budget) | best seed | area | power "
            "| feasible | knee |"
            + (" dJ*/db | shadow price |"
               if self.dJ_dbudget is not None else ""),
            "|---" * (9 if self.dJ_dbudget is not None else 7) + "|",
        ]
        for i in self._rows(top_k):
            row = (
                f"| {self.budgets[i]:.4g} | {self.objective[i]:.4f} "
                f"| {self.best_names[i]} | {self.area[i]:.3f} "
                f"| {self.power[i]:.3f} "
                f"| {'yes' if self.feasible[i] else 'NO'} "
                f"| {'*' if knee is not None and self.budgets[i] == knee else ''} |")
            if self.dJ_dbudget is not None:
                dj = float(self.dJ_dbudget[i])
                row += (f" {dj:.4f} | {-dj:.4f} |"
                        if np.isfinite(dj) else " - | - |")
            lines.append(row)
        if self.dJ_dbudget is not None:
            lines += ["", "shadow price = -dJ*/d(area budget): the "
                          "first-order J* gain per unit of extra area "
                          "budget (0 on flat, slack segments)."]
        if self.area_envelope:
            lines += ["", f"per-subsystem envelopes: {self.area_envelope}"]
        if self.power_budget is not None:
            lines += ["", f"power budget (fixed): {self.power_budget}"]
        return "\n".join(lines)

    def to_json(self, top_k: Optional[int] = None) -> dict:
        out = {
            "budgets": [float(b) for b in self.budgets],
            "objective": [float(j) for j in self.objective],
            "seed_names": list(self.seed_names),
            "steps": self.steps,
            "refine_steps": self.refine_steps,
            "warm_start": self.warm_start,
            "points": [
                {"budget": float(self.budgets[i]),
                 "objective": float(self.objective[i]),
                 "best_seed": self.best_names[i],
                 "area": float(self.area[i]),
                 "power": float(self.power[i]),
                 "feasible": bool(self.feasible[i]),
                 "params": self.best_params[i],
                 **self._sensitivity_blob(i)}
                for i in self._rows(top_k)],
        }
        if self.sensitivity_constraints is not None:
            out["sensitivity_constraints"] = list(
                self.sensitivity_constraints)
        if bool(np.any(self.feasible)):
            out["knee"] = self.knee()
        if self.power_budget is not None:
            out["power_budget"] = self.power_budget
        if self.area_envelope:
            out["area_envelope"] = dict(self.area_envelope)
        return out


_FRONTIER_DEFAULTS = dict(
    budgets=None, power_budget=None, area_envelope=None, steps=100,
    refine_steps=None, lr=0.1, span=16.0, beta=None, timing_model="serial",
    cost_model=DEFAULT_COST_MODEL, w_area=0.1, w_power=0.05,
    warm_start=True, projection="shift",
)


def frontier_codesign(
    profiles,
    machines,
    budgets: Optional[Sequence[float]] = None,
    *,
    power_budget: Optional[float] = None,
    area_envelope: Optional[Mapping[str, float]] = None,
    steps: Optional[int] = None,
    refine_steps: Optional[int] = None,
    lr: Optional[float] = None,
    span: Optional[float] = None,
    beta=None,
    beta_ref: int = 0,
    timing_model: Optional[str] = None,
    eps: float = K.IDEAL_EPS,
    cost_model: Optional[CostModel] = None,
    w_area: Optional[float] = None,
    w_power: Optional[float] = None,
    warm_start: Optional[bool] = None,
    projection: Optional[str] = None,
    warm_theta: Optional[np.ndarray] = None,
    warm_lr=None,                      # scalar or (V,) per-variant lr
    keep_state: bool = False,
    sensitivities: bool = True,
    spec=None,
    device=K.DEFAULT_DEVICE,
) -> FrontierResult:
    """Trace J*(budget) over a schedule of area budgets by continuation.

    ``budgets`` is any iterable of positive area budgets (deduplicated and
    traced loosest -> tightest internally; the result is reported in
    ascending budget order).  ``power_budget`` and ``area_envelope`` are
    HELD FIXED across the sweep -- only the scalar area budget moves, so
    the frontier isolates one axis exactly like the paper's
    "how much fabric?" question.  ``steps`` is the full descent at the
    loosest budget; each tighter budget re-projects the previous optimum
    and refines for ``refine_steps`` (default ``max(steps // 5, 1)``).
    ``warm_start=False`` runs every budget cold from the seeds (same code
    path; it prices the continuation against cold starts).  Descent is
    projected-gradient (``projection`` picks the shift or Euclidean
    retraction); every frontier point is feasible to ``FEASIBLE_RTOL``
    whenever its budget is attainable inside the span box.

    Example (two budgets, the named seeds; J* never worsens with budget):

    >>> import numpy as np
    >>> from repro_torch.core import VARIANTS, WorkloadProfile, frontier_codesign
    >>> from repro_torch.core.sweep import MachineBatch
    >>> apps = [WorkloadProfile(name="app0", flops=2e14, hbm_bytes=1.5e11,
    ...                         collective_bytes={"all-reduce": 2e10},
    ...                         num_devices=256, model_flops=5e16)]
    >>> fr = frontier_codesign(apps, MachineBatch.from_models(VARIANTS),
    ...                        budgets=[1.2, 0.6], steps=4, refine_steps=2,
    ...                        device="cpu")
    >>> fr.budgets.tolist()
    [0.6, 1.2]
    >>> bool(np.all(np.diff(fr.objective) <= 1e-12))   # monotone J*
    True
    >>> bool(fr.feasible.all())
    True
    >>> bool((fr.area <= fr.budgets * (1 + 1e-9)).all())
    True

    A ``spec=CodesignSpec(...)`` fills unset parameters, ``budgets``
    included (explicit keyword > spec field > default).  ``warm_theta`` /
    ``warm_lr`` resume the continuation from a previous run's saved state
    (the serving front door's warm-start cache): the loosest budget then
    refines for ``refine_steps`` instead of descending ``steps`` cold.
    ``keep_state=True`` attaches the per-budget raw thetas and final
    backtracking lr to the result (``continuation`` / ``final_lr``) so a
    later, tighter schedule can resume.  The descent runs in float64 on
    ``device`` (``"cuda"`` by default; it raises without a card unless
    ``device="cpu"``).
    """
    from repro_torch.core.spec import resolve_spec

    r = resolve_spec(spec, _FRONTIER_DEFAULTS, dict(
        budgets=budgets, power_budget=power_budget,
        area_envelope=area_envelope, steps=steps, refine_steps=refine_steps,
        lr=lr, span=span, beta=beta, timing_model=timing_model,
        cost_model=cost_model, w_area=w_area, w_power=w_power,
        warm_start=warm_start, projection=projection))
    budgets, power_budget = r["budgets"], r["power_budget"]
    area_envelope, steps, refine_steps = (r["area_envelope"], r["steps"],
                                          r["refine_steps"])
    lr, span, beta, timing_model = r["lr"], r["span"], r["beta"], \
        r["timing_model"]
    cost_model, w_area, w_power = r["cost_model"], r["w_area"], r["w_power"]
    warm_start, projection = r["warm_start"], r["projection"]

    if budgets is None:
        raise ValueError("frontier_codesign needs a budget schedule "
                         "(budgets=... or spec.budgets)")
    asc = _validate_budget_schedule(budgets)
    area_envelope = validate_area_envelope(area_envelope)
    if power_budget is not None and not power_budget > 0.0:
        raise ValueError(f"power_budget must be positive, got {power_budget!r}")
    if refine_steps is None:
        refine_steps = max(steps // 5, 1)
    backend = K.get_backend("torch", device)

    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    theta0, lo, hi = theta_box(mb, span)

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)

    def objective(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power)

    def retract(theta, budget):
        # ``budget`` is an ARGUMENT: one objective/gradient/projection
        # serves every budget in the schedule.
        out, _ = project_to_budgets(
            torch, theta, lo_t, hi_t, fixed, cost_model, budget,
            power_budget, area_envelope=area_envelope, method=projection)
        return out

    cache: dict = {}
    # A caller-provided warm_theta (e.g. the serving cache's nearest
    # already-solved budget) replaces the cold seeds: the loosest
    # budget then only refines, exactly like an interior budget would.
    resumed = warm_start and warm_theta is not None
    theta = backend.asarray(warm_theta if resumed else theta0)
    lr_v = (warm_lr if resumed and warm_lr is not None else lr)
    raw: Dict[float, np.ndarray] = {}
    raw_obj: Dict[float, np.ndarray] = {}
    for j, b in enumerate(reversed(asc)):          # loosest -> tightest
        warm = warm_start and (j > 0 or resumed)
        n_steps = refine_steps if warm else steps
        start = theta if warm_start else backend.asarray(theta0)
        start_lr = lr_v if warm_start else lr
        theta_b, f_b, _, _, lr_out = backtracking_descent(
            start, objective, n_steps, start_lr,
            retract=retract, retract_args=(float(b),), cache=cache)
        if warm_start:
            theta, lr_v = theta_b, lr_out
        raw[b] = backend.to_numpy(theta_b)
        raw_obj[b] = backend.to_numpy(f_b)

    # Monotone propagation, tightest -> loosest: a tighter budget's winner
    # is feasible at every looser budget, so carrying the incumbent up
    # makes J* non-increasing in the budget BY CONSTRUCTION.
    n = len(asc)
    objective_arr = np.empty(n)
    area_arr, power_arr = np.empty(n), np.empty(n)
    feasible_arr = np.zeros(n, dtype=bool)
    best_names: List[str] = [""] * n
    best_params: List[Dict[str, float]] = [{}] * n
    seed_idx = np.zeros(n, dtype=int)
    per_seed = np.stack([raw_obj[b] for b in asc], axis=0)
    carry = None
    for i, b in enumerate(asc):
        th_i, f_i = raw[b], raw_obj[b]
        m_i = machine_arrays_from_theta(np, th_i, fixed_np)
        feas_i = budget_feasible(np, m_i, cost_model, b, power_budget,
                                 area_envelope=area_envelope)
        k = int(np.argmin(np.where(feas_i, f_i, np.inf))
                if bool(feas_i.any()) else np.argmin(f_i))
        cand = {
            "obj": float(f_i[k]),
            "params": params_of_theta(th_i[k], fixed_np, k),
            "name": mb.names[k],
            "seed": k,
            "feasible": bool(feas_i[k]),
            "area": float(np.asarray(cost_model.area(m_i))[k]),
            "power": float(np.asarray(cost_model.power(m_i))[k]),
        }
        if carry is not None and (not cand["feasible"]
                                  or carry["obj"] < cand["obj"]):
            cand = carry
        if cand["feasible"]:
            carry = cand
        objective_arr[i] = cand["obj"]
        best_names[i] = cand["name"]
        best_params[i] = cand["params"]
        seed_idx[i] = cand["seed"]
        feasible_arr[i] = cand["feasible"]
        area_arr[i] = cand["area"]
        power_arr[i] = cand["power"]

    # First-order implicit sensitivities at each frontier point: the
    # budget rows act as "variants" (per-row fixed arrays + per-row area
    # budget), one KKT solve on the converged designs -- see
    # repro_torch.core.implicit.  Propagated rows have a slack area
    # constraint, so their shadow price is 0, matching the flat frontier
    # segment.
    dj_db = prices = constraint_names = None
    if sensitivities and bool(feasible_arr.any()):
        from repro_torch.core.implicit import _first_order_report

        row_fixed = K.MachineArrays(**{
            f: np.array([p[f] for p in best_params], dtype=np.float64)
            for f in K.MachineArrays._fields})
        theta_rows = np.log(np.stack(
            [[p[f] for f in OPT_FIELDS] for p in best_params]))
        rep = _first_order_report(
            pb, best_names, row_fixed, theta_rows, lo[seed_idx],
            hi[seed_idx], area_budget=np.asarray(asc),
            power_budget=power_budget, area_envelope=area_envelope,
            cost_model=cost_model, beta_np=beta_np,
            timing_model=timing_model, eps=eps, w_area=w_area,
            w_power=w_power, device=device)
        prices = np.where(feasible_arr[:, None], rep.multipliers, np.nan)
        dj_db = -prices[:, 0]            # area is always column 0 here
        constraint_names = rep.constraint_names

    return FrontierResult(
        budgets=np.asarray(asc),
        objective=objective_arr,
        best_names=best_names,
        best_params=best_params,
        area=area_arr,
        power=power_arr,
        feasible=feasible_arr,
        per_seed_objective=per_seed,
        seed_names=list(mb.names),
        steps=steps,
        refine_steps=refine_steps,
        warm_start=warm_start,
        power_budget=power_budget,
        area_envelope=area_envelope,
        continuation=dict(raw) if keep_state else None,
        final_lr=backend.to_numpy(lr_v) if keep_state else None,
        dJ_dbudget=dj_db,
        shadow_prices=prices,
        sensitivity_constraints=constraint_names,
    )

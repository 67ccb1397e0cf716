"""Multi-tenant packing: A apps across M machine instances.

The natural question after single-machine co-design: given a FLEET of ``M``
machine instances and ``A`` applications, which apps should live on which
machine, and what should each machine look like, under per-subsystem
envelopes and a TOTAL silicon budget shared by the whole fleet?

``pack_codesign`` answers by alternation, reusing the group-axis
machinery of ``joint_codesign`` with the roles transposed -- there, each
app GROUP picks one sharding variant per machine; here, each APP picks
one machine instance:

  * assignment step -- the ``(A, M)`` aggregate-congruence matrix under
    the current fleet hardens to a one-hot argmin per app (or relaxes to
    an annealed softmax in ``mode="softmax"``);
  * descent step -- all ``M`` machines descend JOINTLY as one flattened
    ``(1, M*D)`` log-rate vector through the shared
    ``backtracking_descent``, so the fleet-total budget couples them
    while the assignment weights decouple the fit terms.

The retraction composes the per-machine operators of
``repro_torch.core.constrained`` (span-clip box ∩ per-subsystem envelope, per
instance) with a FLEET budget projection: one scalar downward log-shift
applied to every machine, bisected so the summed area/power meets the
total budget -- monotone in the shift, so the bisection is exact to f64
resolution, and rate decreases preserve envelope feasibility.

A ``budgets`` schedule traces the fleet-level frontier J*(total budget)
by warm-started continuation exactly like ``frontier_codesign`` (budget
enters the retraction as an argument; one objective/gradient/retraction
serves the whole schedule; monotone propagation carries tighter-budget
incumbents to looser budgets).  ``PackingResult`` implements the uniform
``markdown(top_k)`` / ``to_json(top_k)`` protocol, so packing requests
serve through ``repro_torch.serving`` unchanged.

The port of the JAX package's packing module: the descent runs the shared
math in float64 torch on ``device`` (``"cuda"`` unless the caller passes
``device="cpu"``; without a card it raises), the bisection of the fleet
shift is a Python loop, and the hard assignment is the argmin of the
float64 aggregate (a float32 one could flip an argmin near a tie).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

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
    PROJECT_ITERS,
    _iterate,
    budget_feasible,
    project_to_budgets,
    validate_area_envelope,
)
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.sweep import MachineBatch

#: Packing assignment modes (mirrors ``joint_codesign``).
PACK_MODES = ("alternate", "softmax")

_PACK_DEFAULTS = dict(
    mode="alternate", steps=60, lr=0.1, span=16.0, beta=None,
    timing_model="serial", cost_model=DEFAULT_COST_MODEL,
    w_area=0.1, w_power=0.05, area_budget=None, power_budget=None,
    area_envelope=None, budgets=None, num_machines=4,
)


# --------------------------------------------------------------------------- #
# Assignment weights and the fleet objective
# --------------------------------------------------------------------------- #


def _pack_weights(agg: np.ndarray) -> np.ndarray:
    """``(A, M)`` one-hot-per-app weights: app ``a`` puts ``1/A`` on its
    argmin machine, so summing ``w * agg`` over both axes is the mean
    assigned aggregate (the transpose of ``joint``'s ``_hard_weights``)."""
    a, _ = agg.shape
    w = np.zeros_like(agg)
    w[np.arange(a), np.argmin(agg, axis=1)] = 1.0 / a
    return w


def _soft_weights(agg: np.ndarray, temp: float) -> np.ndarray:
    """Annealed-softmax assignment: rows sum to ``1/A``; hardens to
    ``_pack_weights`` as ``temp -> 0``."""
    a, _ = agg.shape
    z = -(agg - agg.min(axis=1, keepdims=True)) / max(temp, 1e-9)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True) / a


def fleet_objective(
    profiles,
    machines,
    *,
    beta=None,
    beta_ref: int = 0,
    timing_model: str = "serial",
    eps: float = K.IDEAL_EPS,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    w_area: float = 0.1,
    w_power: float = 0.05,
) -> float:
    """Best-assignment fleet J for ANY fleet (NumPy reference, scalar).

    Every app is assigned to its argmin machine; silicon terms sum over
    the whole fleet -- the exact objective ``pack_codesign`` descends, so
    this is the yardstick for comparing a packed fleet against, e.g., M
    copies of the best single-machine design (the acceptance pin in
    tests/test_torch_packing.py).
    """
    pb, mb = _as_batches(profiles, machines)
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    p, m = pb.arrays(), mb.arrays()
    out = K.congruence_kernel(np, p, m, beta_np, timing_model, eps,
                              clamp=False)
    agg = np.asarray(out.aggregate)
    fit = float(agg.min(axis=1).mean())
    return (fit + w_area * float(np.sum(cost_model.area(m)))
            + w_power * float(np.sum(cost_model.power(m))))


# --------------------------------------------------------------------------- #
# Fleet-total budget projection (one scalar shift across all machines)
# --------------------------------------------------------------------------- #


def _fleet_shift(th, lo, fixed, cost_model: CostModel, area_budget,
                 power_budget, iters: int = PROJECT_ITERS):
    """Retract an ``(M, D)`` fleet onto the TOTAL-budget sublevel set.

    One scalar downward log-shift ``t`` (a uniform multiplicative rescale
    of every rate on every machine), floored at the box's lower edge,
    bisected to the smallest ``t >= 0`` with ``sum(area) <= area_budget``
    (and ``sum(power) <= power_budget`` when set).  Every summed quantity
    is strictly increasing in every rate, so feasibility is monotone in
    ``t`` and the bisection is exact to f64 resolution; shifting DOWN
    also preserves any per-machine envelope feasibility established
    before the call.  Torch tensors in and out; the bisection is a Python
    loop of ``iters`` steps with no host sync.
    """

    def at(t):
        return torch.maximum(th - t, lo)

    def ok(t):
        m = machine_arrays_from_theta(torch, at(t), fixed)
        good = torch.ones((), dtype=torch.bool, device=th.device)
        if area_budget is not None:
            good = good & (torch.sum(cost_model.area(m)) <= area_budget)
        if power_budget is not None:
            good = good & (torch.sum(cost_model.power(m)) <= power_budget)
        return good

    zero = th.new_zeros(())
    t_floor = torch.amax(th - lo)
    ok0 = ok(zero)

    def bisect_step(_, bracket):
        t_lo, t_hi = bracket
        mid = 0.5 * (t_lo + t_hi)
        okm = ok(mid)
        return (torch.where(okm, t_lo, mid), torch.where(okm, mid, t_hi))

    _, t_hi = _iterate(bisect_step, (zero, t_floor), iters)
    return at(torch.where(ok0, zero, t_hi))


def _fleet_feasible(m: K.MachineArrays, cost_model: CostModel,
                    area_budget: Optional[float],
                    power_budget: Optional[float],
                    area_envelope: Optional[Mapping[str, float]],
                    rtol: float = FEASIBLE_RTOL) -> bool:
    """Fleet-total budgets + every machine's envelope, to relative rtol."""
    ok = True
    if area_budget is not None:
        ok &= float(np.sum(cost_model.area(m))) <= area_budget * (1.0 + rtol)
    if power_budget is not None:
        ok &= float(np.sum(cost_model.power(m))) <= power_budget * (1.0 + rtol)
    if area_envelope:
        ok &= bool(np.all(budget_feasible(
            np, m, cost_model, None, None, rtol=rtol,
            area_envelope=area_envelope)))
    return bool(ok)


# --------------------------------------------------------------------------- #
# Result
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class PackingResult:
    """Outcome of one multi-tenant packing run.

    ``assignment[a]`` is the machine index app ``a`` landed on;
    ``trajectory`` is the accepted-objective history (monotone
    non-increasing in ``mode="alternate"`` -- descent steps only accept
    improvements and argmin re-assignment only lowers the fit term).
    When a ``budgets`` schedule was traced, the ``frontier_*`` arrays
    hold J*(total budget) ascending by budget and the main fields
    describe the TIGHTEST budget's fleet.

    Implements the uniform result protocol (``markdown(top_k)`` /
    ``to_json(top_k)``), so the serving front door renders it unchanged.
    """

    app_names: List[str]
    machine_names: List[str]
    assignment: np.ndarray            # (A,) machine index per app
    machines: MachineBatch            # the final fleet (M rows)
    seed_params: List[Dict[str, float]]
    final_params: List[Dict[str, float]]
    objective_seed: float
    objective_final: float
    trajectory: np.ndarray            # accepted fleet-J history
    per_app_aggregate: np.ndarray     # (A,) aggregate at the assigned machine
    area_total: float
    power_total: float
    feasible: Optional[bool]          # None when unconstrained
    mode: str = "alternate"
    steps: int = 0
    rounds: int = 0
    w_area: float = 0.1
    w_power: float = 0.05
    area_budget: Optional[float] = None      # fleet TOTAL
    power_budget: Optional[float] = None     # fleet TOTAL
    area_envelope: Optional[Dict[str, float]] = None
    budgets: Optional[np.ndarray] = None          # frontier schedule (asc)
    frontier_objective: Optional[np.ndarray] = None
    frontier_area: Optional[np.ndarray] = None
    frontier_feasible: Optional[np.ndarray] = None

    # ------------------------------ lookups --------------------------- #

    @property
    def improvement(self) -> float:
        return self.objective_seed - self.objective_final

    def apps_on(self, machine: int) -> List[str]:
        """App names assigned to machine index ``machine``."""
        return [a for a, mi in zip(self.app_names, self.assignment)
                if int(mi) == machine]

    # ------------------------------ reports --------------------------- #

    def markdown(self, top_k: Optional[int] = None) -> str:
        """Fleet table + assignment summary (``top_k`` caps listed app
        names per machine and frontier rows; None means the default 10,
        per the uniform result protocol)."""
        top_k = 10 if top_k is None else top_k
        m = self.machines
        lines = [
            f"packing: {len(self.app_names)} apps across "
            f"{len(m)} machines (pack-{self.mode}, {self.steps} steps, "
            f"{self.rounds} rounds)",
            f"objective: {self.objective_seed:.4f} -> "
            f"{self.objective_final:.4f} "
            f"(improvement {self.improvement:.4f})",
            f"fleet: area={self.area_total:.3f}"
            + (f" (budget {self.area_budget:.3f})"
               if self.area_budget is not None else "")
            + f" power={self.power_total:.3f}"
            + (f" (budget {self.power_budget:.3f})"
               if self.power_budget is not None else "")
            + ("" if self.feasible is None
               else f" feasible={bool(self.feasible)}"),
            "",
            "| machine | apps | mean agg | area | peak_flops | hbm_bw "
            "| ici_bw x links | inter_pod_bw |",
            "|---" * 8 + "|",
        ]
        for i in range(len(m)):
            rows = np.nonzero(self.assignment == i)[0]
            mean_agg = (float(self.per_app_aggregate[rows].mean())
                        if len(rows) else float("nan"))
            area_i = float(DEFAULT_COST_MODEL.area(m.take([i]))[0])
            lines.append(
                f"| {m.names[i]} | {len(rows)} | {mean_agg:.4f} "
                f"| {area_i:.3f} | {m.peak_flops[i]:.3e} "
                f"| {m.hbm_bw[i]:.3e} "
                f"| {m.ici_bw[i]:.3e} x {int(m.ici_links[i])} "
                f"| {m.inter_pod_bw[i]:.3e} |")
        lines.append("")
        for i in range(len(m)):
            apps = self.apps_on(i)
            shown = ", ".join(apps[:top_k])
            more = f" (+{len(apps) - top_k} more)" if len(apps) > top_k else ""
            lines.append(f"- {m.names[i]}: {shown or '(idle)'}{more}")
        if self.budgets is not None:
            lines += ["", f"fleet frontier J*(total budget) "
                          f"({len(self.budgets)} budgets, ascending):", ""]
            for j, b in enumerate(self.budgets[:top_k]):
                feas = bool(self.frontier_feasible[j])
                lines.append(
                    f"- budget {float(b):.3f}: "
                    f"J*={float(self.frontier_objective[j]):.4f} "
                    f"area={float(self.frontier_area[j]):.3f} "
                    f"{'feasible' if feas else 'INFEASIBLE'}")
        return "\n".join(lines)

    def to_json(self, top_k: Optional[int] = None) -> dict:
        top_k = 10 if top_k is None else top_k
        out = {
            "num_apps": len(self.app_names),
            "num_machines": len(self.machines),
            "mode": f"pack-{self.mode}",
            "steps": self.steps,
            "rounds": self.rounds,
            "objective_seed": self.objective_seed,
            "objective_final": self.objective_final,
            "improvement": self.improvement,
            "area_total": self.area_total,
            "power_total": self.power_total,
            "feasible": (None if self.feasible is None
                         else bool(self.feasible)),
            "area_budget": self.area_budget,
            "power_budget": self.power_budget,
            "area_envelope": (dict(self.area_envelope)
                              if self.area_envelope else None),
            "assignment": {app: self.machines.names[int(mi)]
                           for app, mi in zip(self.app_names,
                                              self.assignment)},
            "machines": [
                {"machine": self.machines.names[i],
                 "num_apps": int(np.sum(self.assignment == i)),
                 "apps": self.apps_on(i)[:top_k],
                 "params": self.final_params[i]}
                for i in range(len(self.machines))],
            "trajectory": [float(v) for v in self.trajectory],
        }
        if self.budgets is not None:
            out["frontier"] = [
                {"budget": float(b),
                 "objective": float(self.frontier_objective[j]),
                 "area_total": float(self.frontier_area[j]),
                 "feasible": bool(self.frontier_feasible[j])}
                for j, b in enumerate(self.budgets)]
        return out


# --------------------------------------------------------------------------- #
# The packing descent
# --------------------------------------------------------------------------- #


def pack_codesign(
    profiles,
    machines,
    *,
    num_machines: Optional[int] = None,
    mode: Optional[str] = None,
    rounds: int = 4,
    steps: Optional[int] = None,
    lr: Optional[float] = None,
    span: Optional[float] = None,
    beta=None,
    beta_ref: int = 0,
    timing_model: Optional[str] = None,
    eps: float = K.IDEAL_EPS,
    cost_model: Optional[CostModel] = None,
    w_area: Optional[float] = None,
    w_power: Optional[float] = None,
    area_budget: Optional[float] = None,
    power_budget: Optional[float] = None,
    area_envelope: Optional[Mapping[str, float]] = None,
    budgets: Optional[Sequence[float]] = None,
    temp0: float = 1.0,
    temp_min: float = 0.05,
    spec=None,
    device=K.DEFAULT_DEVICE,
) -> PackingResult:
    """Assign ``A`` apps across ``num_machines`` instances by alternation.

    ``profiles`` accepts everything suite strings are accepted as
    elsewhere (a ``gen:<count>`` generated suite, a zoo suite, a profile
    list or a ``ProfileBatch``).  ``machines`` seeds the fleet: its rows
    are cycled up to ``num_machines`` instances, each descending its own
    log-rates.  ``area_budget`` / ``power_budget`` bound the fleet TOTAL
    (not each instance); ``area_envelope`` caps each instance
    per-subsystem, exactly as in ``constrained_codesign``.

    ``mode="alternate"`` hardens the assignment to each app's argmin
    machine between descent rounds (the round boundary is monotone:
    re-assignment can only lower the objective).  ``mode="softmax"``
    anneals a soft assignment from ``temp0`` down to ``temp_min`` and
    hardens at the end; an incumbent under the HARD assignment is tracked
    throughout, so the reported result never regresses past the seed.

    A ``budgets`` schedule traces J*(total budget) by warm-started
    continuation (ascending, validated like ``frontier_codesign``); the
    result's main fields then describe the tightest budget's fleet.  The
    descent runs in float64 on ``device`` (``"cuda"`` by default; it
    raises without a card unless ``device="cpu"``).

    >>> from repro_torch.core import VARIANTS, pack_codesign
    >>> res = pack_codesign("gen:6", VARIANTS, num_machines=2,
    ...                     rounds=2, steps=4, device="cpu")
    >>> len(res.machines), len(res.assignment)
    (2, 6)
    >>> bool(res.objective_final <= res.objective_seed + 1e-12)
    True
    """
    from repro_torch.core.frontier import _validate_budget_schedule
    from repro_torch.core.spec import resolve_spec

    r = resolve_spec(spec, _PACK_DEFAULTS, dict(
        mode=mode, steps=steps, lr=lr, span=span, beta=beta,
        timing_model=timing_model, cost_model=cost_model, w_area=w_area,
        w_power=w_power, area_budget=area_budget, power_budget=power_budget,
        area_envelope=area_envelope, budgets=budgets,
        num_machines=num_machines))
    mode, steps, lr, span, beta = (r["mode"], r["steps"], r["lr"], r["span"],
                                   r["beta"])
    timing_model, cost_model = r["timing_model"], r["cost_model"]
    w_area, w_power = r["w_area"], r["w_power"]
    area_budget, power_budget = r["area_budget"], r["power_budget"]
    envelope = validate_area_envelope(r["area_envelope"])
    budgets, num_machines = r["budgets"], int(r["num_machines"])

    if mode not in PACK_MODES:
        raise ValueError(f"unknown packing mode {mode!r}; have {PACK_MODES}")
    if num_machines < 1:
        raise ValueError(f"num_machines must be >= 1, got {num_machines}")
    for name, b in (("area_budget", area_budget),
                    ("power_budget", power_budget)):
        if b is not None and not b > 0.0:
            raise ValueError(f"{name} must be positive, got {b!r}")
    schedule = (None if budgets is None
                else [float(b) for b in _validate_budget_schedule(budgets)])
    if schedule is not None and area_budget is not None:
        raise ValueError("pass either area_budget (one fleet budget) or "
                         "budgets (a frontier schedule), not both")

    backend = K.get_backend("torch", device)

    pb, seed_mb = _as_batches(profiles, machines)
    if len(seed_mb) == 0:
        raise ValueError("pack_codesign needs at least one seed machine")
    idx = np.arange(num_machines) % len(seed_mb)
    fleet_mb = seed_mb.take(idx)
    fleet_mb = MachineBatch(
        names=[f"pack{i}-{n}" for i, n in enumerate(fleet_mb.names)],
        **{f: getattr(fleet_mb, f) for f in
           ("peak_flops", "hbm_bw", "ici_bw", "ici_links", "inter_pod_bw",
            "scale_compute", "scale_memory", "scale_interconnect")})
    fixed_np = fleet_mb.arrays()
    beta_np = resolve_beta(pb, seed_mb, beta, beta_ref)
    theta0, lo, hi = theta_box(fleet_mb, span)
    n_rates = theta0.shape[1]
    n_apps, n_mach = len(pb), num_machines
    # The fleet-total budget couples every machine, so the whole fleet
    # descends as ONE (1, M*D) row: scalar objective, global acceptance.
    theta0_flat = theta0.reshape(1, -1)
    swept_budget = schedule is not None
    constrained = area_budget is not None or power_budget is not None

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)

    def retract_flat(th_flat, *budget_arg):
        th = th_flat.reshape(n_mach, n_rates)
        # Per-machine box ∩ envelope first (reduces to a clip with no
        # envelope), then the fleet-total shift -- which only lowers
        # rates, preserving the per-machine feasibility just won.
        th, _ = project_to_budgets(
            torch, th, lo_t, hi_t, fixed, cost_model, None, None,
            area_envelope=envelope)
        if budget_arg:
            th = _fleet_shift(th, lo_t, fixed, cost_model, budget_arg[0],
                              power_budget)
        elif constrained:
            th = _fleet_shift(th, lo_t, fixed, cost_model, area_budget,
                              power_budget)
        return th.reshape(1, -1)

    def objective_with(th_flat, weights):
        m = machine_arrays_from_theta(
            torch, th_flat.reshape(n_mach, n_rates), fixed)
        # Summing the per-machine terms folds the assignment-weighted
        # fit (rows of ``weights`` sum to 1/A) and the fleet silicon
        # into one scalar J, shape (1,) for the shared descent.
        terms = _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                 eps, cost_model, w_area, w_power,
                                 app_weights=weights)
        return torch.sum(terms)[None]

    @torch.no_grad()
    def objective_np(th_flat, weights):
        return backend.to_numpy(objective_with(th_flat,
                                               backend.asarray(weights)))

    @torch.no_grad()
    def aggregate_np(th_flat):
        m = machine_arrays_from_theta(
            torch, th_flat.reshape(n_mach, n_rates), fixed)
        out = K.congruence_kernel(torch, p_arrays, m, beta_t, timing_model,
                                  eps, clamp=False)
        return backend.to_numpy(out.aggregate)

    cache: dict = {}
    steps_round = max(1, steps // max(rounds + 1, 1))

    def solve(theta_start, w_start, lr_start, rargs):
        """One full alternation (rounds + polish) at a fixed budget.

        Returns ``(theta, w_hard, f_final, history, lr)`` with the
        incumbent guarantee: ``f_final`` never exceeds the seed J.
        """
        with torch.no_grad():
            theta = retract_flat(theta_start, *rargs)
        w_hard = (_pack_weights(aggregate_np(theta)) if w_start is None
                  else w_start)
        f_seed = objective_np(theta, w_hard)
        history: List[np.ndarray] = [f_seed]
        best_theta, best_f = theta, backend.asarray(f_seed)
        lr_v = lr_start
        temps = np.geomspace(temp0, max(temp_min, 1e-6), max(rounds, 1))
        for ri in range(rounds):
            w_round = (w_hard if mode == "alternate"
                       else _soft_weights(aggregate_np(theta),
                                          float(temps[ri])))
            theta, _, hist, _, lr_v = backtracking_descent(
                theta, objective_with, steps_round, lr_v,
                retract=retract_flat,
                obj_args=(backend.asarray(w_round),),
                retract_args=rargs, cache=cache)
            if mode == "alternate":
                history.extend(hist[1:])
            w_hard = _pack_weights(aggregate_np(theta))
            f_bound = objective_np(theta, w_hard)
            history.append(f_bound)
            better = backend.asarray(f_bound) < best_f
            best_theta = torch.where(better[:, None], theta, best_theta)
            best_f = torch.minimum(backend.asarray(f_bound), best_f)
        # Polish from the incumbent under its hard assignment.
        theta = best_theta
        w_hard = _pack_weights(aggregate_np(theta))
        theta, _, hist, _, lr_v = backtracking_descent(
            theta, objective_with, steps_round, lr_v,
            retract=retract_flat,
            obj_args=(backend.asarray(w_hard),),
            retract_args=rargs, cache=cache)
        history.extend(hist[1:])
        w_hard = _pack_weights(aggregate_np(theta))
        f_final = objective_np(theta, w_hard)
        history.append(f_final)
        return theta, w_hard, f_final, history, lr_v

    if schedule is None:
        rargs = ((float(area_budget),) if area_budget is not None else ())
        theta, w_hard, f_final, history, _ = solve(
            backend.asarray(theta0_flat), None, lr, rargs)
        theta_np = backend.to_numpy(theta)
        obj_seed = float(history[0][0])
        obj_final = float(f_final[0])
        frontier = None
    else:
        # Loosest -> tightest continuation: the budget is an argument of
        # the retraction, so every schedule point reuses one descent.
        solved: Dict[float, dict] = {}
        theta_w, w_w, lr_w = backend.asarray(theta0_flat), None, lr
        obj_seed = None
        for b in sorted(schedule, reverse=True):
            rargs = (float(b),)
            theta_w, w_w, f_b, hist_b, lr_w = solve(
                theta_w, w_w, lr_w, rargs)
            if obj_seed is None:
                obj_seed = float(hist_b[0][0])
            th_b = backend.to_numpy(theta_w)
            m_b = machine_arrays_from_theta(
                np, th_b.reshape(n_mach, n_rates), fixed_np)
            solved[b] = dict(
                theta=th_b, w=w_w, obj=float(f_b[0]), history=hist_b,
                area=float(np.sum(cost_model.area(m_b))),
                feasible=_fleet_feasible(m_b, cost_model, b,
                                         power_budget, envelope))
        # Monotone propagation tightest -> loosest: a fleet feasible
        # at a tighter total budget is feasible at every looser one,
        # so J*(budget) is non-increasing as the budget loosens.
        best = None
        for b in sorted(schedule):
            if (best is not None and best["feasible"]
                    and best["obj"] < solved[b]["obj"]):
                solved[b] = dict(best, feasible=True)
            if solved[b]["feasible"] and (best is None
                                          or not best["feasible"]
                                          or solved[b]["obj"]
                                          <= best["obj"]):
                best = solved[b]
        tightest = min(schedule)
        theta_np = solved[tightest]["theta"]
        obj_final = solved[tightest]["obj"]
        history = solved[tightest]["history"]
        frontier = dict(
            budgets=np.asarray(sorted(schedule)),
            objective=np.asarray([solved[b]["obj"]
                                  for b in sorted(schedule)]),
            area=np.asarray([solved[b]["area"]
                             for b in sorted(schedule)]),
            feasible=np.asarray([solved[b]["feasible"]
                                 for b in sorted(schedule)]))
        area_budget = tightest

    final_m = machine_arrays_from_theta(np, theta_np.reshape(n_mach, n_rates),
                                        fixed_np)
    agg_final = _final_aggregate(pb, final_m, beta_np, timing_model, eps)
    assignment = np.argmin(agg_final, axis=1)
    per_app = agg_final[np.arange(n_apps), assignment]
    area_total = float(np.sum(cost_model.area(final_m)))
    power_total = float(np.sum(cost_model.power(final_m)))
    feasible = (_fleet_feasible(final_m, cost_model, area_budget,
                                power_budget, envelope)
                if (constrained or swept_budget or envelope) else None)
    theta_rows = theta_np.reshape(n_mach, n_rates)
    final_machines = MachineBatch(
        names=list(fleet_mb.names),
        **{f: np.array([params_of_theta(theta_rows[i], fixed_np, i)[f]
                        for i in range(n_mach)])
           for f in OPT_FIELDS},
        ici_links=np.asarray(fixed_np.ici_links, dtype=np.float64),
        scale_compute=np.asarray(fixed_np.scale_compute, dtype=np.float64),
        scale_memory=np.asarray(fixed_np.scale_memory, dtype=np.float64),
        scale_interconnect=np.asarray(fixed_np.scale_interconnect,
                                      dtype=np.float64))

    res = PackingResult(
        app_names=list(pb.names),
        machine_names=list(fleet_mb.names),
        assignment=assignment,
        machines=final_machines,
        seed_params=[params_of_theta(theta0[i], fixed_np, i)
                     for i in range(n_mach)],
        final_params=[params_of_theta(theta_rows[i], fixed_np, i)
                      for i in range(n_mach)],
        objective_seed=obj_seed,
        objective_final=obj_final,
        trajectory=np.concatenate([np.atleast_1d(h) for h in history]),
        per_app_aggregate=per_app,
        area_total=area_total,
        power_total=power_total,
        feasible=feasible,
        mode=mode,
        steps=steps,
        rounds=rounds,
        w_area=w_area,
        w_power=w_power,
        area_budget=(float(area_budget) if area_budget is not None else None),
        power_budget=(float(power_budget)
                      if power_budget is not None else None),
        area_envelope=envelope,
    )
    if frontier is not None:
        res.budgets = frontier["budgets"]
        res.frontier_objective = frontier["objective"]
        res.frontier_area = frontier["area"]
        res.frontier_feasible = frontier["feasible"]
    return res


def _final_aggregate(pb, m: K.MachineArrays, beta_np, timing_model: str,
                     eps: float) -> np.ndarray:
    """(A, M) aggregate matrix at the final fleet (NumPy, reporting path)."""
    out = K.congruence_kernel(np, pb.arrays(), m, beta_np, timing_model, eps,
                              clamp=False)
    return np.asarray(out.aggregate)

"""Constrained + joint gradient co-design under real silicon budgets.

``grad_codesign`` answers "in which direction should the machine move?";
unconstrained, it happily inflates every subsystem until the span clip
stops it.  This module turns the reproduction into a usable co-design tool
by keeping descent inside an area (and optionally power) budget -- the
paper's early-design-exploration pitch under the resource budgets that
heterogeneous-FPGA exploration treats as first-class:

  * **Projected gradient** (``mode="projected"``) -- every candidate step
    is retracted onto ``{CostModel.area(m) <= budget}`` before the
    backtracking acceptance test, so every accepted iterate is feasible.
    The projection works in the SAME log-rate space the descent runs in: a
    uniform log-shift ``theta -> max(theta - t, lo)`` (a multiplicative
    rescale of every rate, floored at the span clip's lower box edge) with
    ``t`` solved by bisection so the active budget binds exactly.  Because
    the operator clips internally and is idempotent, it commutes with the
    span clip (the order-of-operations law held in
    tests/test_torch_constrained.py).
  * **Augmented Lagrangian** (``mode="lagrangian"``) -- descent on
    ``J + (1/2mu) * (relu(lam + mu*(area - budget))^2 - lam^2)`` with dual
    updates between inner descents; iterates may leave the feasible region
    but the recorded violation trace is monotonically damped (an outer
    iterate is only accepted when it does not increase the violation), and
    a final safety projection makes the returned machines feasible to
    1e-9.
  * **Joint (machine, sharding-variant) descent** (``joint_codesign``) --
    each application contributes a GROUP of sharding variants; descent
    optimizes machine log-rates jointly with the per-(app, variant) choice,
    either by alternation (harden the argmin selection, descend, repeat) or
    simultaneously through a temperature-annealed softmax relaxation over
    the group axis.  Both finish with a hard selection.
  * **Integer relaxation for** ``ici_links`` (``optimize_links=True``) --
    a continuous ``log(ici_links)`` column joins theta (floored at one
    link); after descent each variant is rounded BOTH ways, each rounding
    is repaired by re-projecting the rate columns onto the budget with the
    links column held fixed, and the feasible argmin wins -- so
    rounding-with-repair never returns an infeasible link count.
  * **Per-subsystem area envelopes** (``area_envelope={"peak_flops": b1,
    "hbm_bw": b2, ...}``) -- one extra constraint per entry, bounding
    ``CostModel.subsystem_area(m, field) <= b`` (the subsystem's
    provisioned throughput relative to the reference chip).  Envelopes
    compose with the scalar budgets: the Lagrangian mode carries one
    multiplier PER constraint, and both projections honour them (the
    uniform shift through the monotone feasibility test; the Euclidean
    projection by tightening the box, since each envelope caps one
    log-rate column).  A single-key envelope budgets exactly what a
    scalar ``area_budget`` under the single-key ``CostModel`` restriction
    budgets.
  * **True Euclidean projection** (``projection="euclidean"``) -- the
    uniform log-shift retracts every rate by the same factor; the
    per-coordinate weighted Euclidean projection instead solves
    ``min ||theta' - theta||^2 s.t. budget(exp(theta')) <= B`` inside the
    span box, via Newton on each coordinate's KKT stationarity nested in
    a bisection on the constraint multiplier.  Floor-aware, idempotent,
    and it commutes with the span clip exactly like the uniform shift.

All modes reuse the one descent loop and the one differentiable objective
in ``repro_torch.core.codesign`` -- the same ``kernels_xp`` math every
sweep scores with -- and return the same ``CodesignResult`` (with the
feasibility report populated).

The port of the JAX package's constrained module.  The descents run the
math with ``xp=torch`` in float64 on ``device`` (``"cuda"`` unless the
caller passes ``device="cpu"``; without a card they raise).  The
constraint helpers and both projections take the array namespace ``xp``
and run with ``torch`` (the descents) or ``numpy`` (the rounding repair
and the final feasibility checks, on the host).  Every loop the JAX
package rolls into one ``lax.fori_loop`` (``_iterate``: the bisections and
the Newton solves) is a plain Python loop here, one launch per operation
on the card.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kernels_xp as K
from repro_torch.core.codesign import (
    OPT_FIELDS,
    CodesignResult,
    _as_batches,
    _objective_terms,
    backtracking_descent,
    machine_arrays_from_theta,
    params_of_theta,
    resolve_beta,
    theta_box,
)
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, RATE_FIELDS, CostModel

#: Relative slack the feasibility report allows: ``area <= budget*(1+TOL)``.
FEASIBLE_RTOL = 1e-9

#: Bisection iterations for the budget projection.  Each halves the shift
#: interval; 64 puts the boundary within f64 resolution of the exact root.
PROJECT_ITERS = 64

#: Inner Newton iterations for the Euclidean projection's per-coordinate
#: KKT stationarity solve (quadratically convergent from the seed point).
NEWTON_ITERS = 30

#: Multiplier-bracketing growth steps for the Euclidean projection:
#: 1e-6 * 8**25 > 1e16 covers every representable active constraint.
BRACKET_ITERS = 25


# --------------------------------------------------------------------------- #
# Constraint-set helpers (scalar budgets + per-subsystem envelopes)
# --------------------------------------------------------------------------- #


def validate_area_envelope(
        envelope: Optional[Mapping[str, float]]) -> Optional[Dict[str, float]]:
    """Normalize an ``area_envelope`` mapping (None/empty -> None).

    Keys must name cost-model rate fields, values must be positive; the
    returned dict is a plain copy so callers can stash it in results.

    >>> validate_area_envelope({"peak_flops": 1.5})
    {'peak_flops': 1.5}
    >>> validate_area_envelope({}) is None
    True
    >>> validate_area_envelope({"mxu_count": 1.0})
    Traceback (most recent call last):
        ...
    ValueError: unknown area_envelope field 'mxu_count'; have ('peak_flops', 'hbm_bw', 'ici_bw_total', 'inter_pod_bw')
    """
    if not envelope:
        return None
    out: Dict[str, float] = {}
    for field, b in envelope.items():
        if field not in RATE_FIELDS:
            raise ValueError(f"unknown area_envelope field {field!r}; "
                             f"have {RATE_FIELDS}")
        b = float(b)
        if not b > 0.0:
            raise ValueError(
                f"area_envelope[{field!r}] must be positive, got {b!r}")
        out[field] = b
    return out


def budget_feasible(xp, m: K.MachineArrays, cost_model: CostModel,
                    area_budget: Optional[float],
                    power_budget: Optional[float], rtol: float = FEASIBLE_RTOL,
                    area_envelope: Optional[Mapping[str, float]] = None):
    """Per-variant bool: every active constraint satisfied to relative
    ``rtol`` (scalar area/power budgets plus per-subsystem envelopes)."""
    ok = xp.ones_like(m.peak_flops, dtype=bool)
    if area_budget is not None:
        ok = ok & (cost_model.area(m) <= area_budget * (1.0 + rtol))
    if power_budget is not None:
        ok = ok & (cost_model.power(m) <= power_budget * (1.0 + rtol))
    if area_envelope:
        for field in sorted(area_envelope):
            ok = ok & (cost_model.subsystem_area(m, field)
                       <= area_envelope[field] * (1.0 + rtol))
    return ok


def budget_violations_vector(xp, m: K.MachineArrays, cost_model: CostModel,
                             area_budget: Optional[float],
                             power_budget: Optional[float],
                             area_envelope: Optional[Mapping[str, float]]
                             = None):
    """``(V, C)`` relative violation per active constraint, relu'd.

    Constraint order is static per configuration: scalar area, scalar
    power, then envelope fields sorted by name -- the augmented-Lagrangian
    mode keys one multiplier per column.
    """
    cols = []
    if area_budget is not None:
        cols.append(cost_model.area(m) / area_budget - 1.0)
    if power_budget is not None:
        cols.append(cost_model.power(m) / power_budget - 1.0)
    if area_envelope:
        for field in sorted(area_envelope):
            cols.append(cost_model.subsystem_area(m, field)
                        / area_envelope[field] - 1.0)
    if not cols:
        return xp.zeros_like(m.peak_flops)[:, None]
    return xp.clip(xp.stack(cols, axis=1), 0.0, None)


def constraint_labels(area_budget, power_budget,
                      area_envelope: Optional[Mapping[str, float]] = None
                      ) -> List[str]:
    """Constraint-column names in ``budget_violations_vector`` order
    (scalar area, scalar power, then envelope fields sorted by name) --
    the key of the augmented-Lagrangian multipliers.

    >>> constraint_labels(1.0, None, {"hbm_bw": 0.5, "peak_flops": 2.0})
    ['area', 'hbm_bw', 'peak_flops']
    """
    labels = []
    if area_budget is not None:
        labels.append("area")
    if power_budget is not None:
        labels.append("power")
    if area_envelope:
        labels.extend(sorted(area_envelope))
    return labels


def budget_violation(xp, m: K.MachineArrays, cost_model: CostModel,
                     area_budget: Optional[float],
                     power_budget: Optional[float],
                     area_envelope: Optional[Mapping[str, float]] = None):
    """Worst relative constraint violation per variant (0 = feasible)."""
    return xp.amax(budget_violations_vector(
        xp, m, cost_model, area_budget, power_budget, area_envelope), axis=1)


def _iterate(body, init, iters: int):
    """Run ``body(i, state) -> state`` ``iters`` times, a plain Python loop
    (the JAX package rolls it into one ``lax.fori_loop``; here each
    operation of each pass is its own launch on the card)."""
    state = init
    for i in range(iters):
        state = body(i, state)
    return state


def project_to_budgets(
    xp,
    theta,
    lo,
    hi,
    fixed: K.MachineArrays,
    cost_model: CostModel,
    area_budget: Optional[float],
    power_budget: Optional[float] = None,
    mask=None,
    iters: int = PROJECT_ITERS,
    area_envelope: Optional[Mapping[str, float]] = None,
    method: str = "shift",
):
    """Retract ``theta`` onto (span-clip box) ∩ (constraint set), per variant.

    The constraint set intersects the scalar ``area_budget``/
    ``power_budget`` sublevel sets with one per-subsystem cap per
    ``area_envelope`` entry.  Two retraction operators are available:

      * ``method="shift"`` (default) -- ``theta -> max(clip(theta) - t*,
        lo)``: a uniform downward log-shift of the (masked) columns, i.e.
        a multiplicative rescale of the corresponding rates, floored at
        the box's lower edge, with the smallest ``t* >= 0`` that satisfies
        every active constraint, found by bisection (every constraint
        quantity is strictly increasing in every rate, so feasibility is
        monotone in ``t``).
      * ``method="euclidean"`` -- the true per-coordinate weighted
        Euclidean projection in log-rate space (see
        ``_project_euclidean``): the closest feasible point rather than a
        uniform rescale, so a budget binding on one subsystem no longer
        drags the others down with it.

    Properties shared by both operators (pinned in
    tests/test_torch_constrained.py):
      * the result is always inside the clip box;
      * when a feasible point exists under the floor, the result satisfies
        every constraint (to f64 bisection resolution, well within
        ``FEASIBLE_RTOL``);
      * idempotent, and absorbs the span clip on either side -- i.e. the
        clip and the projection commute through this combined operator.

    ``mask`` (shape ``(D,)`` bool) restricts the shift to a column subset
    (the rounding repair shifts rates while holding the rounded
    ``ici_links`` column fixed).  Returns ``(theta_projected, feasible)``;
    ``feasible`` is False only when even the floor violates a constraint
    (the floor point is still returned as the best effort).
    """
    th = xp.clip(theta, lo, hi)
    if area_budget is None and power_budget is None and not area_envelope:
        return th, xp.ones_like(th[:, 0], dtype=bool)
    if method == "euclidean":
        return _project_euclidean(xp, th, lo, hi, fixed, cost_model,
                                  area_budget, power_budget, area_envelope,
                                  mask, iters)
    if method != "shift":
        raise ValueError(f"unknown projection method {method!r}; "
                         "have ('shift', 'euclidean')")
    if mask is None:
        shift_mask = xp.ones_like(th[0])
    else:
        shift_mask = _asarray_like(mask, th)

    def at_shift(t):
        return xp.where(shift_mask[None, :] > 0,
                        xp.maximum(th - t[:, None], lo), th)

    def feasible_at(t):
        m = machine_arrays_from_theta(xp, at_shift(t), fixed)
        # Feasibility at rtol=0: the bisection lands strictly inside the
        # budget, leaving the report's FEASIBLE_RTOL as pure slack.
        return budget_feasible(xp, m, cost_model, area_budget, power_budget,
                               rtol=0.0, area_envelope=area_envelope)

    zero = xp.zeros_like(th[:, 0])
    ok0 = feasible_at(zero)
    # Largest useful shift: every masked column at its floor.
    t_floor = xp.amax(xp.where(shift_mask[None, :] > 0, th - lo,
                               xp.zeros_like(th)), axis=1)
    ok_floor = feasible_at(t_floor)

    def bisect_step(_, bracket):
        t_lo, t_hi = bracket
        mid = 0.5 * (t_lo + t_hi)
        okm = feasible_at(mid)
        return (xp.where(okm, t_lo, mid), xp.where(okm, mid, t_hi))

    t_lo, t_hi = _iterate(bisect_step, (zero, t_floor), iters)
    # Return the feasible endpoint of the bracket; untouched where already
    # feasible (exact idempotence), floor where nothing is feasible.
    t_star = xp.where(ok0, zero, t_hi)
    return at_shift(t_star), ok0 | ok_floor


# --------------------------------------------------------------------------- #
# The Euclidean projection (per-coordinate KKT solve, log-rate space)
# --------------------------------------------------------------------------- #


def _area_posynomial(xp, cost_model: CostModel, fixed: K.MachineArrays):
    """``CostModel.area`` over 4-column theta as ``(coeff, expo, offset)``:
    ``area = sum_j coeff[:, j] * exp(expo[j] * theta[:, j])``.

    ``ici_links`` is fixed here (the Euclidean path rejects the links
    relaxation), so it folds into the ``ici_bw`` column's coefficient.
    """
    ref, w = cost_model.reference, cost_model.area_weights
    tw = sum(w.get(f, 0.0) for f in RATE_FIELDS)
    ones = xp.ones_like(fixed.ici_links)
    coeff = xp.stack([
        w.get("peak_flops", 0.0) / tw / ref.peak_flops * ones,
        w.get("hbm_bw", 0.0) / tw / ref.hbm_bw * ones,
        w.get("ici_bw_total", 0.0) / tw / ref.ici_bw_total * fixed.ici_links,
        w.get("inter_pod_bw", 0.0) / tw / ref.inter_pod_bw * ones,
    ], axis=1)
    return coeff, _asarray_like([1.0, 1.0, 1.0, 1.0], coeff), 0.0


def _power_posynomial(xp, cost_model: CostModel, fixed: K.MachineArrays):
    """``CostModel.power`` over 4-column theta, same ``(coeff, expo,
    offset)`` shape; exponents carry the DVFS superlinearity and the
    static term becomes a constant offset against the budget."""
    ref, w = cost_model.reference, cost_model.power_weights
    e = {f: cost_model.power_exponents.get(f, 1.0) for f in RATE_FIELDS}
    tw = sum(w.get(f, 0.0) for f in RATE_FIELDS)
    ones = xp.ones_like(fixed.ici_links)
    coeff = xp.stack([
        w.get("peak_flops", 0.0) / tw
        / ref.peak_flops ** e["peak_flops"] * ones,
        w.get("hbm_bw", 0.0) / tw / ref.hbm_bw ** e["hbm_bw"] * ones,
        w.get("ici_bw_total", 0.0) / tw
        * (fixed.ici_links / ref.ici_bw_total) ** e["ici_bw_total"],
        w.get("inter_pod_bw", 0.0) / tw
        / ref.inter_pod_bw ** e["inter_pod_bw"] * ones,
    ], axis=1)
    expo = _asarray_like([e["peak_flops"], e["hbm_bw"], e["ici_bw_total"],
                          e["inter_pod_bw"]], coeff)
    return coeff, expo, cost_model.static_power


def _project_posynomial(xp, th, lo, hi, coeff, expo, budget, iters):
    """Exact Euclidean projection of each theta row onto
    ``{t in [lo, hi] : sum_j coeff_j * exp(expo_j * t_j) <= budget}``.

    KKT with multiplier ``nu >= 0``: each coordinate solves the
    stationarity ``t - x + nu * coeff * expo * exp(expo * t) = 0``
    (convex, solved by Newton from ``t0 = x`` where the residual is
    positive, so iterates descend monotonically onto the root), clipped
    to the box -- the clipped solve IS the box-constrained coordinate
    minimizer because objective and constraint are separable.  The
    constraint value is strictly decreasing in ``nu``, so the active
    multiplier is bracketed by geometric growth and pinned by bisection.
    Zero-coefficient columns (cost-model weight 0, masked columns) have
    zero stationarity correction and pass through untouched.
    """
    def g_of(t):
        return xp.sum(coeff * xp.exp(expo[None, :] * t), axis=1)

    def t_of(nu):
        k = nu[:, None] * coeff * expo[None, :]

        def newton(_, t):
            ex = xp.exp(expo[None, :] * t)
            return t - (t - th + k * ex) / (1.0 + k * expo[None, :] * ex)

        return xp.clip(_iterate(newton, th, NEWTON_ITERS), lo, hi)

    ok0 = g_of(th) <= budget

    def grow(_, nu):
        return xp.where(g_of(t_of(nu)) <= budget, nu, nu * 8.0)

    nu_hi = _iterate(grow, 1e-6 * xp.ones_like(th[:, 0]), BRACKET_ITERS)

    def bisect(_, bracket):
        nu_lo, nu_up = bracket
        mid = 0.5 * (nu_lo + nu_up)
        okm = g_of(t_of(mid)) <= budget
        return (xp.where(okm, nu_lo, mid), xp.where(okm, mid, nu_up))

    _, nu_star = _iterate(
        bisect, (xp.zeros_like(nu_hi), nu_hi), iters)
    # Feasible bracket endpoint; bit-exact pass-through when already
    # feasible (idempotence).
    return xp.where(ok0[:, None], th, t_of(nu_star))


def _project_euclidean(xp, th, lo, hi, fixed, cost_model, area_budget,
                       power_budget, area_envelope, mask, iters):
    """Euclidean retraction onto box ∩ envelopes ∩ scalar budgets.

    Envelope caps are exact per-coordinate upper bounds in log space, so
    they tighten the box; each scalar budget then projects exactly via
    ``_project_posynomial``.  With BOTH scalar budgets active the two
    exact projections alternate (projections-onto-convex-sets); a final
    uniform-shift pass guarantees the feasibility contract wherever the
    alternation has not yet converged to 1e-9.
    """
    if th.shape[1] != len(OPT_FIELDS) or mask is not None:
        raise ValueError(
            "projection='euclidean' supports the 4 rate columns with no "
            "column mask; use the default 'shift' projection with the "
            "ici_links relaxation / rounding repair")
    hi_eff = hi
    if area_envelope:
        ref = cost_model.reference
        caps = {
            "peak_flops": lambda b: xp.log(
                xp.full_like(th[:, 0], b * ref.peak_flops)),
            "hbm_bw": lambda b: xp.log(xp.full_like(th[:, 0], b * ref.hbm_bw)),
            "ici_bw_total": lambda b: xp.log(
                b * ref.ici_bw_total / fixed.ici_links),
            "inter_pod_bw": lambda b: xp.log(
                xp.full_like(th[:, 0], b * ref.inter_pod_bw)),
        }
        col = {f: j for j, f in
               enumerate(("peak_flops", "hbm_bw", "ici_bw_total",
                          "inter_pod_bw"))}
        cap_mat = xp.full_like(th, xp.inf)
        for field in sorted(area_envelope):
            j = col[field]
            cap_col = caps[field](area_envelope[field])
            cap_mat = _set_column(xp, cap_mat, j,
                                  xp.minimum(cap_mat[:, j], cap_col))
        # A cap below the box floor leaves no feasible point; pin the
        # column at the floor and let the feasibility flag report it.
        hi_eff = xp.maximum(xp.minimum(hi, cap_mat), lo)
    out = xp.clip(th, lo, hi_eff)

    constraints = []
    if area_budget is not None:
        coeff, expo, off = _area_posynomial(xp, cost_model, fixed)
        constraints.append((coeff, expo, area_budget - off))
    if power_budget is not None:
        coeff, expo, off = _power_posynomial(xp, cost_model, fixed)
        constraints.append((coeff, expo, power_budget - off))

    cycles = 1 if len(constraints) <= 1 else 6
    for _ in range(cycles):
        for coeff, expo, b in constraints:
            out = _project_posynomial(xp, out, lo, hi_eff, coeff, expo, b,
                                      iters)

    def feasible(t):
        m = machine_arrays_from_theta(xp, t, fixed)
        return budget_feasible(xp, m, cost_model, area_budget, power_budget,
                               rtol=0.0, area_envelope=area_envelope)

    ok = feasible(out)
    if len(constraints) > 1:
        # POCS converges to the intersection only in the limit; the shift
        # operator is the guaranteed-feasible fallback for the (rare)
        # variants still outside after the alternation cycles.
        fallback, _ = project_to_budgets(
            xp, out, lo, hi_eff, fixed, cost_model, area_budget,
            power_budget, iters=iters, area_envelope=area_envelope,
            method="shift")
        out = xp.where(ok[:, None], out, fallback)
        ok = feasible(out)
    ok_floor = feasible(xp.clip(lo, lo, hi_eff))
    return out, ok | ok_floor


def _set_column(xp, a, j: int, col):
    """Functional column assignment (NumPy or torch; the input is kept)."""
    a = a.clone() if isinstance(a, torch.Tensor) else a.copy()
    a[:, j] = col
    return a


def _asarray_like(values, like):
    """``values`` as an array of ``like``'s dtype (and, for a tensor, on
    its device)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(values), dtype=like.dtype,
                               device=like.device)
    return np.asarray(values).astype(like.dtype)


# --------------------------------------------------------------------------- #
# Constrained descent: projected gradient + augmented Lagrangian
# --------------------------------------------------------------------------- #


def _validate_budgets(area_budget, power_budget, area_envelope=None):
    if (area_budget is None and power_budget is None
            and not area_envelope):
        raise ValueError(
            "constrained_codesign needs area_budget, power_budget and/or "
            "area_envelope (use grad_codesign for unconstrained descent)")
    for name, b in (("area_budget", area_budget),
                    ("power_budget", power_budget)):
        if b is not None and not b > 0.0:
            raise ValueError(f"{name} must be positive, got {b!r}")
    return validate_area_envelope(area_envelope)


def _finalize(mb, fixed_np, theta0, theta_np, history, steps, w_area, w_power,
              cost_model, mode, suffix, area_budget, power_budget,
              violation_trace, feasible, objective_final,
              selection_names=None, area_envelope=None, multipliers=None,
              constraint_names=None) -> CodesignResult:
    final_m = machine_arrays_from_theta(np, theta_np, fixed_np)
    return CodesignResult(
        names=list(mb.names),
        objective_seed=np.asarray(history[0]),
        objective_final=np.asarray(objective_final),
        seed_params=[params_of_theta(theta0[i], fixed_np, i)
                     for i in range(len(mb))],
        final_params=[params_of_theta(theta_np[i], fixed_np, i)
                      for i in range(len(mb))],
        trajectory=np.stack(history, axis=0),
        steps=steps,
        w_area=w_area,
        w_power=w_power,
        mode=mode,
        suffix=suffix,
        area_budget=area_budget,
        power_budget=power_budget,
        area_envelope=area_envelope,
        area_final=np.asarray(cost_model.area(final_m)),
        power_final=np.asarray(cost_model.power(final_m)),
        feasible=np.asarray(feasible, dtype=bool),
        violation_trace=(np.stack(violation_trace, axis=0)
                         if violation_trace is not None else None),
        selection_names=selection_names,
        multipliers=multipliers,
        constraint_names=constraint_names,
    )


def _round_links_with_repair(theta_np, lo, hi, fixed_np, cost_model,
                             area_budget, power_budget, obj_np,
                             area_envelope=None):
    """Round the continuous ``log(ici_links)`` column both ways, re-project
    the rate columns onto the budget for each rounding, keep the feasible
    argmin (NumPy post-pass; returns the repaired theta and feasibility)."""
    links_col = len(OPT_FIELDS)
    rate_mask = np.array([True] * len(OPT_FIELDS) + [False])
    links_cont = np.exp(theta_np[:, links_col])
    # The span box bounds the CONTINUOUS relaxation; a rounded count must
    # land on an integer inside it, so clamp to the integer sub-range
    # [ceil(lo), floor(hi)] (floored at one link) -- clipping an integer
    # to a fractional box edge would smuggle a non-integer count into the
    # returned models.
    lo_links = np.maximum(np.ceil(np.exp(lo[:, links_col]) - 1e-9), 1.0)
    hi_links = np.maximum(np.floor(np.exp(hi[:, links_col]) + 1e-9),
                          lo_links)
    best_theta = theta_np.copy()
    best_obj = np.full(theta_np.shape[0], np.inf)
    best_feas = np.zeros(theta_np.shape[0], dtype=bool)
    for rounder in (np.floor, np.ceil):
        links = np.clip(rounder(links_cont), lo_links, hi_links)
        cand = theta_np.copy()
        cand[:, links_col] = np.log(links)
        # Repair: rounding up raises area; shift the RATES back under the
        # budget while holding the now-integral links column fixed.
        # The 5-column theta carries the rounded links in its last column,
        # so every constraint (the ici_bw_total envelope included) is
        # re-checked against the INTEGER link count during the repair.
        cand, feas = project_to_budgets(
            np, cand, lo, hi, fixed_np, cost_model, area_budget,
            power_budget, mask=rate_mask, area_envelope=area_envelope)
        # Rounding must not break integrality: the projection's mask keeps
        # the links column fixed, so re-read it as the exact integer.
        obj = obj_np(cand)
        # Feasible candidates always beat infeasible ones; ties on
        # feasibility resolve by objective.
        better = (feas & ~best_feas) | (
            (feas == best_feas) & (obj < best_obj))
        best_theta = np.where(better[:, None], cand, best_theta)
        best_obj = np.where(better, obj, best_obj)
        best_feas = best_feas | feas
    return best_theta, best_feas, best_obj


#: Historical defaults, resolved through ``repro_torch.core.spec.resolve_spec``
#: so keyword-only calls are unchanged while ``spec=`` requests fill unset
#: parameters (explicit kwarg > spec field > this table).
_CONSTRAINED_DEFAULTS = dict(
    area_budget=None, power_budget=None, area_envelope=None,
    mode="projected", projection="shift", steps=100, lr=0.1, span=16.0,
    beta=None, timing_model="serial", cost_model=DEFAULT_COST_MODEL,
    w_area=0.1, w_power=0.05, optimize_links=False,
)


def constrained_codesign(
    profiles,
    machines,
    *,
    area_budget: Optional[float] = None,
    power_budget: Optional[float] = None,
    area_envelope: Optional[Mapping[str, float]] = None,
    mode: Optional[str] = None,
    projection: Optional[str] = None,
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
    optimize_links: Optional[bool] = None,
    outer_iters: int = 6,
    mu0: float = 10.0,
    mu_growth: float = 4.0,
    spec=None,
    device=K.DEFAULT_DEVICE,
) -> CodesignResult:
    """Budgeted ``grad_codesign``: descend J subject to silicon budgets.

    The constraint set is any mix of a scalar ``area_budget``, a scalar
    ``power_budget`` and per-subsystem ``area_envelope`` caps
    (``{"peak_flops": b1, "hbm_bw": b2, ...}``, each bounding
    ``CostModel.subsystem_area``).  ``mode="projected"`` retracts every
    candidate onto the constraint set (see ``project_to_budgets``;
    ``projection="euclidean"`` swaps the uniform log-shift for the true
    per-coordinate Euclidean projection), so the whole trajectory is
    feasible and the violation trace is identically zero.
    ``mode="lagrangian"`` runs ``outer_iters`` rounds of inner descent on
    the augmented objective -- one multiplier PER constraint -- with
    dual/penalty updates in between (``steps`` is split across the
    rounds); iterates may be infeasible mid-run, but the recorded
    per-round violation trace is monotonically damped and a final
    projection makes the returned machines feasible.  ``optimize_links``
    relaxes ``ici_links`` continuously and finishes with
    rounding-with-repair (shift projection only -- the Euclidean path has
    no links column).

    A ``spec=CodesignSpec(...)`` request fills any parameter left unset;
    an explicitly-passed keyword always wins over the spec's field.  The
    descent runs in float64 on ``device`` (``"cuda"`` by default; it
    raises without a card unless ``device="cpu"``).

    Example (tight budget: the optimum must stay at reference-chip area):

    >>> from repro_torch.core import VARIANTS, WorkloadProfile, constrained_codesign
    >>> from repro_torch.core.sweep import MachineBatch
    >>> apps = [WorkloadProfile(name="app0", flops=2e14, hbm_bytes=1.5e11,
    ...                         collective_bytes={"all-reduce": 2e10},
    ...                         num_devices=256, model_flops=5e16)]
    >>> cd = constrained_codesign(apps, MachineBatch.from_models(VARIANTS),
    ...                           area_budget=1.0, steps=5, device="cpu")
    >>> cd.mode
    'projected'
    >>> bool((cd.area_final <= 1.0 + 1e-9).all())
    True
    >>> bool(cd.feasible.all())
    True

    A per-subsystem envelope is one more constraint per entry -- here no
    machine may provision more than 80% of the reference HBM bandwidth:

    >>> from repro_torch.core.costmodel import DEFAULT_COST_MODEL
    >>> env = constrained_codesign(apps, MachineBatch.from_models(VARIANTS),
    ...                            area_envelope={"hbm_bw": 0.8}, steps=5,
    ...                            projection="euclidean", device="cpu")
    >>> [bool(DEFAULT_COST_MODEL.subsystem_area(m, "hbm_bw")
    ...       <= 0.8 * (1 + 1e-9)) for m in env.models()]
    [True, True, True]
    >>> env.feasibility_report()["area_envelope"]
    {'hbm_bw': 0.8}
    """
    from repro_torch.core.spec import resolve_spec

    r = resolve_spec(spec, _CONSTRAINED_DEFAULTS, dict(
        area_budget=area_budget, power_budget=power_budget,
        area_envelope=area_envelope, mode=mode, projection=projection,
        steps=steps, lr=lr, span=span, beta=beta, timing_model=timing_model,
        cost_model=cost_model, w_area=w_area, w_power=w_power,
        optimize_links=optimize_links))
    area_budget, power_budget = r["area_budget"], r["power_budget"]
    area_envelope, mode, projection = (r["area_envelope"], r["mode"],
                                       r["projection"])
    steps, lr, span, beta = r["steps"], r["lr"], r["span"], r["beta"]
    timing_model, cost_model = r["timing_model"], r["cost_model"]
    w_area, w_power = r["w_area"], r["w_power"]
    optimize_links = r["optimize_links"]

    area_envelope = _validate_budgets(area_budget, power_budget,
                                      area_envelope)
    if mode not in ("projected", "lagrangian"):
        raise ValueError(f"unknown constraint mode {mode!r}; "
                         "have ('projected', 'lagrangian')")
    if projection not in ("shift", "euclidean"):
        raise ValueError(f"unknown projection {projection!r}; "
                         "have ('shift', 'euclidean')")
    if projection == "euclidean" and optimize_links:
        raise ValueError(
            "projection='euclidean' does not compose with optimize_links "
            "(the links column needs the masked shift repair); use the "
            "default projection='shift'")
    backend = K.get_backend("torch", device)

    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    theta0, lo, hi = theta_box(mb, span, optimize_links=optimize_links)
    suffix = {"projected": "+proj", "lagrangian": "+lagr"}[mode]

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)

    def objective(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power)

    def violation(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return budget_violation(torch, m, cost_model, area_budget,
                                power_budget, area_envelope)

    def violations_vec(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return budget_violations_vector(torch, m, cost_model, area_budget,
                                        power_budget, area_envelope)

    def project(theta):
        out, _ = project_to_budgets(torch, theta, lo_t, hi_t, fixed,
                                    cost_model, area_budget, power_budget,
                                    area_envelope=area_envelope,
                                    method=projection)
        return out

    multipliers = constraint_names = None
    if mode == "projected":
        theta, f_cur, history, vtrace, _ = backtracking_descent(
            backend.asarray(theta0), objective, steps, lr,
            retract=project, aux_fn=violation)
    else:
        theta, history, vtrace, lam_rel = _lagrangian_descent(
            backend, theta0, lo_t, hi_t, objective, violation,
            violations_vec, steps, lr, outer_iters, mu0, mu_growth)
        # The dual iterates multiply RELATIVE violations
        # (value / budget - 1); report them as ABSOLUTE shadow prices
        # (lam_abs = lam_rel / budget), the sensitivities
        # d J*/d budget = -lambda.
        labels = constraint_labels(area_budget, power_budget,
                                   area_envelope)
        scale = np.array(
            [area_budget if c == "area" else
             power_budget if c == "power" else area_envelope[c]
             for c in labels])
        multipliers = np.asarray(lam_rel) / scale[None, :]
        constraint_names = tuple(labels)
        # Safety net: the dual iterates approach feasibility from
        # outside; project the final design so the returned machines
        # honour the budget to FEASIBLE_RTOL exactly like projected
        # mode does.
        with torch.no_grad():
            theta = project(theta)
            vtrace.append(backend.to_numpy(violation(theta)))
            history.append(backend.to_numpy(objective(theta)))

    theta_np = backend.to_numpy(theta)
    f_final = np.asarray(history[-1])

    feasible = budget_feasible(
        np, machine_arrays_from_theta(np, theta_np, fixed_np), cost_model,
        area_budget, power_budget, area_envelope=area_envelope)

    if optimize_links:
        def obj_np(th):
            m = machine_arrays_from_theta(np, th, fixed_np)
            with np.errstate(divide="ignore", invalid="ignore"):
                return _objective_terms(np, pb.arrays(), m, beta_np,
                                        timing_model, eps, cost_model,
                                        w_area, w_power)
        theta_np, feasible, f_final = _round_links_with_repair(
            theta_np, lo, hi, fixed_np, cost_model, area_budget,
            power_budget, obj_np, area_envelope=area_envelope)
        history.append(np.asarray(f_final))
        vtrace.append(np.asarray(budget_violation(
            np, machine_arrays_from_theta(np, theta_np, fixed_np),
            cost_model, area_budget, power_budget, area_envelope)))

    return _finalize(mb, fixed_np, theta0, theta_np, history, steps, w_area,
                     w_power, cost_model, mode, suffix, area_budget,
                     power_budget, vtrace, feasible, f_final,
                     area_envelope=area_envelope, multipliers=multipliers,
                     constraint_names=constraint_names)


def _lagrangian_descent(backend, theta0, lo_t, hi_t, objective, violation,
                        violations_vec, steps, lr, outer_iters, mu0,
                        mu_growth):
    """Augmented-Lagrangian outer loop (inner loops share the one descent).

    One multiplier PER constraint (``violations_vec`` columns: scalar
    area, scalar power, then each envelope field), so a binding HBM
    envelope grows its own dual weight without inflating the pressure on
    an easily-satisfied total-area budget.  The violation trace (the max
    over constraints) is damped BY CONSTRUCTION: an outer iterate is
    accepted per variant only when its worst violation does not exceed the
    best seen so far; rejected variants keep their previous theta and get
    a sharply increased penalty weight (``mu_growth`` squared) for the
    next round.
    """
    v = theta0.shape[0]
    steps_inner = max(1, steps // max(outer_iters, 1))
    with torch.no_grad():
        theta = torch.clamp(backend.asarray(theta0), lo_t, hi_t)
        n_constraints = int(violations_vec(theta).shape[1])
        lam = theta.new_zeros((v, n_constraints))
        mu = theta.new_full((v,), float(mu0))
        v_best = violation(theta)
        history = [backend.to_numpy(objective(theta))]
    lr_v = lr
    vtrace = [backend.to_numpy(v_best)]

    # Multipliers enter as arguments (not fresh closures), and the
    # descent's cache is shared across outer rounds.
    def augmented(th, lam_c, mu_c):
        g = violations_vec(th)  # (V, C) relative violations, already relu'd
        pen = 0.5 / mu_c * torch.sum(
            torch.clamp(lam_c + mu_c[:, None] * g, min=0.0) ** 2
            - lam_c ** 2, dim=1)
        return objective(th) + pen

    cache = {}
    for _ in range(outer_iters):
        cand, _, _, _, lr_v = backtracking_descent(
            theta, augmented, steps_inner, lr_v,
            retract=lambda th: torch.clamp(th, lo_t, hi_t),
            obj_args=(lam, mu), cache=cache)
        with torch.no_grad():
            v_new = violation(cand)
            ok = v_new <= v_best + 1e-12
            theta = torch.where(ok[:, None], cand, theta)
            v_best = torch.minimum(v_new, v_best)
            lam = torch.clamp(lam + mu[:, None] * violations_vec(theta),
                              min=0.0)
            mu = torch.where(ok, mu * mu_growth, mu * (mu_growth ** 2))
            history.append(backend.to_numpy(objective(theta)))
        vtrace.append(backend.to_numpy(v_best))
    return theta, history, vtrace, backend.to_numpy(lam)


# --------------------------------------------------------------------------- #
# Joint (machine, sharding-variant) descent
# --------------------------------------------------------------------------- #


def _flatten_groups(profile_groups) -> Tuple[list, np.ndarray, list]:
    """Flatten app groups; returns (flat profiles, group ids, group names)."""
    from repro_torch.core.costs import WorkloadProfile

    groups = list(profile_groups)
    if groups and isinstance(groups[0], WorkloadProfile):
        groups = [[p] for p in groups]  # flat list -> singleton groups
    flat, gids = [], []
    for g, members in enumerate(groups):
        members = list(members)
        if not members:
            raise ValueError(f"profile group {g} is empty")
        flat.extend(members)
        gids.extend([g] * len(members))
    return flat, np.asarray(gids, dtype=np.int64), groups


def _hard_weights(agg: np.ndarray, gids: np.ndarray) -> np.ndarray:
    """(A, V) one-hot-per-group selection weights from an aggregate matrix:
    each (group, variant) pair puts weight 1/G on its argmin member."""
    a, v = agg.shape
    n_groups = int(gids.max()) + 1
    w = np.zeros((a, v))
    for g in range(n_groups):
        rows = np.nonzero(gids == g)[0]
        best = rows[np.argmin(agg[rows, :], axis=0)]          # (V,)
        w[best, np.arange(v)] += 1.0 / n_groups
    return w


_JOINT_DEFAULTS = dict(
    mode="alternate", steps=80, lr=0.1, span=16.0, beta=None,
    timing_model="serial", cost_model=DEFAULT_COST_MODEL,
    w_area=0.1, w_power=0.05, area_budget=None, power_budget=None,
)


def joint_codesign(
    profile_groups,
    machines,
    *,
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
    temp0: float = 1.0,
    temp_min: float = 0.05,
    spec=None,
    device=K.DEFAULT_DEVICE,
) -> CodesignResult:
    """Joint (machine, sharding-variant) descent through the same math.

    ``profile_groups`` is a sequence of groups, each a sequence of
    ``WorkloadProfile`` sharding variants of ONE application (a flat list
    of profiles degrades to singleton groups == machine-only descent).
    The objective is the scalarized J with the mean over apps replaced by
    a per-(group, machine-variant) selection over group members:

      * ``mode="alternate"`` -- harden the selection to the per-group
        argmin under the current machine, descend machine log-rates for
        ``steps/rounds`` steps, re-select, repeat.  Re-selection can only
        lower the objective, so the round boundary is monotone.
      * ``mode="softmax"`` -- relax the selection to a per-group softmax
        with learnable logits, descend (log-rates, logits) SIMULTANEOUSLY,
        annealing the temperature geometrically from ``temp0`` to
        ``temp_min`` across rounds.

    Both modes finish with a hard selection plus one machine-only polish
    round under it, and report the chosen member per (machine variant,
    group) in ``selection_names``.  Budgets (optional) apply through the
    projected retraction, exactly as in ``constrained_codesign``.  The
    descent runs in float64 on ``device`` (``"cuda"`` by default).

    Example (two sharding variants of one app; descent picks per machine):

    >>> from repro_torch.core import VARIANTS, WorkloadProfile, joint_codesign
    >>> from repro_torch.core.sweep import MachineBatch
    >>> base = dict(flops=2e14, hbm_bytes=1.5e11, num_devices=256,
    ...             model_flops=5e16)
    >>> groups = [[WorkloadProfile(name="app0/tp",
    ...                            collective_bytes={"all-reduce": 8e10},
    ...                            **base),
    ...            WorkloadProfile(name="app0/fsdp",
    ...                            collective_bytes={"all-reduce": 1e10},
    ...                            **base)]]
    >>> cd = joint_codesign(groups, MachineBatch.from_models(VARIANTS),
    ...                     rounds=2, steps=6, device="cpu")
    >>> cd.mode
    'joint-alternate'
    >>> [len(sel) for sel in cd.selection_names]   # one pick per group
    [1, 1, 1]
    >>> bool((cd.improvement >= 0).all())
    True
    """
    from repro_torch.core.spec import resolve_spec

    r = resolve_spec(spec, _JOINT_DEFAULTS, dict(
        mode=mode, steps=steps, lr=lr, span=span, beta=beta,
        timing_model=timing_model, cost_model=cost_model, w_area=w_area,
        w_power=w_power, area_budget=area_budget, power_budget=power_budget))
    mode, steps, lr, span, beta = (r["mode"], r["steps"], r["lr"], r["span"],
                                   r["beta"])
    timing_model, cost_model = r["timing_model"], r["cost_model"]
    w_area, w_power = r["w_area"], r["w_power"]
    area_budget, power_budget = r["area_budget"], r["power_budget"]

    if mode not in ("alternate", "softmax"):
        raise ValueError(f"unknown joint mode {mode!r}; "
                         "have ('alternate', 'softmax')")
    if area_budget is not None or power_budget is not None:
        _validate_budgets(area_budget, power_budget)
    backend = K.get_backend("torch", device)

    flat, gids, groups = _flatten_groups(profile_groups)
    n_groups = len(groups)
    pb, mb = _as_batches(flat, machines)
    fixed_np = mb.arrays()
    # Beta is a per-APPLICATION target: every sharding variant of a group
    # chases the same target (derived from the group's member 0 by default),
    # and an explicit beta has group length, not flattened length.
    first_rows = np.array([int(np.nonzero(gids == g)[0][0])
                           for g in range(n_groups)])
    if beta is None:
        beta_np = resolve_beta(pb, mb, None, beta_ref)[first_rows][gids]
    else:
        beta_np = np.broadcast_to(
            np.asarray(beta, dtype=np.float64), (n_groups,))[gids]
    theta0, lo, hi = theta_box(mb, span)
    n_rates = theta0.shape[1]
    a_total, v = len(pb), len(mb)
    # Per-group one-hot membership matrix for segment softmax: (A, G).
    member = np.zeros((a_total, n_groups))
    member[np.arange(a_total), gids] = 1.0
    constrained = area_budget is not None or power_budget is not None

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)
    member_t = backend.asarray(member)

    def retract_theta(th):
        if constrained:
            out, _ = project_to_budgets(
                torch, th, lo_t, hi_t, fixed, cost_model, area_budget,
                power_budget)
            return out
        return torch.clamp(th, lo_t, hi_t)

    def objective_with(th, weights):
        m = machine_arrays_from_theta(torch, th, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power,
                                app_weights=weights)

    @torch.no_grad()
    def aggregate_np(th):
        m = machine_arrays_from_theta(torch, th, fixed)
        out = K.congruence_kernel(torch, p_arrays, m, beta_t, timing_model,
                                  eps, clamp=False)
        return backend.to_numpy(out.aggregate)

    @torch.no_grad()
    def hard_objective(th, w_hard):
        return backend.to_numpy(objective_with(th, backend.asarray(w_hard)))

    with torch.no_grad():
        theta = retract_theta(backend.asarray(theta0))
    w_hard = _hard_weights(aggregate_np(theta), gids)
    obj_seed = hard_objective(theta, w_hard)
    history: List[np.ndarray] = [obj_seed]
    steps_round = max(1, steps // max(rounds + 1, 1))
    lr_v = lr
    # Best hard-selection iterate so far, per variant: the softmax
    # rounds descend a RELAXED objective, so the hard objective may
    # transiently regress; tracking the incumbent makes the reported
    # result monotone vs the seed by construction.
    best_theta, best_f = theta, backend.asarray(obj_seed)

    def track_best(theta, f_hard, best_theta, best_f):
        """Keep the incumbent under the (already computed) hard-selection
        objective of this round's boundary."""
        f = backend.asarray(f_hard)
        better = f < best_f
        return (torch.where(better[:, None], theta, best_theta),
                torch.minimum(f, best_f))

    # Round-varying state (selection weights, softmax temperature)
    # enters as arguments with a shared descent cache per mode.
    weighted_cache: dict = {}

    if mode == "alternate":
        for _ in range(rounds):
            theta, _, hist, _, lr_v = backtracking_descent(
                theta, objective_with, steps_round, lr_v,
                retract=retract_theta,
                obj_args=(backend.asarray(w_hard),), cache=weighted_cache)
            history.extend(hist[1:])
            w_hard = _hard_weights(aggregate_np(theta), gids)
            f_bound = hard_objective(theta, w_hard)
            history.append(f_bound)
            best_theta, best_f = track_best(theta, f_bound,
                                            best_theta, best_f)
    else:
        phi = theta.new_zeros((v, a_total))
        temps = np.geomspace(temp0, max(temp_min, 1e-6), max(rounds, 1))

        def retract_params(params):
            return torch.cat(
                [retract_theta(params[:, :n_rates]), params[:, n_rates:]],
                dim=1)

        def objective_soft(params, temp):
            th = params[:, :n_rates]
            logits = params[:, n_rates:].T          # (A, V)
            e = torch.exp(logits / temp)
            denom = member_t @ (member_t.T @ e)     # (A, V) per-group
            weights = e / denom / n_groups
            return objective_with(th, weights)

        soft_cache: dict = {}
        for temp in temps:
            params = torch.cat([theta, phi], dim=1)
            params, _, _, _, lr_v = backtracking_descent(
                params, objective_soft, steps_round, lr_v,
                retract=retract_params,
                obj_args=(backend.asarray(float(temp)),), cache=soft_cache)
            theta = params[:, :n_rates]
            phi = params[:, n_rates:]
            w_hard = _hard_weights(aggregate_np(theta), gids)
            f_bound = hard_objective(theta, w_hard)
            history.append(f_bound)
            best_theta, best_f = track_best(theta, f_bound,
                                            best_theta, best_f)

    # Final polish: machine-only descent under the incumbent's hard
    # selection, starting FROM the incumbent (backtracking guarantees
    # it never regresses past it).
    theta = best_theta
    w_hard = _hard_weights(aggregate_np(theta), gids)
    theta, _, hist, _, _ = backtracking_descent(
        theta, objective_with, steps_round, lr_v, retract=retract_theta,
        obj_args=(backend.asarray(w_hard),), cache=weighted_cache)
    history.extend(hist[1:])
    theta_np = backend.to_numpy(theta)
    # Re-select once more at the final machine so the reported
    # objective, the selection and the trajectory tail all agree (the
    # polish may have shifted which member wins; argmin re-selection
    # only ever lowers the objective).
    agg_final = aggregate_np(theta)
    w_hard = _hard_weights(agg_final, gids)
    f_cur = hard_objective(theta, w_hard)
    history.append(f_cur)

    # Hard per-(variant, group) picks by profile name.
    selection_names = []
    for vi in range(v):
        picks = []
        for g in range(n_groups):
            rows = np.nonzero(gids == g)[0]
            picks.append(pb.names[rows[np.argmin(agg_final[rows, vi])]])
        selection_names.append(picks)

    final_m = machine_arrays_from_theta(np, theta_np, fixed_np)
    feasible = (budget_feasible(np, final_m, cost_model, area_budget,
                                power_budget)
                if constrained else np.ones(v, dtype=bool))
    vtrace = ([np.asarray(budget_violation(np, final_m, cost_model,
                                           area_budget, power_budget))]
              if constrained else None)
    res = _finalize(
        mb, fixed_np, theta0, theta_np, history, steps, w_area, w_power,
        cost_model, f"joint-{mode}", "+joint", area_budget, power_budget,
        vtrace, feasible, np.asarray(f_cur), selection_names=selection_names)
    if not constrained:
        res.feasible = None
        res.area_budget = res.power_budget = None
    return res

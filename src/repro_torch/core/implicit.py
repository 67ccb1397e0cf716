"""Implicit differentiation through the co-design optimum.

The frontier answers "what is the best design at this budget"; this module
answers the other half of early design exploration -- "which constraint is
worth relaxing, and by how much".  Each budget's optimum ``theta*(b)`` is a
fixed point of the project-then-descend map from ``constrained.py``; instead
of differentiating through hundreds of unrolled descent steps (whose
projections are bisection solves with zero budget-derivative almost
everywhere), we apply the implicit function theorem at the KKT point:

* ``implicit_sensitivities`` / ``sensitivities_of`` -- first-order shadow
  prices ``lambda`` per constraint (scalar area/power budgets and
  per-subsystem envelopes) recovered from the stationarity system
  ``grad J + G^T lambda = 0`` on the free (non-box-active) coordinates,
  plus the envelope-theorem sensitivities ``dJ*/d(budget) = -lambda`` and
  ``dJ*/d(cost-model weights)``.
* ``implicit_jstar_fn`` -- a differentiable ``J*(budgets)``: a
  ``torch.autograd.Function`` whose forward pass runs the descent without
  recording a graph (the autograd graph does not grow with ``steps``) and
  whose backward pass solves the linearized KKT system directly on the
  small per-variant theta dimension.
* ``unrolled_jstar_fn`` -- the penalty-smoothed unrolled-descent baseline
  (its autograd graph grows with ``steps``).
* ``bilevel_codesign`` -- outer gradient descent on the split of one total
  budget across area and power, through the inner optimum.

Constraint columns follow ``constrained.budget_violations_vector`` order:
scalar area, scalar power, then envelope fields sorted by name (see
``constraint_labels``).

The port of the JAX package's implicit module.  The gradients are
``torch.autograd.grad`` of the float64 torch math on ``device`` (``"cuda"``
unless the caller passes ``device="cpu"``; without a card it raises); the
JAX package's ``jax.custom_vjp`` is a ``torch.autograd.Function`` and its
``lax.fori_loop`` solve a Python loop.  The careful NNLS multiplier
recovery stays NumPy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

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
    resolve_beta,
    theta_box,
)
from repro_torch.core.constrained import (
    _area_posynomial,
    _power_posynomial,
    _set_column,
    constrained_codesign,
    constraint_labels,
    project_to_budgets,
    validate_area_envelope,
)
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, RATE_FIELDS
from repro_torch.core.spec import resolve_spec

__all__ = [
    "SensitivityReport",
    "implicit_sensitivities",
    "sensitivities_of",
    "implicit_jstar_fn",
    "unrolled_jstar_fn",
    "BilevelResult",
    "bilevel_codesign",
]

#: Relative slack for "constraint is active": value >= budget * (1 - tol).
ACTIVE_RTOL = 1e-5
#: Absolute log-space slack for "coordinate is pinned at the span box".
BOX_ATOL = 1e-7

#: theta column per envelope field (``ici_bw_total`` rides on the
#: per-link ``ici_bw`` column; the link count is a fixed constant here).
_ENV_COL = {f: j for j, f in
            enumerate(("peak_flops", "hbm_bw", "ici_bw", "inter_pod_bw"))}
_ENV_COL["ici_bw_total"] = _ENV_COL.pop("ici_bw")


# --------------------------------------------------------------------------- #
# Constraint values + analytic gradients (shared by the NumPy report path
# and the autograd Function's backward pass)
# --------------------------------------------------------------------------- #


def _constraint_system(xp, theta, fixed, cost_model, area_budget,
                       power_budget, area_envelope):
    """Values ``(V, C)``, gradients ``(V, C, D)`` and budgets ``(V, C)``
    for every configured constraint, in ``constraint_labels`` order.

    Gradients are analytic posynomial derivatives in log-rate space
    (``d/d theta_j  c_j e^(e_j theta_j) = c_j e_j e^(e_j theta_j)``), so
    this works identically for NumPy arrays and torch tensors.
    ``area_budget`` may be per-variant ``(V,)`` (the frontier's rows).
    """
    d = len(OPT_FIELDS)
    th = theta[:, :d]
    values, grads, budgets = [], [], []
    ones = xp.ones_like(th[:, 0])
    if area_budget is not None:
        coeff, expo, offset = _area_posynomial(xp, cost_model, fixed)
        terms = coeff * xp.exp(expo[None, :] * th)
        values.append(xp.sum(terms, axis=1) + offset)
        grads.append(terms * expo[None, :])
        budgets.append(ones * area_budget)
    if power_budget is not None:
        coeff, expo, offset = _power_posynomial(xp, cost_model, fixed)
        terms = coeff * xp.exp(expo[None, :] * th)
        values.append(xp.sum(terms, axis=1) + offset)
        grads.append(terms * expo[None, :])
        budgets.append(ones * power_budget)
    if area_envelope:
        ref = cost_model.reference
        for field in sorted(area_envelope):
            col = _ENV_COL[field]
            scale = (fixed.ici_links / ref.ici_bw_total
                     if field == "ici_bw_total"
                     else 1.0 / getattr(ref, field))
            val = scale * xp.exp(th[:, col])
            g = _set_column(xp, xp.zeros_like(th), col, val)
            values.append(val)
            grads.append(g)
            budgets.append(ones * area_envelope[field])
    return (xp.stack(values, axis=1),
            xp.stack(grads, axis=1),
            xp.stack(budgets, axis=1))


def _free_mask(xp, theta, lo, hi, atol):
    """Coordinates strictly inside the span box (KKT stationarity is only
    required on these; box-pinned coordinates carry their own multiplier
    which we fold away by dropping the coordinate)."""
    d = theta.shape[1]
    return (theta > lo[:, :d] + atol) & (theta < hi[:, :d] - atol)


def _nnls_multipliers(gj, grads, active, free, tol=1e-12):
    """Per-variant nonnegative least-squares multipliers (NumPy).

    Solves ``min || G_A^T lam + grad J ||`` on the free coordinates over
    the active set ``A``, pruning the most-negative multiplier until all
    remaining are nonnegative (classic active-set NNLS on a tiny system).
    Returns ``(lam (V, C), residual (V,))`` where ``residual`` is the
    relative stationarity defect -- a diagnostic for "was this actually a
    KKT point".

    >>> gj = np.array([[-2.0, 0.0]])          # one variant, two coords
    >>> grads = np.array([[[1.0, 0.0], [0.0, 1.0]]])  # two constraints
    >>> active = np.array([[True, False]])
    >>> free = np.array([[True, True]])
    >>> lam, res = _nnls_multipliers(gj, grads, active, free)
    >>> lam.round(6).tolist(), res.round(6).tolist()
    ([[2.0, 0.0]], [0.0])
    """
    v, c = active.shape
    lam = np.zeros((v, c))
    residual = np.zeros(v)
    for i in range(v):
        f = free[i]
        g_free = gj[i][f]
        norm = max(float(np.linalg.norm(gj[i])), 1e-30)
        act = [int(j) for j in np.nonzero(active[i])[0]]
        while act:
            a = grads[i][np.asarray(act)][:, f]          # (|A|, F)
            sol, *_ = np.linalg.lstsq(a.T, -g_free, rcond=None)
            if sol.size == 0 or float(np.min(sol)) >= -tol:
                lam[i, np.asarray(act)] = np.maximum(sol, 0.0)
                break
            act.pop(int(np.argmin(sol)))
        r = g_free + grads[i][:, f].T @ lam[i]
        residual[i] = float(np.linalg.norm(r)) / norm
    return lam, residual


def _ridge_multipliers(gj, grads, active, free, ridge=1e-10):
    """Multiplier solve for the autograd Function's backward pass (torch).

    Masks inactive constraints and box-pinned coordinates to zero, solves
    the (C, C) normal equations with a small ridge (a direct solve on the
    small theta dimension -- C <= 6), and clamps to nonnegative.  Agrees
    with ``_nnls_multipliers`` away from degenerate active sets; the NumPy
    path remains the careful reference.
    """
    a_eff = grads * active[:, :, None] * free[:, None, :]
    g_eff = gj * free
    c = a_eff.shape[1]
    m = (torch.einsum("vcd,ved->vce", a_eff, a_eff)
         + ridge * torch.eye(c, dtype=a_eff.dtype, device=a_eff.device))
    rhs = -torch.einsum("vcd,vd->vc", a_eff, g_eff)
    lam = torch.linalg.solve(m, rhs[..., None])[..., 0]
    return torch.where(active, torch.clamp(lam, min=0.0),
                       torch.zeros_like(lam))


# --------------------------------------------------------------------------- #
# The sensitivity report
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class SensitivityReport:
    """Shadow prices and envelope-theorem sensitivities at an optimum.

    ``multipliers[v, c]`` is the KKT multiplier of constraint ``c`` (order:
    ``constraint_names``) for variant ``v`` against its ABSOLUTE budget, so
    ``dJ_dbudget = -multipliers``: relaxing budget ``c`` by ``db`` buys a
    first-order objective improvement of ``multipliers[v, c] * db``.
    """

    names: List[str]
    constraint_names: Tuple[str, ...]
    multipliers: np.ndarray          # (V, C) shadow prices, >= 0
    dJ_dbudget: np.ndarray           # (V, C) = -multipliers
    active: np.ndarray               # (V, C) bool constraint-active mask
    free: np.ndarray                 # (V, D) bool inside-the-box mask
    residual: np.ndarray             # (V,) relative stationarity defect
    objective: np.ndarray            # (V,) J at the point
    area: np.ndarray                 # (V,)
    power: np.ndarray                # (V,)
    dJ_dw_area: np.ndarray           # (V,) envelope theorem: area(theta*)
    dJ_dw_power: np.ndarray          # (V,) envelope theorem: power(theta*)
    dJ_darea_weights: Dict[str, np.ndarray]   # field -> (V,)
    dJ_dpower_weights: Dict[str, np.ndarray]  # field -> (V,)
    area_budget: Optional[object] = None
    power_budget: Optional[float] = None
    area_envelope: Optional[Dict[str, float]] = None

    def best_relaxation(self, i: int) -> Optional[str]:
        """The constraint whose relaxation buys variant ``i`` the most."""
        lam = self.multipliers[i]
        if not np.any(lam > 0.0):
            return None
        return self.constraint_names[int(np.argmax(lam))]

    def to_json(self, top_k: Optional[int] = None) -> dict:
        order = list(range(len(self.names)))
        if top_k is not None:
            order = sorted(sorted(order,
                                  key=lambda i: float(self.objective[i]))
                           [:top_k])
        return {
            "constraints": list(self.constraint_names),
            "variants": [
                {"name": self.names[i],
                 "objective": float(self.objective[i]),
                 "area": float(self.area[i]),
                 "power": float(self.power[i]),
                 "shadow_prices": {c: float(self.multipliers[i, j])
                                   for j, c in
                                   enumerate(self.constraint_names)},
                 "dJ_dbudget": {c: float(self.dJ_dbudget[i, j])
                                for j, c in
                                enumerate(self.constraint_names)},
                 "active": {c: bool(self.active[i, j])
                            for j, c in enumerate(self.constraint_names)},
                 "stationarity_residual": float(self.residual[i]),
                 "best_relaxation": self.best_relaxation(i),
                 "dJ_dw_area": float(self.dJ_dw_area[i]),
                 "dJ_dw_power": float(self.dJ_dw_power[i])}
                for i in order],
        }

    def markdown(self, top_k: Optional[int] = None) -> str:
        blob = self.to_json(top_k)
        cols = "".join(f" {c} |" for c in self.constraint_names)
        lines = [f"| variant | J |{cols} relax first |",
                 "|---|---|" + "---|" * (len(self.constraint_names) + 1)]
        for row in blob["variants"]:
            prices = "".join(
                f" {row['shadow_prices'][c]:.4f}"
                f"{'' if row['active'][c] else ' (slack)'} |"
                for c in self.constraint_names)
            lines.append(f"| {row['name']} | {row['objective']:.4f} |"
                         f"{prices} {row['best_relaxation'] or '-'} |")
        lines.append("")
        lines.append("shadow price = dJ*/d(budget) with sign flipped; "
                     "slack constraints price at ~0 (complementary "
                     "slackness).")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
# First-order sensitivities at a given point
# --------------------------------------------------------------------------- #


def _first_order_report(pb, names, fixed_np, theta_np, lo, hi, *,
                        area_budget, power_budget, area_envelope,
                        cost_model, beta_np, timing_model, eps,
                        w_area, w_power, active_rtol=ACTIVE_RTOL,
                        box_atol=BOX_ATOL,
                        device=K.DEFAULT_DEVICE) -> SensitivityReport:
    """Assemble a ``SensitivityReport`` from raw arrays (internal: the
    public entry points and ``frontier_codesign`` both funnel here).  The
    objective's gradient is autograd of the float64 torch math on
    ``device``; the multipliers are solved on the host."""
    backend = K.get_backend("torch", device)
    d = len(OPT_FIELDS)
    theta_np = np.asarray(theta_np, dtype=np.float64)[:, :d]

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    with torch.enable_grad():
        theta = backend.asarray(theta_np).requires_grad_(True)
        m = machine_arrays_from_theta(torch, theta, fixed)
        total = torch.sum(_objective_terms(torch, p_arrays, m, beta_t,
                                           timing_model, eps, cost_model,
                                           w_area, w_power))
        (g,) = torch.autograd.grad(total, theta)
    gj = backend.to_numpy(g)

    values, grads, budgets = _constraint_system(
        np, theta_np, fixed_np, cost_model, area_budget, power_budget,
        area_envelope)
    active = values >= budgets * (1.0 - active_rtol)
    free = _free_mask(np, theta_np, lo, hi, box_atol)
    lam, residual = _nnls_multipliers(gj, grads, active, free)

    m_np = machine_arrays_from_theta(np, theta_np, fixed_np)
    area = np.asarray(cost_model.area(m_np))
    power = np.asarray(cost_model.power(m_np))
    with np.errstate(divide="ignore", invalid="ignore"):
        obj = _objective_terms(np, pb.arrays(), m_np, beta_np, timing_model,
                               eps, cost_model, w_area, w_power)

    labels = constraint_labels(area_budget, power_budget, area_envelope)
    lam_area = (lam[:, labels.index("area")]
                if "area" in labels else np.zeros(len(names)))
    lam_power = (lam[:, labels.index("power")]
                 if "power" in labels else np.zeros(len(names)))

    # Envelope theorem for the cost-model weights: the weights enter J both
    # through the scalarization terms (weights w_area/w_power) and through
    # any active area/power constraint (multipliers lam_area/lam_power).
    ref = cost_model.reference
    w_sum_a = sum(cost_model.area_weights[f] for f in RATE_FIELDS)
    w_sum_p = sum(cost_model.power_weights[f] for f in RATE_FIELDS)
    norm = {f: _norm_rate(m_np, ref, f) for f in RATE_FIELDS}
    dyn = power - cost_model.static_power
    d_aw = {f: (w_area + lam_area) * (norm[f] - area) / w_sum_a
            for f in RATE_FIELDS}
    d_pw = {f: (w_power + lam_power)
            * (norm[f] ** cost_model.power_exponents[f] - dyn) / w_sum_p
            for f in RATE_FIELDS}

    return SensitivityReport(
        names=list(names),
        constraint_names=tuple(labels),
        multipliers=lam,
        dJ_dbudget=-lam,
        active=active,
        free=free,
        residual=residual,
        objective=np.asarray(obj),
        area=area,
        power=power,
        dJ_dw_area=area,
        dJ_dw_power=power,
        dJ_darea_weights=d_aw,
        dJ_dpower_weights=d_pw,
        area_budget=area_budget,
        power_budget=power_budget,
        area_envelope=dict(area_envelope) if area_envelope else None,
    )


def _norm_rate(m, ref, field):
    if field == "ici_bw_total":
        return np.asarray(m.ici_bw_total) / ref.ici_bw_total
    return np.asarray(getattr(m, field)) / getattr(ref, field)


def polish_theta(profiles, machines, theta, *, area_budget=None,
                 power_budget=None, area_envelope=None, steps=40, lr=0.05,
                 span=16.0, projection="euclidean", beta=None, beta_ref=0,
                 timing_model="serial", eps=K.IDEAL_EPS,
                 cost_model=DEFAULT_COST_MODEL, w_area=0.1, w_power=0.05,
                 device=K.DEFAULT_DEVICE):
    """Refine ``theta`` toward the KKT point with a short projected
    descent (same objective/retraction as ``constrained_codesign``) and
    return the polished ``(theta, objective)`` as NumPy arrays.

    This is the warm-started re-solve the finite-difference harness uses
    to evaluate ``J*(b +- h)``, and the optional pre-step of
    ``implicit_sensitivities``: the sensitivity formulas assume the point
    actually is stationary.  ``area_budget`` may be per-variant ``(V,)``.
    The descent runs in float64 on ``device`` (``"cuda"`` by default).
    """
    area_envelope = validate_area_envelope(area_envelope)
    backend = K.get_backend("torch", device)
    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    _, lo, hi = theta_box(mb, span)
    d = len(OPT_FIELDS)
    theta = np.asarray(theta, dtype=np.float64)[:, :d]

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)
    b_area = (None if area_budget is None
              else backend.asarray(np.asarray(area_budget)))

    def objective(th):
        m = machine_arrays_from_theta(torch, th, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power)

    def retract(th):
        out, _ = project_to_budgets(torch, th, lo_t, hi_t, fixed,
                                    cost_model, b_area, power_budget,
                                    area_envelope=area_envelope,
                                    method=projection)
        return out

    with torch.no_grad():
        seed = retract(backend.asarray(theta))
    th, f_cur, _, _, _ = backtracking_descent(
        seed, objective, steps, lr, retract=retract)
    return backend.to_numpy(th), backend.to_numpy(f_cur)


def implicit_sensitivities(profiles, machines, theta=None, *,
                           area_budget=None, power_budget=None,
                           area_envelope=None, span=16.0, polish_steps=0,
                           projection="euclidean", lr=0.05, beta=None,
                           beta_ref=0, timing_model="serial",
                           eps=K.IDEAL_EPS, cost_model=DEFAULT_COST_MODEL,
                           w_area=0.1, w_power=0.05,
                           active_rtol=ACTIVE_RTOL,
                           box_atol=BOX_ATOL,
                           device=K.DEFAULT_DEVICE) -> SensitivityReport:
    """Shadow prices and budget sensitivities at an optimized design.

    ``machines`` are the SEED variants (they define the span box the
    descent ran in); ``theta`` is the optimized ``(V, len(OPT_FIELDS))``
    log-rate matrix (defaults to the seed rates).  Set ``polish_steps`` to
    refine a roughly-converged point before reading multipliers -- the
    implicit function theorem only holds AT the optimum.  The gradients
    run in float64 on ``device`` (``"cuda"`` by default).
    """
    area_envelope = validate_area_envelope(area_envelope)
    if area_budget is None and power_budget is None and not area_envelope:
        raise ValueError("implicit_sensitivities needs at least one of "
                         "area_budget, power_budget, area_envelope")
    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    theta0, lo, hi = theta_box(mb, span)
    theta = theta0 if theta is None else np.asarray(theta, np.float64)
    if polish_steps:
        theta, _ = polish_theta(
            profiles, mb, theta, area_budget=area_budget,
            power_budget=power_budget, area_envelope=area_envelope,
            steps=polish_steps, lr=lr, span=span, projection=projection,
            beta=beta, beta_ref=beta_ref, timing_model=timing_model,
            eps=eps, cost_model=cost_model, w_area=w_area, w_power=w_power,
            device=device)
    return _first_order_report(
        pb, mb.names, fixed_np, theta, lo, hi, area_budget=area_budget,
        power_budget=power_budget, area_envelope=area_envelope,
        cost_model=cost_model, beta_np=beta_np, timing_model=timing_model,
        eps=eps, w_area=w_area, w_power=w_power, active_rtol=active_rtol,
        box_atol=box_atol, device=device)


def sensitivities_of(result: CodesignResult, profiles, *, span=16.0,
                     polish_steps=0, beta=None, beta_ref=0,
                     timing_model="serial", eps=K.IDEAL_EPS,
                     cost_model=DEFAULT_COST_MODEL, device=K.DEFAULT_DEVICE,
                     **overrides) -> SensitivityReport:
    """``implicit_sensitivities`` at a ``CodesignResult``'s final designs.

    Reconstructs the seed box from ``result.seed_params`` and evaluates at
    ``result.final_params`` under the result's budgets and scalarization
    weights.  Joint-mode results (per-variant app selection) are not
    supported -- their objective is not the plain scalarization.
    """
    if result.mode.startswith("joint"):
        raise ValueError("sensitivities_of does not support joint-mode "
                         "results (selection changes the objective)")
    from repro_torch.core.sweep import MachineBatch

    def batch(params_list):
        fields = ("peak_flops", "hbm_bw", "ici_bw", "ici_links",
                  "inter_pod_bw", "scale_compute", "scale_memory",
                  "scale_interconnect")
        cols = {f: np.array([p[f] for p in params_list], dtype=np.float64)
                for f in fields}
        return MachineBatch(names=list(result.names), **cols)

    seeds = batch(result.seed_params)
    finals = batch(result.final_params)
    theta = np.log(np.stack(
        [[p[f] for f in OPT_FIELDS] for p in result.final_params]))
    pb, _ = _as_batches(profiles, seeds)
    beta_np = resolve_beta(pb, seeds, beta, beta_ref)
    _, lo, hi = theta_box(seeds, span)
    if polish_steps:
        if not np.allclose(seeds.ici_links, finals.ici_links):
            raise ValueError("polish is not supported for link-optimized "
                             "results (the integral link count is frozen)")
        theta, _ = polish_theta(
            profiles, seeds, theta, area_budget=result.area_budget,
            power_budget=result.power_budget,
            area_envelope=result.area_envelope, steps=polish_steps,
            span=span, beta=beta, beta_ref=beta_ref,
            timing_model=timing_model, eps=eps, cost_model=cost_model,
            w_area=result.w_area, w_power=result.w_power, device=device,
            **overrides)
    return _first_order_report(
        pb, result.names, finals.arrays(), theta, lo, hi,
        area_budget=result.area_budget, power_budget=result.power_budget,
        area_envelope=result.area_envelope, cost_model=cost_model,
        beta_np=beta_np, timing_model=timing_model, eps=eps,
        w_area=result.w_area, w_power=result.w_power, device=device)
# --------------------------------------------------------------------------- #
# Differentiable J*(budgets): forward solve + KKT backward (autograd Function)
# --------------------------------------------------------------------------- #


def _grad_of_sum(per_variant_obj):
    """``theta -> d sum(per_variant_obj(theta)) / d theta`` on a leaf copy,
    no graph kept."""
    def grad(theta):
        with torch.enable_grad():
            leaf = theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(per_variant_obj(leaf).sum(), leaf)
        return g
    return grad


def implicit_jstar_fn(profiles, machines, *, steps=80, lr=0.1, span=16.0,
                      projection="euclidean", area_envelope=None, beta=None,
                      beta_ref=0, timing_model="serial", eps=K.IDEAL_EPS,
                      cost_model=DEFAULT_COST_MODEL, w_area=0.1,
                      w_power=0.05, active_rtol=ACTIVE_RTOL,
                      box_atol=BOX_ATOL, device=K.DEFAULT_DEVICE):
    """Build a differentiable ``jstar(budgets) -> (V,)`` map.

    ``budgets`` is a length-2 array ``[area_budget, power_budget]`` (a
    tensor that requires grad, or anything ``torch.as_tensor`` takes).
    The forward pass runs ``steps`` backtracking projected-descent
    iterations without recording a graph (the autograd graph does NOT grow
    with ``steps`` -- pinned by the structure regression test); the
    backward pass ignores the solver entirely and returns the
    envelope-theorem cotangent ``b_bar = -sum_v y_bar_v * lambda_v`` with
    multipliers from a direct ridge solve of the linearized KKT system
    (``C <= 6`` constraints, ``D = 4`` theta coordinates per variant).
    Float64 on ``device`` (``"cuda"`` by default).
    """
    area_envelope = validate_area_envelope(area_envelope)
    backend = K.get_backend("torch", device)
    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    theta0, lo, hi = theta_box(mb, span)

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    theta0_t = backend.asarray(theta0)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)

    def per_variant_obj(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power)

    grad_obj = _grad_of_sum(per_variant_obj)

    def solve(b):
        def retract(th):
            out, _ = project_to_budgets(torch, th, lo_t, hi_t, fixed,
                                        cost_model, b[0], b[1],
                                        area_envelope=area_envelope,
                                        method=projection)
            return out

        th = retract(theta0_t)
        f = per_variant_obj(th)
        lrs = torch.full_like(f, lr)
        for _ in range(steps):
            cand = retract(th - lrs[:, None] * grad_obj(th))
            f_new = per_variant_obj(cand)
            ok = f_new < f
            th = torch.where(ok[:, None], cand, th)
            f = torch.where(ok, f_new, f)
            lrs = torch.where(ok, lrs * 1.2, lrs * 0.5)
        return th

    class _JStar(torch.autograd.Function):
        @staticmethod
        def forward(ctx, b):
            with torch.no_grad():
                th = solve(b)
                out = per_variant_obj(th)
            ctx.save_for_backward(th, b)
            return out

        @staticmethod
        def backward(ctx, ybar):
            th, b = ctx.saved_tensors
            gj = grad_obj(th)
            with torch.no_grad():
                values, grads, budgets = _constraint_system(
                    torch, th, fixed, cost_model, b[0], b[1], area_envelope)
                active = values >= budgets * (1.0 - active_rtol)
                free = _free_mask(torch, th, lo_t, hi_t, box_atol)
                lam = _ridge_multipliers(gj, grads, active, free)
                # dJ*_v/db_i = -lambda_{v,i}; the scalar budgets are
                # columns 0, 1.
                return -torch.sum(ybar[:, None] * lam[:, :2], dim=0)

    def fn(budgets):
        b = torch.as_tensor(budgets).to(device=backend.device,
                                        dtype=torch.float64)
        return _JStar.apply(b)

    return fn


def unrolled_jstar_fn(profiles, machines, *, steps=40, lr=0.05, span=16.0,
                      penalty=200.0, beta=None, beta_ref=0,
                      timing_model="serial", eps=K.IDEAL_EPS,
                      cost_model=DEFAULT_COST_MODEL, w_area=0.1,
                      w_power=0.05, device=K.DEFAULT_DEVICE):
    """Differentiate-through-the-solver baseline: an unrolled
    quadratic-penalty descent whose autograd graph (and gradient cost)
    grows linearly with ``steps``.

    The hard projections in ``constrained.py`` are bisection solves --
    piecewise constant in the budget under autodiff -- so the unrolled
    baseline smooths them into a penalty ``rho * relu(value/b - 1)^2``;
    its budget-gradient is a penalty approximation of the true shadow
    price.  Used by the structure regression test as the thing the
    implicit backward avoids.  Float64 on ``device`` (``"cuda"`` by
    default).
    """
    backend = K.get_backend("torch", device)
    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    theta0, lo, hi = theta_box(mb, span)

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    theta0_t = backend.asarray(theta0)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)

    def per_variant_obj(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power)

    def penalized(theta, b):
        m = machine_arrays_from_theta(torch, theta, fixed)
        viol_a = torch.clamp(cost_model.area(m) / b[0] - 1.0, min=0.0)
        viol_p = torch.clamp(cost_model.power(m) / b[1] - 1.0, min=0.0)
        return (per_variant_obj(theta)
                + penalty * (viol_a ** 2 + viol_p ** 2))

    def fn(budgets):
        b = torch.as_tensor(budgets).to(device=backend.device,
                                        dtype=torch.float64)
        with torch.enable_grad():
            th = theta0_t
            for _ in range(steps):        # deliberately unrolled
                if not th.requires_grad:
                    th = th.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(
                    torch.sum(penalized(th, b)), th,
                    create_graph=b.requires_grad)
                th = torch.clamp(th - lr * g, lo_t, hi_t)
            return penalized(th, b)

    return fn


# --------------------------------------------------------------------------- #
# Bilevel budget descent
# --------------------------------------------------------------------------- #


_BILEVEL_DEFAULTS = dict(
    total_budget=None, split0=0.5, outer_steps=10, outer_lr=0.2,
    steps=60, lr=0.1, span=16.0, projection="euclidean", beta=None,
    timing_model="serial", cost_model=DEFAULT_COST_MODEL, w_area=0.1,
    w_power=0.05, area_envelope=None,
)
_SPLIT_MIN = 0.02


@dataclasses.dataclass
class BilevelResult:
    """Outcome of the outer budget-split descent (uniform result protocol:
    renders via ``markdown``/``to_json`` like every other result type)."""

    total_budget: float
    split_trajectory: np.ndarray       # (T+1,) accepted splits, s in (0, 1)
    objective_trajectory: np.ndarray   # (T+1,) min-variant J* per accepted s
    objective_uniform: float           # J* at the fixed 50/50 split
    inner: CodesignResult              # full inner solve at the final split
    sensitivity: SensitivityReport
    outer_steps: int

    @property
    def split_final(self) -> float:
        return float(self.split_trajectory[-1])

    @property
    def objective_final(self) -> float:
        return float(self.objective_trajectory[-1])

    @property
    def area_budget(self) -> float:
        return self.split_final * self.total_budget

    @property
    def power_budget(self) -> float:
        return (1.0 - self.split_final) * self.total_budget

    @property
    def improvement_over_uniform(self) -> float:
        """Objective gain of the learned split vs the 50/50 baseline
        (nonnegative by construction: the outer loop only accepts
        improving steps starting FROM the uniform split)."""
        return self.objective_uniform - self.objective_final

    def to_json(self, top_k: Optional[int] = None) -> dict:
        return {
            "total_budget": self.total_budget,
            "split_final": self.split_final,
            "area_budget": self.area_budget,
            "power_budget": self.power_budget,
            "objective_uniform": self.objective_uniform,
            "objective_final": self.objective_final,
            "improvement_over_uniform": self.improvement_over_uniform,
            "outer_steps": self.outer_steps,
            "split_trajectory": [float(s) for s in self.split_trajectory],
            "objective_trajectory": [float(f) for f in
                                     self.objective_trajectory],
            "inner": self.inner.to_json(top_k),
            "sensitivity": self.sensitivity.to_json(top_k),
        }

    def markdown(self, top_k: Optional[int] = None) -> str:
        lines = [
            "| total budget | split (area) | area budget | power budget "
            "| J* uniform | J* bilevel | gain |",
            "|---|---|---|---|---|---|---|",
            (f"| {self.total_budget:.3f} | {self.split_final:.3f} "
             f"| {self.area_budget:.3f} | {self.power_budget:.3f} "
             f"| {self.objective_uniform:.4f} "
             f"| {self.objective_final:.4f} "
             f"| {self.improvement_over_uniform:+.4f} |"),
            "",
            self.inner.markdown(top_k),
        ]
        return "\n".join(lines)


def bilevel_codesign(profiles, machines, *, spec=None,
                     device=K.DEFAULT_DEVICE, **explicit) -> BilevelResult:
    """Outer gradient descent on the split of ``total_budget`` across the
    area and power budgets, THROUGH the inner constrained optimum.

    The inner problem at split ``s`` is ``constrained_codesign`` with
    ``area_budget = s * T`` and ``power_budget = (1 - s) * T``; the outer
    gradient ``dJ*/ds = T * (lambda_power - lambda_area)`` comes for free
    from the implicit backward (one KKT solve, no unrolling): each outer
    evaluation makes the split a leaf tensor and takes one
    ``torch.autograd.grad``.  Starting from the uniform split and
    accepting only improving steps makes the result at least as good as
    the fixed 50/50 baseline by construction.

    Accepts a ``CodesignSpec`` (``total_budget``, ``outer_steps``,
    ``outer_lr``, ``split0``, inner ``steps``/``lr``/``span``/... -- the
    serving funnel's ``kind="bilevel"``) with explicit kwargs winning.
    Float64 on ``device`` (``"cuda"`` by default).
    """
    cfg = resolve_spec(spec, _BILEVEL_DEFAULTS, explicit)
    total = cfg["total_budget"]
    if total is None or not total > 0.0:
        raise ValueError("bilevel_codesign needs a positive total_budget "
                         f"(got {total!r})")
    split0 = float(cfg["split0"])
    if not _SPLIT_MIN <= split0 <= 1.0 - _SPLIT_MIN:
        raise ValueError(f"split0 must lie in [{_SPLIT_MIN}, "
                         f"{1 - _SPLIT_MIN}], got {split0!r}")
    outer_steps, outer_lr = int(cfg["outer_steps"]), float(cfg["outer_lr"])

    backend = K.get_backend("torch", device)
    inner_kw = dict(steps=cfg["steps"], lr=cfg["lr"], span=cfg["span"],
                    projection=cfg["projection"], beta=cfg["beta"],
                    timing_model=cfg["timing_model"],
                    cost_model=cfg["cost_model"], w_area=cfg["w_area"],
                    w_power=cfg["w_power"],
                    area_envelope=cfg["area_envelope"])
    jstar = implicit_jstar_fn(profiles, machines, device=device, **inner_kw)

    def val_grad(s):
        with torch.enable_grad():
            s_t = torch.tensor(s, dtype=torch.float64, device=backend.device,
                               requires_grad=True)
            out = torch.amin(jstar(torch.stack([s_t * total,
                                                (1.0 - s_t) * total])))
            (g,) = torch.autograd.grad(out, s_t)
        return float(out.detach()), float(g)

    s = split0
    f, g = val_grad(s)
    splits, objs = [s], [f]
    eta = outer_lr
    for _ in range(outer_steps):
        cand = float(np.clip(s - eta * g, _SPLIT_MIN, 1.0 - _SPLIT_MIN))
        fc, gc = val_grad(cand)
        if fc < f and cand != s:
            s, f, g = cand, fc, gc
            eta *= 1.2
        else:
            eta *= 0.5
        splits.append(s)
        objs.append(f)

    inner = constrained_codesign(
        profiles, machines, area_budget=s * total,
        power_budget=(1.0 - s) * total, mode="projected", device=device,
        **inner_kw)
    sens = sensitivities_of(
        inner, profiles, span=cfg["span"], beta=cfg["beta"],
        timing_model=cfg["timing_model"], cost_model=cfg["cost_model"],
        device=device)
    if split0 == 0.5:
        uniform = float(objs[0])
    else:
        with torch.no_grad():
            uniform = float(torch.amin(jstar([0.5 * total, 0.5 * total])))
    return BilevelResult(
        total_budget=float(total),
        split_trajectory=np.asarray(splits),
        objective_trajectory=np.asarray(objs),
        objective_uniform=uniform,
        inner=inner,
        sensitivity=sens,
        outer_steps=outer_steps,
    )

"""Gradient-based machine co-design: ``torch.autograd`` through the shared math.

The sweep engine answers "which of these sampled designs fits best?"; this
module answers the continuous version -- "in which direction should the
design move?" -- by differentiating a scalarized multi-objective

    J(m) = mean-over-apps aggregate congruence
           + w_area * CostModel.area(m) + w_power * CostModel.power(m)

with respect to the *log* of the provisioned rates (``peak_flops``,
``hbm_bw``, ``ici_bw``, ``inter_pod_bw``).  Descent is on log-rates, NOT
raw rates: log-parameterization keeps the rates positive and makes one
step a multiplicative change, matching how hardware design points actually
move (2x the MXUs, 1.5x the HBM stacks).  The ``span`` clip bounds the
feasible box in that same log space -- each rate is confined to
``[seed/span, seed*span]``, i.e. ``log(rate)`` to ``log(seed) +- log(span)``
-- so every operator downstream (the backtracking retraction here, the
budget projection in ``repro_torch.core.constrained``) composes in one
coordinate system.

The port of the JAX package's co-design module.  The timing/Eq. 1 math
lives in ONE place (``repro_torch.core.kernels_xp``), written against an
array namespace; the descent evaluates it with ``xp=torch`` in float64 on
``device`` (``"cuda"`` unless the caller passes ``device="cpu"``) and takes
the gradient with ``torch.autograd.grad``.  The Hopper kernels K1-K4 have no
backward (nor have the JAX package's Pallas kernels): the descent runs the
plain version of the math, and the sweep kernels re-score its results.
``ici_links`` (integer) and the per-subsystem degradation ``scale_*``
factors are held fixed at their seed values here; the constrained
subsystem (``repro_torch.core.constrained``) relaxes ``ici_links``
continuously and rounds with repair.

The objective uses unclamped Eq. 1 scores: clamping to [0, 1] zeroes the
gradient wherever a score saturates, which is exactly where a dominated
subsystem most needs a push.  Descent uses per-variant backtracking (halve
the step on failure, grow it on success), so every accepted update strictly
decreases that variant's objective.

Entry points:
  scalarized_objective -- evaluate J per variant (NumPy in, NumPy out)
  grad_codesign        -- descend J from a MachineBatch seed; returns a
                          ``CodesignResult`` with per-variant trajectories
                          and the optimized ``MachineModel`` designs.

Constrained descent (area/power budgets), joint machine+sharding-variant
descent and the ``ici_links`` integer relaxation live in
``repro_torch.core.constrained`` and reuse this module's descent machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kernels_xp as K
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.machine import MachineModel

#: The machine constants the gradient may move, in theta column order.
#: ``repro_torch.core.constrained`` appends a 5th column, ``log(ici_links)``,
#: when the integer relaxation is enabled.
OPT_FIELDS = ("peak_flops", "hbm_bw", "ici_bw", "inter_pod_bw")


def _as_batches(profiles, machines):
    from repro_torch.core.sweep import _as_machine_batch, _as_profile_batch
    return _as_profile_batch(profiles), _as_machine_batch(machines)


def machine_arrays_from_theta(xp, theta, fixed: K.MachineArrays) -> K.MachineArrays:
    """Rebuild ``MachineArrays`` with rates ``exp(theta)``, rest from seed.

    ``theta`` has one column per ``OPT_FIELDS`` entry; a 5th column, when
    present, carries ``log(ici_links)`` (the continuous relaxation used by
    ``repro_torch.core.constrained``), otherwise links stay at the seed value.
    """
    links = (xp.exp(theta[:, 4]) if theta.shape[1] == len(OPT_FIELDS) + 1
             else fixed.ici_links)
    return K.MachineArrays(
        peak_flops=xp.exp(theta[:, 0]),
        hbm_bw=xp.exp(theta[:, 1]),
        ici_bw=xp.exp(theta[:, 2]),
        ici_links=links,
        inter_pod_bw=xp.exp(theta[:, 3]),
        scale_compute=fixed.scale_compute,
        scale_memory=fixed.scale_memory,
        scale_interconnect=fixed.scale_interconnect,
    )


def _objective_terms(xp, p: K.ProfileArrays, m: K.MachineArrays, beta,
                     timing_model: str, eps: float, cost_model: CostModel,
                     w_area: float, w_power: float, app_weights=None):
    """Per-variant (V,) scalarized objective -- the differentiable core.

    ``app_weights`` (``(A, V)``, each column summing to 1 -- every workload
    group contributes weight ``1/n_groups`` spread over its members)
    replaces the plain mean over apps; the joint machine+variant descent
    uses it to select (hard) or mix (softmax) sharding variants of the
    same application.
    """
    out = K.congruence_kernel(xp, p, m, beta, timing_model, eps, clamp=False)
    if app_weights is None:
        fit = xp.mean(out.aggregate, axis=0)
    else:
        fit = xp.sum(app_weights * out.aggregate, axis=0)
    return fit + w_area * cost_model.area(m) + w_power * cost_model.power(m)


def theta_box(machines, span: float, optimize_links: bool = False,
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Seed log-rates and the span clip's feasible box, as ``(V, D)`` arrays.

    Returns ``(theta0, lo, hi)`` with one column per ``OPT_FIELDS`` entry
    plus, when ``optimize_links`` is set, a trailing ``log(ici_links)``
    column floored at ``log(1)`` (a pod link count cannot drop below one).
    """
    from repro_torch.core.sweep import _as_machine_batch
    mb = _as_machine_batch(machines)
    cols = [np.asarray(getattr(mb, f), dtype=np.float64) for f in OPT_FIELDS]
    if optimize_links:
        cols.append(np.asarray(mb.ici_links, dtype=np.float64))
    theta0 = np.log(np.stack(cols, axis=1))
    lo, hi = theta0 - np.log(span), theta0 + np.log(span)
    if optimize_links:
        lo[:, -1] = np.maximum(lo[:, -1], 0.0)
        theta0[:, -1] = np.maximum(theta0[:, -1], lo[:, -1])
    return theta0, lo, hi


def _to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _no_grad(fn: Optional[Callable]) -> Optional[Callable]:
    """``fn`` run without recording an autograd graph (``None`` stays)."""
    if fn is None:
        return None

    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def _grad_of_sum(obj_fn: Callable) -> Callable:
    """``theta -> d sum(obj_fn(theta, *args)) / d theta`` by autograd on a
    leaf copy of ``theta``."""
    def grad(theta, *args):
        with torch.enable_grad():
            leaf = theta.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(obj_fn(leaf, *args).sum(), leaf)
        return g
    return grad


def backtracking_descent(
    theta0, obj_fn: Callable, steps: int, lr, retract: Callable,
    aux_fn: Optional[Callable] = None,
    obj_args: Tuple = (), retract_args: Tuple = (),
    cache: Optional[Dict[str, Callable]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[np.ndarray], List[np.ndarray],
           torch.Tensor]:
    """Per-variant backtracking line search on ``obj_fn`` (shared by every
    co-design mode).

    ``theta0`` is a ``(V, D)`` tensor; ``obj_fn(theta, *obj_args)`` returns
    the ``(V,)`` per-variant objective.  ``retract`` maps a raw gradient
    candidate back onto the feasible set (the span-clip box for
    unconstrained descent, the budget projection of
    ``repro_torch.core.constrained`` for projected-gradient mode); it is
    applied AFTER the gradient step, so accepted iterates are always
    feasible.  ``aux_fn(theta) -> (V,)`` optionally records a per-step
    diagnostic (the constraint-violation trace).  ``lr`` may be a scalar or
    a ``(V,)`` per-variant array -- multi-round callers (the
    joint/Lagrangian outer loops) pass the previous round's adapted rates
    back in so restarts do not re-pay the warm-up.

    ``obj_args`` are extra positional arguments forwarded to
    ``obj_fn(theta, *obj_args)``; round-varying state (Lagrange
    multipliers, selection weights, softmax temperature) belongs there,
    not in a fresh closure per round.  ``retract_args`` do the same for
    ``retract(theta, *retract_args)``.  A ``cache`` dict (reused across
    calls WITH THE SAME ``obj_fn``/``retract``) keeps the objective, its
    gradient and the retraction between rounds.

    The gradient is ``torch.autograd.grad`` of the summed objective on a
    leaf copy of ``theta`` (the objective sums per-variant terms, so the
    gradient does not couple the variants); the objective, retraction and
    diagnostic run without a graph.  Returns the final ``theta``, final
    per-variant objective, the accepted-objective history (seed included),
    the aux history and the adapted per-variant ``lr``.
    """
    if torch.is_inference_mode_enabled():
        raise RuntimeError("backtracking_descent needs autograd; call it "
                           "outside torch.inference_mode()")
    cache = {} if cache is None else cache
    if "obj" not in cache:
        cache.update(obj=_no_grad(obj_fn), grad=_grad_of_sum(obj_fn),
                     retract=_no_grad(retract), aux=_no_grad(aux_fn))
    obj_c, grad_c = cache["obj"], cache["grad"]
    retract_c, aux_c = cache["retract"], cache["aux"]

    theta = retract_c(theta0, *retract_args)
    f_cur = obj_c(theta, *obj_args)
    lr_v = torch.as_tensor(lr, dtype=theta.dtype, device=theta.device
                           ).broadcast_to((theta.shape[0],))
    history = [_to_numpy(f_cur)]
    aux = [] if aux_c is None else [_to_numpy(aux_c(theta))]
    for _ in range(steps):
        g = grad_c(theta, *obj_args)
        cand = retract_c(theta - lr_v[:, None] * g, *retract_args)
        f_new = obj_c(cand, *obj_args)
        ok = f_new < f_cur
        theta = torch.where(ok[:, None], cand, theta)
        f_cur = torch.where(ok, f_new, f_cur)
        lr_v = torch.where(ok, lr_v * 1.2, lr_v * 0.5)
        history.append(_to_numpy(f_cur))
        if aux_c is not None:
            aux.append(_to_numpy(aux_c(theta)))
    return theta, f_cur, history, aux, lr_v


@dataclasses.dataclass
class CodesignResult:
    """Outcome of one gradient co-design run (all arrays per-variant).

    Every mode (unconstrained, projected, Lagrangian, joint) returns this
    one type; the feasibility fields are populated whenever a budget was in
    force and ``feasibility_report()`` renders them.  Doctest (fields are
    plain NumPy; no descent needed to exercise the accessors):

    >>> import numpy as np
    >>> r = CodesignResult(
    ...     names=["a", "b"], objective_seed=np.array([2.0, 3.0]),
    ...     objective_final=np.array([1.0, 2.5]),
    ...     seed_params=[{}, {}], final_params=[{}, {}],
    ...     trajectory=np.array([[2.0, 3.0], [1.0, 2.5]]), steps=1,
    ...     w_area=0.1, w_power=0.05)
    >>> r.best
    0
    >>> r.improvement.tolist()
    [1.0, 0.5]
    """

    names: List[str]
    objective_seed: np.ndarray       # (V,) J at the seed designs
    objective_final: np.ndarray      # (V,) J after descent
    seed_params: List[Dict[str, float]]
    final_params: List[Dict[str, float]]
    trajectory: np.ndarray           # (steps+1, V) accepted J per step
    steps: int
    w_area: float
    w_power: float
    # ---- co-design mode + feasibility report --------------------------- #
    mode: str = "unconstrained"      # unconstrained|projected|lagrangian|joint-*
    suffix: str = "+grad"            # appended to optimized variant names
    area_budget: Optional[float] = None
    power_budget: Optional[float] = None
    #: Per-subsystem area envelopes: rate field -> budget on
    #: ``CostModel.subsystem_area`` -- one extra constraint per entry.
    area_envelope: Optional[Dict[str, float]] = None
    area_final: Optional[np.ndarray] = None      # (V,) CostModel.area
    power_final: Optional[np.ndarray] = None     # (V,) CostModel.power
    feasible: Optional[np.ndarray] = None        # (V,) bool, None = no budget
    violation_trace: Optional[np.ndarray] = None  # (T, V) relative violation
    selection_names: Optional[List[List[str]]] = None  # joint: (V,)(G,) picks
    #: Augmented-Lagrangian shadow-price estimates: ``(V, C)``
    #: multipliers against the ABSOLUTE budgets, one column per
    #: ``constraint_names`` entry (cross-checkable against the implicit
    #: sensitivities of ``repro_torch.core.implicit``).  Lagrangian mode
    #: only.
    multipliers: Optional[np.ndarray] = None
    constraint_names: Optional[Tuple[str, ...]] = None

    @property
    def improvement(self) -> np.ndarray:
        """Per-variant objective decrease (positive = better)."""
        return self.objective_seed - self.objective_final

    @property
    def best(self) -> int:
        """Index of the best FEASIBLE variant (best overall if no budget)."""
        if self.feasible is not None and bool(np.any(self.feasible)):
            obj = np.where(self.feasible, self.objective_final, np.inf)
            return int(np.argmin(obj))
        return int(np.argmin(self.objective_final))

    def best_model(self) -> MachineModel:
        return self.models()[self.best]

    def models(self) -> List[MachineModel]:
        out = []
        for name, params in zip(self.names, self.final_params):
            out.append(MachineModel(
                name=f"{name}{self.suffix}",
                peak_flops=params["peak_flops"],
                hbm_bw=params["hbm_bw"],
                ici_bw=params["ici_bw"],
                ici_links=int(round(params["ici_links"])),
                inter_pod_bw=params["inter_pod_bw"],
                scale={"compute": params["scale_compute"],
                       "memory": params["scale_memory"],
                       "interconnect": params["scale_interconnect"]},
            ))
        return out

    def feasibility_report(self) -> dict:
        """Budgets, final (area, power) and per-variant feasibility.

        ``max_violation`` is the worst relative constraint violation seen
        along the descent (0.0 everywhere for projected mode, damped toward
        0 for Lagrangian -- the trace itself is in ``violation_trace``).
        """
        if (self.area_budget is None and self.power_budget is None
                and not self.area_envelope):
            return {"constrained": False, "mode": self.mode}
        rep = {
            "constrained": True,
            "mode": self.mode,
            "area_budget": self.area_budget,
            "power_budget": self.power_budget,
            "all_feasible": bool(np.all(self.feasible)),
            "variants": [
                {"name": f"{n}{self.suffix}",
                 "area": float(self.area_final[i]),
                 "power": float(self.power_final[i]),
                 "feasible": bool(self.feasible[i])}
                for i, n in enumerate(self.names)],
        }
        if self.area_envelope:
            rep["area_envelope"] = dict(self.area_envelope)
        if self.violation_trace is not None and len(self.violation_trace):
            rep["max_violation"] = float(np.max(self.violation_trace))
            rep["final_violation"] = float(np.max(self.violation_trace[-1]))
        if self.multipliers is not None:
            rep["shadow_prices"] = {
                c: [float(x) for x in self.multipliers[:, j]]
                for j, c in enumerate(self.constraint_names)}
        return rep

    def _variant_order(self, top_k: Optional[int]) -> List[int]:
        """Variant indices to report: all, or the ``top_k`` best by final
        objective (feasible variants first, matching ``best``'s tie-break;
        original seed order preserved within the kept set)."""
        if top_k is None:
            return list(range(len(self.names)))
        obj = np.asarray(self.objective_final, dtype=float)
        if self.feasible is not None:
            obj = np.where(np.asarray(self.feasible, bool), obj, np.inf)
        keep = sorted(range(len(self.names)),
                      key=lambda i: (float(obj[i]), i))[:top_k]
        return sorted(keep)

    def to_json(self, top_k: Optional[int] = None) -> dict:
        order = self._variant_order(top_k)
        blob = {
            "steps": self.steps,
            "mode": self.mode,
            "w_area": self.w_area,
            "w_power": self.w_power,
            "best_variant": f"{self.names[self.best]}{self.suffix}",
            "variants": [
                {"name": f"{self.names[i]}{self.suffix}",
                 "objective_seed": float(self.objective_seed[i]),
                 "objective_final": float(self.objective_final[i]),
                 "seed_params": self.seed_params[i],
                 "final_params": self.final_params[i]}
                for i in order],
        }
        if (self.area_budget is not None or self.power_budget is not None
                or self.area_envelope):
            blob["feasibility"] = self.feasibility_report()
        if self.selection_names is not None:
            blob["selection"] = {
                f"{self.names[i]}{self.suffix}": self.selection_names[i]
                for i in order}
        return blob

    def markdown(self, top_k: Optional[int] = None) -> str:
        """GitHub-flavoured summary table (the uniform result protocol:
        every sweep/co-design result renders via ``markdown``/``to_json``
        so the serving front door needs exactly one renderer)."""
        order = self._variant_order(top_k)
        has_budget = self.feasible is not None
        head = "| variant | J seed | J final | improvement |"
        rule = "|---|---|---|---|"
        if has_budget:
            head += " area | power | feasible |"
            rule += "---|---|---|"
        lines = [head, rule]
        for i in order:
            star = " *" if i == self.best else ""
            row = (f"| {self.names[i]}{self.suffix}{star} "
                   f"| {float(self.objective_seed[i]):.4f} "
                   f"| {float(self.objective_final[i]):.4f} "
                   f"| {float(self.improvement[i]):+.4f} |")
            if has_budget:
                row += (f" {float(self.area_final[i]):.3f} "
                        f"| {float(self.power_final[i]):.3f} "
                        f"| {'yes' if bool(self.feasible[i]) else 'NO'} |")
            lines.append(row)
        lines.append("")
        lines.append(f"mode: {self.mode}; steps: {self.steps}; "
                     f"best: {self.names[self.best]}{self.suffix}")
        return "\n".join(lines)


def params_of_theta(theta_row: np.ndarray, fixed_np: K.MachineArrays,
                    i: int) -> Dict[str, float]:
    """One variant's full parameter dict from a log-rate row + seed arrays."""
    d = {f: float(np.exp(theta_row[j])) for j, f in enumerate(OPT_FIELDS)}
    d["ici_links"] = (float(np.exp(theta_row[len(OPT_FIELDS)]))
                      if len(theta_row) == len(OPT_FIELDS) + 1
                      else float(fixed_np.ici_links[i]))
    d["scale_compute"] = float(fixed_np.scale_compute[i])
    d["scale_memory"] = float(fixed_np.scale_memory[i])
    d["scale_interconnect"] = float(fixed_np.scale_interconnect[i])
    return d


def resolve_beta(pb, mb, beta, beta_ref: int) -> np.ndarray:
    """The codesign beta convention: per-app default derived from variant
    ``beta_ref`` (frozen during descent -- the paper's beta is a user
    target, not a design variable), or an explicit scalar/(A,) target.

    The default is the shared math in NumPy float64 on the host, as the
    JAX package computes it, whatever device the descent runs on."""
    if beta is None:
        with np.errstate(divide="ignore", invalid="ignore"):
            return K.default_beta_kernel(np, pb.arrays(),
                                         mb.select(beta_ref).arrays())
    return np.broadcast_to(
        np.asarray(beta, dtype=np.float64), (len(pb),)).copy()


def scalarized_objective(
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
) -> np.ndarray:
    """Evaluate J for every variant (NumPy float64 on the host; ``(V,)``).

    Uses the same default-beta convention as ``batched_congruence``: when
    ``beta`` is None the per-app target derives from variant ``beta_ref``.
    """
    pb, mb = _as_batches(profiles, machines)
    beta = np.broadcast_to(
        np.asarray(resolve_beta(pb, mb, beta, beta_ref), dtype=np.float64),
        (len(pb),))
    with np.errstate(divide="ignore", invalid="ignore"):
        return _objective_terms(np, pb.arrays(), mb.arrays(), beta,
                                timing_model, eps, cost_model,
                                w_area, w_power)


def grad_codesign(
    profiles,
    machines,
    *,
    steps: int = 100,
    lr: float = 0.1,
    span: float = 16.0,
    beta=None,
    beta_ref: int = 0,
    timing_model: str = "serial",
    eps: float = K.IDEAL_EPS,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    w_area: float = 0.1,
    w_power: float = 0.05,
    device=K.DEFAULT_DEVICE,
) -> CodesignResult:
    """Descend J from a seed population by ``torch.autograd`` on log-rates.

    ``machines`` is the seed -- typically the named variants
    (``MachineBatch.from_models(VARIANTS)``) or a sweep's survivors
    (``SweepResult.seed_codesign()``); every seed design descends
    independently (the objective sums per-variant terms, so the gradient
    does not couple them).  ``beta`` follows the sweep convention (per-app
    default from variant ``beta_ref``, frozen during descent -- the paper's
    beta is a user target, not a design variable).

    Descent runs on the LOG of each rate; ``span`` clips ``log(rate)`` to
    ``[log(seed) - log(span), log(seed) + log(span)]`` -- i.e. the rate to
    ``[seed/span, seed*span]`` -- keeping designs inside a plausible
    process envelope.  That clip box is exactly the feasible box the
    constrained modes (``repro_torch.core.constrained``) intersect with the
    area/power budget set.  ``lr`` is the initial per-variant step on
    log-rates, adapted by backtracking (x1.2 on success, x0.5 on failure),
    so the accepted objective sequence is monotone non-increasing per
    variant.  The descent runs in float64 on ``device`` (``"cuda"`` by
    default; it raises without a card unless ``device="cpu"``).

    Example (descend the three named seeds for a few steps on the host):

    >>> from repro_torch.core import VARIANTS, WorkloadProfile, grad_codesign
    >>> from repro_torch.core.sweep import MachineBatch
    >>> apps = [WorkloadProfile(name="app0", flops=2e14, hbm_bytes=1.5e11,
    ...                         collective_bytes={"all-reduce": 2e10},
    ...                         num_devices=256, model_flops=5e16)]
    >>> cd = grad_codesign(apps, MachineBatch.from_models(VARIANTS), steps=3,
    ...                    device="cpu")
    >>> cd.names
    ['baseline', 'denser', 'densest']
    >>> bool((cd.improvement >= 0).all())     # backtracking never regresses
    True
    >>> cd.best_model().peak_flops > 0
    True
    >>> cd.mode
    'unconstrained'
    """
    backend = K.get_backend("torch", device)

    pb, mb = _as_batches(profiles, machines)
    fixed_np = mb.arrays()
    beta_np = resolve_beta(pb, mb, beta, beta_ref)
    theta0, lo, hi = theta_box(mb, span)

    p_arrays = backend.profile_arrays(pb.arrays())
    fixed = backend.machine_arrays(fixed_np)
    beta_t = backend.asarray(beta_np)
    lo_t, hi_t = backend.asarray(lo), backend.asarray(hi)

    def per_variant(theta):
        m = machine_arrays_from_theta(torch, theta, fixed)
        return _objective_terms(torch, p_arrays, m, beta_t, timing_model,
                                eps, cost_model, w_area, w_power)

    theta, f_cur, history, _, _ = backtracking_descent(
        backend.asarray(theta0), per_variant, steps, lr,
        retract=lambda th: torch.clamp(th, lo_t, hi_t))
    theta_np = backend.to_numpy(theta)
    f_final = backend.to_numpy(f_cur)

    final_m = machine_arrays_from_theta(np, theta_np, fixed_np)
    return CodesignResult(
        names=list(mb.names),
        objective_seed=np.asarray(history[0]),
        objective_final=np.asarray(f_final),
        seed_params=[params_of_theta(theta0[i], fixed_np, i)
                     for i in range(len(mb))],
        final_params=[params_of_theta(theta_np[i], fixed_np, i)
                      for i in range(len(mb))],
        trajectory=np.stack(history, axis=0),
        steps=steps,
        w_area=w_area,
        w_power=w_power,
        mode="unconstrained",
        area_final=np.asarray(cost_model.area(final_m)),
        power_final=np.asarray(cost_model.power(final_m)),
    )

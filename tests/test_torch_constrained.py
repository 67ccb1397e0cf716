"""Port budgeted and joint co-design (``repro_torch.core.constrained``,
``repro_torch.core.spec``) held against the JAX package on the same inputs,
with ``device="cpu"`` (float64 on the host).

* The projections (shift and Euclidean; area, power, both, envelopes,
  column masks, an infeasible budget) run with ``xp=torch`` and are held
  to the JAX package's NumPy ``project_to_budgets`` in this process.
* The descents (projected shift and Euclidean, Lagrangian,
  ``optimize_links``, envelopes, a ``CodesignSpec`` request, joint
  alternate / softmax) are held to the JAX package's, which runs once in
  one subprocess (``torch_codesign_reference.py``; ROADMAP.md R1).

Tolerances: objectives, trajectories and violation traces at rtol 1e-8;
final designs at 1e-6 (``THETA_RTOL``: a near-converged step may be
accepted by one package and rejected by the other, J equal to 1e-16);
names, feasibility flags, picks and report keys exactly.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import codesign as RCD
from repro.core import constrained as RC
from repro.core import spec as RSPEC
from repro.core.costmodel import CostModel as RefCostModel
from repro.core.sweep import MachineBatch as RefMachineBatch

import repro_torch.core as P
from repro_torch.core import codesign as PCD
from repro_torch.core import constrained as PC
from repro_torch.core import spec as PSPEC
from repro_torch.core.costmodel import DEFAULT_COST_MODEL, CostModel
from repro_torch.core.sweep import MachineBatch, ParamSpace
from test_constrained import _sharding_groups
from torch_codesign_reference import (
    machines_json,
    params_array,
    result_arrays,
    run_reference,
)

RTOL = 1e-8
THETA_RTOL = 1e-6
PROJ_RTOL = 1e-12    # one projection, float64, same operations
FEAS = PC.FEASIBLE_RTOL


def trio():
    from repro_torch.launch.sweep import synthetic_profiles

    return synthetic_profiles()


def suite(name):
    return trio() if name == "trio" else P.resolve_suite(name)


_SURVIVORS = {}


def seeds(name):
    named = MachineBatch.from_models(P.VARIANTS)
    if name == "named":
        return named
    if name == "survivors":   # of a gen:8 sweep of 2 003 variants
        if name not in _SURVIVORS:
            _SURVIVORS[name] = P.run_sweep("gen:8", n=2000, include_named=P.VARIANTS,
                                           device="cpu").seed_codesign()
        return _SURVIVORS[name]
    return MachineBatch.concat(named, ParamSpace.default().sample(5, seed=1))


def groups(n=3):
    """``tests/test_constrained.py``'s sharding-variant groups, as port
    profiles."""
    return [[P.WorkloadProfile.from_json(p.to_json()) for p in g]
            for g in _sharding_groups(n)]


def ref_machines(mb):
    return RefMachineBatch(names=list(mb.names), **{
        f: getattr(mb, f).copy() for f in
        ("peak_flops", "hbm_bw", "ici_bw", "ici_links", "inter_pod_bw",
         "scale_compute", "scale_memory", "scale_interconnect")})


# --------------------------------------------------------------------------- #
# The projections, in process against the JAX package's NumPy operator
# --------------------------------------------------------------------------- #

#: constraint set -> project_to_budgets keywords
BUDGETS = {
    "area": dict(area_budget=0.7),
    "power": dict(power_budget=0.9),
    "area+power": dict(area_budget=0.8, power_budget=1.0),
    "envelope": dict(area_envelope={"hbm_bw": 0.5, "peak_flops": 1.5}),
    "area+envelope": dict(area_budget=1.2,
                          area_envelope={"ici_bw_total": 0.6}),
    "infeasible": dict(area_budget=1e-4),
}


def _projection_inputs(seed, links=False):
    mb = seeds("mixed")
    theta0, lo, hi = PCD.theta_box(mb, 16.0, optimize_links=links)
    rng = np.random.default_rng(seed)
    # deliberately outside the span box too: the projection absorbs the clip
    theta = theta0 + rng.uniform(-4.0, 4.0, size=theta0.shape)
    return mb, theta, lo, hi


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _port_project(mb, theta, lo, hi, **kw):
    fixed = P.get_backend("torch", "cpu").machine_arrays(mb.arrays())
    out, ok = PC.project_to_budgets(torch, _t(theta), _t(lo), _t(hi), fixed,
                                    DEFAULT_COST_MODEL, **kw)
    return out.numpy(), ok.numpy()


def _ref_project(mb, theta, lo, hi, **kw):
    return RC.project_to_budgets(np, theta, lo, hi, ref_machines(mb).arrays(),
                                 RC.DEFAULT_COST_MODEL, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", ["shift", "euclidean"])
@pytest.mark.parametrize("budgets", BUDGETS)
def test_projection_matches_reference(budgets, method, seed):
    mb, theta, lo, hi = _projection_inputs(seed)
    kw = dict(BUDGETS[budgets], method=method)
    kw.setdefault("area_budget", None)
    got, ok = _port_project(mb, theta, lo, hi, **kw)
    want, ok_ref = _ref_project(mb, theta, lo, hi, **kw)
    np.testing.assert_array_equal(ok, ok_ref)
    np.testing.assert_allclose(got, want, rtol=PROJ_RTOL)
    # inside the box; within every constraint wherever the box's floor is
    # (the one flag the operator returns False is a floor out of reach)
    assert np.all(got >= lo) and np.all(got <= hi)

    def feasible(th):
        m = PCD.machine_arrays_from_theta(np, th, mb.arrays())
        return PC.budget_feasible(np, m, DEFAULT_COST_MODEL,
                                  kw["area_budget"], kw.get("power_budget"),
                                  area_envelope=kw.get("area_envelope"))

    np.testing.assert_array_equal(feasible(got), ok)
    np.testing.assert_array_equal(feasible(lo), ok)
    assert ok.any() == (budgets != "infeasible")


@pytest.mark.parametrize("method", ["shift", "euclidean"])
@pytest.mark.parametrize("budgets", ["area", "area+power", "envelope"])
def test_projection_is_idempotent_and_absorbs_the_clip(budgets, method):
    mb, theta, lo, hi = _projection_inputs(7)
    kw = dict(BUDGETS[budgets], method=method)
    kw.setdefault("area_budget", None)
    once, _ = _port_project(mb, theta, lo, hi, **kw)
    twice, _ = _port_project(mb, once, lo, hi, **kw)
    clipped_first, _ = _port_project(mb, np.clip(theta, lo, hi), lo, hi, **kw)
    np.testing.assert_array_equal(twice, once)
    np.testing.assert_array_equal(clipped_first, once)
    np.testing.assert_array_equal(np.clip(once, lo, hi), once)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("budgets", ["area", "area+power", "area+envelope"])
def test_masked_shift_matches_reference(budgets, seed):
    """The rounding repair's projection: 5-column theta (``log(ici_links)``
    last), the links column held by the mask."""
    mb, theta, lo, hi = _projection_inputs(seed, links=True)
    mask = np.array([True] * 4 + [False])
    kw = dict(BUDGETS[budgets], mask=mask)
    kw.setdefault("area_budget", None)
    got, ok = _port_project(mb, theta, lo, hi, **kw)
    want, ok_ref = _ref_project(mb, theta, lo, hi, **kw)
    np.testing.assert_array_equal(ok, ok_ref)
    np.testing.assert_allclose(got, want, rtol=PROJ_RTOL)
    np.testing.assert_array_equal(got[:, 4], np.clip(theta, lo, hi)[:, 4])


def test_euclidean_rejects_links_column_and_mask():
    mb, theta, lo, hi = _projection_inputs(0, links=True)
    with pytest.raises(ValueError, match="euclidean"):
        _port_project(mb, theta, lo, hi, area_budget=1.0, method="euclidean")
    with pytest.raises(ValueError, match="unknown projection method"):
        _port_project(mb, theta, lo, hi, area_budget=1.0, method="bogus")


# --------------------------------------------------------------------------- #
# The lines where torch differs from the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("budgets", ["area", "area+power", "area+envelope"])
def test_budget_violation_takes_tensors(budgets):
    """``xp.max(..., axis=1)`` gives a (values, indices) pair in torch; the
    port's ``xp.amax`` takes both namespaces alike."""
    mb, theta, lo, hi = _projection_inputs(3)
    kw = BUDGETS[budgets]
    args = (DEFAULT_COST_MODEL, kw.get("area_budget"), kw.get("power_budget"),
            kw.get("area_envelope"))
    m_np = PCD.machine_arrays_from_theta(np, theta, mb.arrays())
    fixed = P.get_backend("torch", "cpu").machine_arrays(mb.arrays())
    m_t = PCD.machine_arrays_from_theta(torch, _t(theta), fixed)
    got = PC.budget_violation(torch, m_t, *args)
    assert isinstance(got, torch.Tensor) and got.shape == (len(mb),)
    want = RC.budget_violation(np, RCD.machine_arrays_from_theta(
        np, theta, ref_machines(mb).arrays()), RC.DEFAULT_COST_MODEL, *args[1:])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)
    np.testing.assert_allclose(PC.budget_violation(np, m_np, *args), want,
                               rtol=1e-14)
    vec = PC.budget_violations_vector(torch, m_t, *args)
    assert bool((vec >= 0).all())


def test_shift_projection_on_tensors_returns_tensors():
    """The shift's ``t_floor`` (an ``xp.max`` over columns in the JAX
    package) on torch tensors: a tensor of the input's dtype."""
    mb, theta, lo, hi = _projection_inputs(4)
    fixed = P.get_backend("torch", "cpu").machine_arrays(mb.arrays())
    out, ok = PC.project_to_budgets(torch, _t(theta), _t(lo), _t(hi), fixed,
                                    DEFAULT_COST_MODEL, 0.7)
    assert out.dtype == torch.float64 and ok.dtype == torch.bool
    assert out.shape == theta.shape and bool(ok.all())


def test_mask_and_exponents_take_the_tensors_dtype():
    like = torch.zeros(3, dtype=torch.float64)
    mask = PC._asarray_like(np.array([True, False, True]), like)
    assert mask.dtype == torch.float64 and mask.tolist() == [1.0, 0.0, 1.0]
    got = PC._asarray_like([1.0, 1.5], np.zeros(2, dtype=np.float32))
    assert got.dtype == np.float32
    coeff, expo, off = PC._power_posynomial(
        torch, DEFAULT_COST_MODEL,
        P.get_backend("torch", "cpu").machine_arrays(seeds("named").arrays()))
    assert expo.dtype == coeff.dtype == torch.float64
    assert expo.tolist() == [1.5, 1.0, 1.0, 1.0] and off == 0.1


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_set_column_keeps_its_input(kind):
    a = np.arange(6.0).reshape(3, 2)
    a = torch.as_tensor(a) if kind == "tensor" else a
    b = PC._set_column(None, a, 1, a[:, 0] * 0 - 1)
    assert b[:, 1].tolist() == [-1.0, -1.0, -1.0]
    assert a[:, 1].tolist() == [1.0, 3.0, 5.0]


def test_iterate_is_a_plain_loop():
    seen = []
    out = PC._iterate(lambda i, s: seen.append(i) or s * 2, 1, 5)
    assert out == 32 and seen == [0, 1, 2, 3, 4]


# --------------------------------------------------------------------------- #
# The descents against the JAX package
# --------------------------------------------------------------------------- #

#: case -> (entry, suite or groups, seeds, keywords)
CASES = {
    "proj-area": ("constrained", "gen:8", "mixed",
                  dict(area_budget=1.0, steps=30)),
    "proj-area-power": ("constrained", "trio", "mixed",
                        dict(area_budget=0.8, power_budget=1.0, steps=20)),
    "lagr-area": ("constrained", "gen:8", "mixed",
                  dict(area_budget=1.0, mode="lagrangian", steps=30)),
    "lagr-envelope": ("constrained", "trio", "mixed",
                      dict(area_budget=1.2, area_envelope={"hbm_bw": 0.8},
                           mode="lagrangian", steps=24)),
    "eucl-area-power": ("constrained", "trio", "named",
                        dict(area_budget=0.8, power_budget=1.0,
                             projection="euclidean", steps=2)),
    "eucl-envelope": ("constrained", "gen:8", "mixed",
                      dict(area_envelope={"hbm_bw": 0.8, "peak_flops": 1.5},
                           projection="euclidean", steps=8)),
    "links": ("constrained", "trio", "named",
              dict(area_budget=0.55, steps=15, optimize_links=True)),
    "envelope-shift": ("constrained", "gen:8", "mixed",
                       dict(area_envelope={"hbm_bw": 0.8}, steps=20)),
    "spec": ("constrained", "trio", "mixed",
             dict(spec={"area_budget": 1.0, "power_budget": 1.2, "steps": 50,
                        "lr": 0.2}, steps=8)),
    "joint-alternate": ("joint", "groups", "named",
                        dict(mode="alternate", rounds=2, steps=9)),
    "joint-softmax": ("joint", "groups", "named",
                      dict(mode="softmax", rounds=2, steps=9)),
    "joint-budget": ("joint", "groups", "mixed",
                     dict(mode="alternate", area_budget=1.0, rounds=2,
                          steps=9)),
}


def _port_kwargs(kw):
    kw = dict(kw)
    if "spec" in kw:
        kw["spec"] = P.CodesignSpec.from_json(kw["spec"])
    return kw


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = {}
    for name, (entry, s, m, kw) in CASES.items():
        case = {"entry": entry, "machines": machines_json(seeds(m)),
                "kwargs": kw}
        if s == "groups":
            case["groups"] = [[p.to_json() for p in g] for g in groups()]
        else:
            case["profiles"] = [p.to_json() for p in suite(s)]
        cases[name] = case
    return run_reference(cases, tmp_path_factory.mktemp("ref_constrained"))


_PORT = {}


def port(name):
    if name not in _PORT:
        entry, s, m, kw = CASES[name]
        fn = {"constrained": P.constrained_codesign,
              "joint": P.joint_codesign}[entry]
        inputs = groups() if s == "groups" else suite(s)
        _PORT[name] = fn(inputs, seeds(m), device="cpu", **_port_kwargs(kw))
    return _PORT[name]


def assert_report_close(got, want, path="report"):
    """Equal structure and keys; floats at ``RTOL``, the rest exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_report_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_report_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=THETA_RTOL, atol=1e-15,
                                   err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("case", CASES)
def test_names_reports_and_picks_match_reference(reference, case):
    _, blob = reference[case]
    _, mine = result_arrays(port(case))
    mine = json.loads(json.dumps(mine))
    for key in ("names", "mode", "suffix", "best", "selection_names",
                "constraint_names"):
        assert mine[key] == blob[key], key
    assert_report_close(mine["feasibility_report"], blob["feasibility_report"])
    assert_report_close(mine["to_json"], blob["to_json"])


@pytest.mark.parametrize("case", CASES)
def test_objectives_and_trajectory_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    np.testing.assert_allclose(res.objective_seed, ref["objective_seed"],
                               rtol=RTOL)
    np.testing.assert_allclose(res.objective_final, ref["objective_final"],
                               rtol=RTOL)
    assert res.trajectory.shape == ref["trajectory"].shape
    np.testing.assert_allclose(res.trajectory, ref["trajectory"], rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_final_designs_and_feasibility_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    np.testing.assert_allclose(params_array(res.final_params),
                               ref["final_params"], rtol=THETA_RTOL)
    np.testing.assert_array_equal(params_array(res.seed_params),
                                  ref["seed_params"])
    for f in ("area_final", "power_final"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=THETA_RTOL)
    if res.feasible is None:
        assert "feasible" not in ref
    else:
        np.testing.assert_array_equal(res.feasible, ref["feasible"])
    if res.violation_trace is None:
        assert "violation_trace" not in ref
    else:
        np.testing.assert_allclose(res.violation_trace, ref["violation_trace"],
                                   rtol=RTOL, atol=1e-12)
    if res.multipliers is None:
        assert "multipliers" not in ref
    else:
        np.testing.assert_allclose(res.multipliers, ref["multipliers"],
                                   rtol=THETA_RTOL, atol=1e-12)


#: ROADMAP R12: two budgets, the winners end strictly inside both
INTERIOR = dict(area_budget=0.265, power_budget=0.265, projection="euclidean",
                steps=10, lr=30.0, w_area=0.0, w_power=0.0)


def test_two_budget_descent_ends_inside_both_budgets_as_the_reference_does(tmp_path):
    """ROADMAP R12, traced: from a gen:8 sweep's survivors (every seed above
    both budgets), a 10-step lr-30 descent with zero weights and the
    Euclidean projection onto area and power budgets of 0.265 leaves the
    best feasible design strictly inside both -- so its active set is empty
    -- in the JAX package and in the port alike (the designs agree to
    ``THETA_RTOL``).  The projection itself lands on the power budget
    (``test_projection_matches_reference``); the descent's accepted steps
    move the design inward and 10 steps stop it there."""
    surv = seeds("survivors")
    res = P.constrained_codesign(suite("gen:8"), surv, device="cpu", **INTERIOR)
    ref, _ = run_reference({"c": {
        "entry": "constrained", "machines": machines_json(surv),
        "profiles": [p.to_json() for p in suite("gen:8")],
        "kwargs": INTERIOR}}, tmp_path)["c"]
    for f in ("area_final", "power_final", "objective_final"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=THETA_RTOL)
    np.testing.assert_array_equal(res.feasible, ref["feasible"])
    best = int(np.argmin(np.where(res.feasible, res.objective_final, np.inf)))
    for got in (res, ref):
        area = got["area_final"] if isinstance(got, dict) else got.area_final
        power = got["power_final"] if isinstance(got, dict) else got.power_final
        assert area[best] < 0.265 * (1 - 1e-3) and power[best] < 0.265 * (1 - 1e-3)
    m0 = PCD.machine_arrays_from_theta(np, PCD.theta_box(seeds("survivors"), 16.0)[0],
                                       seeds("survivors").arrays())
    assert np.all(DEFAULT_COST_MODEL.area(m0) > 0.265)
    assert np.all(DEFAULT_COST_MODEL.power(m0) > 0.265)


@pytest.mark.parametrize("case", CASES)
def test_results_keep_their_budgets(case):
    """Every budgeted result within area / power / each envelope to
    ``FEASIBLE_RTOL``; integer ``ici_links`` >= 1; projected trajectories
    never rise; the Lagrangian violation trace is damped; the joint result
    never ends above its seed."""
    res = port(case)
    _, _, _, kw = CASES[case]
    kw = _port_kwargs(kw)
    if "spec" in kw:
        kw.update(area_budget=kw["spec"].area_budget,
                  power_budget=kw["spec"].power_budget)
    models = res.models()
    cm = DEFAULT_COST_MODEL
    for m in models:
        if kw.get("area_budget") is not None:
            assert cm.area(m) <= kw["area_budget"] * (1 + FEAS)
        if kw.get("power_budget") is not None:
            assert cm.power(m) <= kw["power_budget"] * (1 + FEAS)
        for field, b in (kw.get("area_envelope") or {}).items():
            assert cm.subsystem_area(m, field) <= b * (1 + FEAS)
        assert isinstance(m.ici_links, int) and m.ici_links >= 1
    if res.feasible is not None:
        assert res.feasible.all()
    if res.mode == "projected" and not kw.get("optimize_links"):
        assert np.all(np.diff(res.trajectory, axis=0) <= 1e-12)
        # zero, up to the envelope caps' exp(log(cap)) round trip
        assert np.all(res.violation_trace <= FEAS)
    if res.mode == "lagrangian":
        assert np.all(np.diff(res.violation_trace.max(axis=1)) <= 1e-12)
    if res.mode.startswith("joint"):
        assert np.all(res.improvement >= 0)


def test_spec_fills_unset_keywords_and_explicit_ones_win():
    """``spec=`` fills the budgets and ``lr`` but the explicit ``steps=8``
    wins over the spec's 50."""
    res = port("spec")
    assert res.steps == 8 and res.trajectory.shape[0] == 9
    assert res.area_budget == 1.0 and res.power_budget == 1.2
    direct = P.constrained_codesign(trio(), seeds("mixed"), area_budget=1.0,
                                    power_budget=1.2, lr=0.2, steps=8,
                                    device="cpu")
    np.testing.assert_array_equal(direct.trajectory, res.trajectory)


# --------------------------------------------------------------------------- #
# CodesignSpec
# --------------------------------------------------------------------------- #


def _full_spec(pkg):
    cm_cls = CostModel if pkg is PSPEC else RefCostModel
    return pkg.CodesignSpec(
        area_budget=1.0, power_budget=1.3, area_envelope={"hbm_bw": 0.8},
        budgets=(0.5, 1.0), mode="lagrangian", projection="euclidean",
        steps=7, lr=0.2, span=8.0, optimize_links=False, w_area=0.2,
        beta=0.5, timing_model="overlap",
        cost_model=cm_cls(area_weights={"peak_flops": 2.0, "hbm_bw": 1.0}),
        backend="torch" if pkg is PSPEC else "numpy", n=64, suite="gen:8")


def test_spec_json_round_trip_matches_reference():
    spec = _full_spec(PSPEC)
    blob = spec.to_json()
    assert P.CodesignSpec.from_json(json.loads(json.dumps(blob))) == spec
    ref = _full_spec(RSPEC).to_json()
    ref["backend"] = "torch"
    assert blob == ref
    assert spec.validate().budgets == (0.5, 1.0)


@pytest.mark.parametrize("field,value,match", [
    ("projection", "bogus", "unknown projection"),
    ("mode", "annealed", "unknown mode"),
    ("sweep_mode", "lhs", "unknown sweep_mode"),
    ("area_budget", 0.0, "area_budget must be positive"),
    ("steps", 0, "steps must be positive"),
    ("split0", 1.5, "split0 must lie strictly inside"),
    ("area_envelope", {"mxu_count": 1.0}, "unknown area_envelope field"),
    ("budgets", [], "at least one budget"),
    ("budgets", [1.0, -2.0], "budgets must be positive"),
    ("suite", "gen:-3", None),
])
def test_spec_validation_rejects_what_the_reference_rejects(field, value,
                                                            match):
    with pytest.raises(ValueError, match=match) as mine:
        P.CodesignSpec(**{field: value}).validate()
    with pytest.raises(ValueError) as theirs:
        RSPEC.CodesignSpec(**{field: value}).validate()
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("backend", ["cuda", "torch", None])
def test_spec_validates_the_ports_backend_names(backend):
    assert P.CodesignSpec(backend=backend).validate().backend == backend


@pytest.mark.parametrize("backend", ["jax", "numpy", "pallas"])
def test_spec_rejects_the_jax_packages_backend_names(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        P.CodesignSpec(backend=backend).validate()


def test_spec_unknown_field_and_resolution_order():
    with pytest.raises(ValueError, match="unknown CodesignSpec fields"):
        P.CodesignSpec.from_json({"steps": 3, "bogus": 1})
    spec = P.CodesignSpec(steps=5, lr=0.3)
    got = P.resolve_spec(spec, dict(steps=100, lr=0.1, span=16.0),
                         dict(steps=7, lr=None, span=None))
    assert got == dict(steps=7, lr=0.3, span=16.0)


# --------------------------------------------------------------------------- #
# Devices
# --------------------------------------------------------------------------- #

DEFAULT_CALLS = {
    "projected": dict(area_budget=1.0),
    "lagrangian": dict(area_budget=1.0, mode="lagrangian"),
    "euclidean": dict(area_budget=1.0, power_budget=1.2,
                      projection="euclidean"),
    "optimize_links": dict(area_budget=1.0, optimize_links=True),
    "area_envelope": dict(area_envelope={"hbm_bw": 0.8}),
    "joint-alternate": dict(mode="alternate"),
    "joint-softmax": dict(mode="softmax"),
}


@pytest.mark.parametrize("call", DEFAULT_CALLS)
def test_default_device_is_the_card(call):
    """Without ``device=`` every mode asks for the card; on a host without
    one it raises instead of running on the CPU."""
    kw = dict(DEFAULT_CALLS[call], steps=2)
    if call.startswith("joint"):
        run = lambda: P.joint_codesign(groups(2), seeds("named"), rounds=1,
                                       **kw)
    else:
        run = lambda: P.constrained_codesign(trio(), seeds("named"), **kw)
    if torch.cuda.is_available():
        assert len(run().names) == 3
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_descent_on_card_matches_cpu(case):
    """The same descent in float64 on the card: same names, picks and
    feasibility, final objectives within 1e-6 of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the descents' default device")
    entry, s, m, kw = CASES[case]
    fn = {"constrained": P.constrained_codesign,
          "joint": P.joint_codesign}[entry]
    inputs = groups() if s == "groups" else suite(s)
    card = fn(inputs, seeds(m), device="cuda", **_port_kwargs(kw))
    host = port(case)
    assert card.names == host.names
    assert card.selection_names == host.selection_names
    np.testing.assert_allclose(card.objective_final, host.objective_final,
                               rtol=1e-6)
    if host.feasible is not None:
        np.testing.assert_array_equal(card.feasible, host.feasible)

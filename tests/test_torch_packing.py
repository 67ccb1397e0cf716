"""The port's multi-tenant packing (``repro_torch.core.packing``) held
against the JAX package's on the same inputs, with ``device="cpu"``
(float64 on the host).

* ``_pack_weights`` / ``_soft_weights``, ``fleet_objective`` and the
  fleet-total shift (``_fleet_shift``, torch here, the JAX package's with
  ``xp=numpy``) are held in this process.
* The descents run once per case in the JAX package in one subprocess
  (``torch_codesign_reference.py``; ROADMAP.md R1).

Tolerances, as ``test_torch_constrained.py``: objectives and trajectories
at rtol 1e-8; designs, areas and per-app aggregates at 1e-6; the
assignment, names and feasibility exactly; budgets and envelopes met to
``FEASIBLE_RTOL`` (1e-9).
"""

import numpy as np
import pytest
import torch

from repro.core import packing as RPK
from repro.core.sweep import MachineBatch as RefMachineBatch

import repro_torch.core as P
from repro_torch.core import codesign as PCD
from repro_torch.core import packing as PPK
from repro_torch.core.constrained import FEASIBLE_RTOL, budget_feasible
from repro_torch.core.costmodel import DEFAULT_COST_MODEL
from repro_torch.core.sweep import MachineBatch, ParamSpace
from torch_codesign_reference import (
    MACHINE_FIELDS,
    assert_blob_close,
    json_round_trip,
    machines_json,
    packing_arrays,
    params_array,
    run_reference,
)

RTOL = 1e-8
THETA_RTOL = 1e-6
BETA = 1.5   # one explicit target for every fleet compared


def seeds(name):
    named = MachineBatch.from_models(P.VARIANTS)
    if name == "named":
        return named
    return MachineBatch.concat(named, ParamSpace.default().sample(5, seed=1))


def ref_machines(mb):
    return RefMachineBatch(names=list(mb.names),
                           **{f: getattr(mb, f).copy() for f in MACHINE_FIELDS})


_SMALL = dict(num_machines=2, rounds=2, steps=6, beta=BETA)

#: case -> (suite, seeds, keywords)
CASES = {
    "alternate": ("gen:6", "named", dict(_SMALL)),
    "alternate-long": ("gen:6", "named", dict(_SMALL, steps=12, rounds=3)),
    "softmax": ("gen:6", "named",
                dict(_SMALL, mode="softmax", steps=12, rounds=3)),
    "area-budget": ("gen:6", "named", dict(_SMALL, area_budget=1.8)),
    "envelope": ("gen:6", "named",
                 dict(_SMALL, area_budget=1.8,
                      area_envelope={"peak_flops": 1.2, "hbm_bw": 0.9})),
    "power-budget": ("gen:8", "mixed",
                     dict(_SMALL, num_machines=3, power_budget=2.5)),
    "schedule": ("gen:6", "named", dict(_SMALL, budgets=[0.9, 1.4, 2.4])),
    "spec": ("gen:6", "named",
             dict(rounds=2, spec={"num_machines": 3, "steps": 4,
                                  "mode": "alternate", "beta": BETA})),
    # the acceptance configuration: 32 generated apps x 4 machines
    "acceptance": ("gen:32", "named",
                   dict(num_machines=4, steps=30, beta=BETA,
                        area_budget=2.0)),
}


def _port_kwargs(kw):
    kw = dict(kw)
    if "spec" in kw:
        kw["spec"] = P.CodesignSpec.from_json(kw["spec"])
    return kw


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = {name: {"entry": "pack",
                    "profiles": [p.to_json() for p in P.resolve_suite(s)],
                    "machines": machines_json(seeds(m)), "kwargs": kw}
             for name, (s, m, kw) in CASES.items()}
    return run_reference(cases, tmp_path_factory.mktemp("ref_packing"))


_PORT = {}


def port(name):
    if name not in _PORT:
        s, m, kw = CASES[name]
        _PORT[name] = P.pack_codesign(s, seeds(m), device="cpu",
                                      **_port_kwargs(kw))
    return _PORT[name]


@pytest.mark.parametrize("case", CASES)
def test_assignment_names_and_reports_match_reference(reference, case):
    res = port(case)
    ref, blob = reference[case]
    np.testing.assert_array_equal(res.assignment, ref["assignment"])
    _, mine = packing_arrays(res)
    mine = json_round_trip(mine)
    for key in ("app_names", "machine_names", "feasible", "mode",
                "markdown"):
        assert mine[key] == blob[key], key
    assert_blob_close(mine["to_json"], blob["to_json"], THETA_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_objectives_and_trajectory_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    for f in ("objective_seed", "objective_final"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=RTOL)
    assert res.trajectory.shape == ref["trajectory"].shape
    np.testing.assert_allclose(res.trajectory, ref["trajectory"], rtol=RTOL)
    if res.budgets is None:
        assert "budgets" not in ref
    else:
        np.testing.assert_array_equal(res.budgets, ref["budgets"])
        np.testing.assert_allclose(res.frontier_objective,
                                   ref["frontier_objective"], rtol=RTOL)
        np.testing.assert_array_equal(res.frontier_feasible,
                                      ref["frontier_feasible"])
        np.testing.assert_allclose(res.frontier_area, ref["frontier_area"],
                                   rtol=THETA_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_fleet_designs_match_reference(reference, case):
    res = port(case)
    ref, blob = reference[case]
    np.testing.assert_array_equal(params_array(res.seed_params),
                                  ref["seed_params"])
    np.testing.assert_allclose(params_array(res.final_params),
                               ref["final_params"], rtol=THETA_RTOL)
    for f in ("area_total", "power_total", "per_app_aggregate"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=THETA_RTOL)
    # the reported objective IS the yardstick objective, in both packages
    s, _, kw = CASES[case]
    j = P.fleet_objective(s, res.machines, beta=BETA)
    np.testing.assert_allclose(j, blob["fleet_objective"], rtol=THETA_RTOL)
    if kw.get("budgets") is None:
        assert res.objective_final == pytest.approx(j, rel=1e-9)


@pytest.mark.parametrize("case", CASES)
def test_budgets_envelopes_and_monotonicity(case):
    """The fleet total within its budget and every instance within its
    envelopes to 1e-9; alternation never rises; softmax never ends above
    its seed; the assignment is the argmin of the final fleet."""
    res = port(case)
    _, _, kw = CASES[case]
    kw = _port_kwargs(kw)
    if kw.get("area_budget") is not None:
        assert res.area_total <= kw["area_budget"] * (1 + FEASIBLE_RTOL)
    if kw.get("power_budget") is not None:
        assert res.power_total <= kw["power_budget"] * (1 + FEASIBLE_RTOL)
    if kw.get("area_envelope"):
        ok = budget_feasible(np, res.machines.arrays(), DEFAULT_COST_MODEL,
                             None, None, area_envelope=kw["area_envelope"])
        assert ok.all()
    if res.feasible is not None:
        assert res.feasible is True
    if res.mode == "alternate":
        assert (np.diff(res.trajectory) <= 1e-9).all()
    assert res.objective_final <= res.objective_seed + 1e-9
    names = sum((res.apps_on(i) for i in range(len(res.machines))), [])
    assert sorted(names) == sorted(res.app_names)


def test_pack_beats_uniform_fleet():
    """The acceptance: 32 generated apps packed on 4 machines under one
    fleet-total area budget beat 4 replicas of the best single machine
    ``constrained_codesign`` finds at a quarter of the budget, on the
    exact fleet objective."""
    apps = P.resolve_suite("gen:32")
    m, budget = 4, 2.0
    uni = P.constrained_codesign(apps, seeds("named"), steps=30, beta=BETA,
                                 area_budget=budget / m, device="cpu")
    uniform = MachineBatch.from_models([uni.best_model()] * m)
    j_uniform = P.fleet_objective(apps, uniform, beta=BETA)
    res = port("acceptance")
    j_pack = P.fleet_objective(apps, res.machines, beta=BETA)
    assert j_pack < j_uniform, (j_pack, j_uniform)
    assert res.area_total <= budget * (1 + FEASIBLE_RTOL)
    assert len(res.assignment) == 32 and len(res.machines) == m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_weights_match_reference(seed):
    agg = np.random.default_rng(seed).uniform(0.1, 2.0, size=(7, 4))
    np.testing.assert_array_equal(PPK._pack_weights(agg),
                                  RPK._pack_weights(agg))
    for temp in (1.0, 0.3, 1e-3, 0.0):
        w = PPK._soft_weights(agg, temp)
        np.testing.assert_allclose(w, RPK._soft_weights(agg, temp),
                                   rtol=1e-15)
        np.testing.assert_allclose(w.sum(axis=1), 1.0 / 7, rtol=1e-12)


#: fleet-total budgets for the shift: (area, power); the mixed fleet's
#: box floor sums to area 1.01, power 1.71
SHIFTS = {"area": (1.5, None), "power": (None, 4.0), "both": (3.0, 4.0),
          "slack": (50.0, None), "infeasible": (1e-4, 1.7)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("budgets", SHIFTS)
def test_fleet_shift_matches_reference(budgets, seed):
    mb = seeds("mixed")
    theta0, lo, hi = PCD.theta_box(mb, 16.0)
    theta = np.clip(theta0 + np.random.default_rng(seed).uniform(
        -1.0, 2.0, size=theta0.shape), lo, hi)
    area, power = SHIFTS[budgets]
    fixed = P.get_backend("torch", "cpu").machine_arrays(mb.arrays())
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    got = PPK._fleet_shift(t(theta), t(lo), fixed, DEFAULT_COST_MODEL, area,
                           power).numpy()
    want = RPK._fleet_shift(np, theta, lo, ref_machines(mb).arrays(),
                            RPK.DEFAULT_COST_MODEL, area, power)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.all(got >= lo) and np.all(got <= theta)
    m = PCD.machine_arrays_from_theta(np, got, mb.arrays())
    if budgets != "infeasible":
        assert PPK._fleet_feasible(m, DEFAULT_COST_MODEL, area, power, None)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("suite", ["gen:6", "gen:12"])
def test_fleet_objective_matches_reference(suite, seed):
    fleet = ParamSpace.default().sample(3, seed=seed)
    got = P.fleet_objective(suite, fleet, w_area=0.2)
    want = RPK.fleet_objective(suite, ref_machines(fleet), w_area=0.2)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("kw", [
    dict(mode="bogus"), dict(num_machines=0), dict(area_budget=-1.0),
    dict(budgets=[1.0, 2.0], area_budget=1.5), dict(budgets=[]),
    dict(area_envelope={"mxu_count": 1.0}),
], ids=["mode", "machines", "budget", "exclusive", "schedule", "envelope"])
def test_validation_matches_reference(kw):
    with pytest.raises(ValueError) as mine:
        P.pack_codesign("gen:4", seeds("named"), device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        RPK.pack_codesign("gen:4", ref_machines(seeds("named")), **kw)
    assert str(mine.value) == str(theirs.value)


def test_pack_needs_a_seed_machine():
    with pytest.raises(ValueError, match="seed machine"):
        P.pack_codesign("gen:4", MachineBatch.from_models([]),
                        num_machines=2, device="cpu")


def test_default_device_is_the_card():
    run = lambda: P.pack_codesign("gen:4", seeds("named"), **_SMALL)
    if torch.cuda.is_available():
        assert len(run().machines) == 2
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_pack_on_card_matches_cpu(case):
    """The same packing in float64 on the card: the same assignment and
    machine names, the final objective within 1e-6 of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: packing's default device")
    s, m, kw = CASES[case]
    card = P.pack_codesign(s, seeds(m), device="cuda", **_port_kwargs(kw))
    host = port(case)
    np.testing.assert_array_equal(card.assignment, host.assignment)
    assert card.machine_names == host.machine_names
    assert card.objective_final == pytest.approx(host.objective_final,
                                                 rel=1e-6)

"""The port's feasibility frontier (``repro_torch.core.frontier``) held
against the JAX package's on the same inputs, with ``device="cpu"``
(float64 on the host).

The JAX package's ``frontier_codesign`` runs once per case in one
subprocess (``torch_codesign_reference.py``; ROADMAP.md R1).  Tolerances,
as ``test_torch_constrained.py``: objectives at rtol 1e-8; designs, areas,
the continuation state and the implicit sensitivities at 1e-6; budgets,
names and feasibility exactly.  The validation paths raise before the JAX
package builds a backend, so they are held in this process.
"""

import numpy as np
import pytest
import torch

from repro.core import frontier as RF

import repro_torch.core as P
from repro_torch.core import frontier as PF
from repro_torch.core.constrained import FEASIBLE_RTOL
from repro_torch.core.costmodel import DEFAULT_COST_MODEL
from repro_torch.core.sweep import MachineBatch, ParamSpace
from torch_codesign_reference import (
    assert_blob_close,
    frontier_arrays,
    json_round_trip,
    machines_json,
    params_array,
    resume_pick,
    run_reference,
)

RTOL = 1e-8
THETA_RTOL = 1e-6


def trio():
    from repro_torch.launch.sweep import synthetic_profiles

    return synthetic_profiles()


def suite(name):
    return trio() if name == "trio" else P.resolve_suite(name)


def seeds(name):
    named = MachineBatch.from_models(P.VARIANTS)
    if name == "named":
        return named
    return MachineBatch.concat(named, ParamSpace.default().sample(5, seed=1))


#: case -> (suite, seeds, keywords, schedule resumed from the case's state)
CASES = {
    # 0.05 sits below the span box's area floor: an infeasible floor row
    "trio-named": ("trio", "named",
                   dict(budgets=[0.05, 0.15, 0.25, 0.5], steps=30), None),
    "gen8-mixed": ("gen:8", "mixed",
                   dict(budgets=[0.3, 0.6, 1.2], steps=20), None),
    "euclidean-power-envelope": (
        "trio", "mixed",
        dict(budgets=[0.15, 0.3, 0.6], power_budget=1.0,
             area_envelope={"hbm_bw": 0.8}, projection="euclidean",
             steps=6), None),
    "cold": ("trio", "named",
             dict(budgets=[0.1, 0.2, 0.4], warm_start=False, steps=10), None),
    "spec": ("trio", "mixed",
             dict(spec={"budgets": [0.2, 0.4], "steps": 12, "lr": 0.2},
                  steps=8), None),
    "keep-state": ("gen:8", "named",
                   dict(budgets=[0.2, 0.5], steps=10, keep_state=True), None),
    "resume": ("trio", "named",
               dict(budgets=[0.2, 0.4], steps=10, keep_state=True),
               [0.1, 0.15]),
    "no-sensitivities": ("trio", "named",
                         dict(budgets=[0.15, 0.3], steps=10,
                              sensitivities=False), None),
}


def _port_kwargs(kw):
    kw = dict(kw)
    if "spec" in kw:
        kw["spec"] = P.CodesignSpec.from_json(kw["spec"])
    return kw


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = {}
    for name, (s, m, kw, resume) in CASES.items():
        cases[name] = {"entry": "frontier",
                       "profiles": [p.to_json() for p in suite(s)],
                       "machines": machines_json(seeds(m)), "kwargs": kw}
        if resume is not None:
            cases[name]["resume"] = resume
    return run_reference(cases, tmp_path_factory.mktemp("ref_frontier"))


_PORT = {}


def port(name):
    """The port's frontier of ``name`` (a resumed case: its second trace,
    warm-started the way the reference harness does)."""
    if name not in _PORT:
        s, m, kw, resume = CASES[name]
        kw = _port_kwargs(kw)
        res = P.frontier_codesign(suite(s), seeds(m), device="cpu", **kw)
        if resume is not None:
            pick = resume_pick(res.continuation, resume)
            kw.update(budgets=resume, warm_theta=res.continuation[pick],
                      warm_lr=res.final_lr)
            res = P.frontier_codesign(suite(s), seeds(m), device="cpu", **kw)
        _PORT[name] = res
    return _PORT[name]


@pytest.mark.parametrize("case", CASES)
def test_names_and_reports_match_reference(reference, case):
    _, blob = reference[case]
    _, mine = frontier_arrays(port(case))
    mine = json_round_trip(mine)
    for key in ("best_names", "seed_names", "steps", "refine_steps",
                "warm_start", "sensitivity_constraints", "markdown"):
        assert mine[key] == blob[key], key
    assert_blob_close(mine["to_json"], blob["to_json"], THETA_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_objectives_and_feasibility_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    np.testing.assert_array_equal(res.budgets, ref["budgets"])
    np.testing.assert_array_equal(res.feasible, ref["feasible"])
    np.testing.assert_allclose(res.objective, ref["objective"], rtol=RTOL)
    np.testing.assert_allclose(res.per_seed_objective,
                               ref["per_seed_objective"], rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_designs_and_continuation_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    np.testing.assert_allclose(params_array(res.best_params),
                               ref["best_params"], rtol=THETA_RTOL)
    for f in ("area", "power"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=THETA_RTOL)
    if res.continuation is None:
        assert "continuation" not in ref and "final_lr" not in ref
    else:
        got = np.stack([res.continuation[b] for b in sorted(res.continuation)])
        np.testing.assert_allclose(got, ref["continuation"], rtol=THETA_RTOL)
        np.testing.assert_allclose(res.final_lr, ref["final_lr"],
                                   rtol=THETA_RTOL)
        # host arrays: a cached continuation holds no device memory
        assert all(isinstance(t, np.ndarray)
                   for t in res.continuation.values())
        assert isinstance(res.final_lr, np.ndarray)


@pytest.mark.parametrize("case", CASES)
def test_sensitivities_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    if res.dJ_dbudget is None:
        assert "dJ_dbudget" not in ref and "shadow_prices" not in ref
        return
    for f in ("dJ_dbudget", "shadow_prices"):
        got, want = getattr(res, f), ref[f]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=THETA_RTOL, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_frontier_contract(case):
    """Feasible points meet their budgets (and the fixed power budget and
    envelopes) to 1e-9, J* never rises with the budget across them, and
    the price of area is <= 0 there and NaN on infeasible floor rows."""
    res = port(case)
    feas = res.feasible
    assert np.all(np.diff(res.budgets) > 0)
    assert np.all(res.area[feas] <= res.budgets[feas] * (1 + FEASIBLE_RTOL))
    assert np.all(np.diff(res.objective[feas]) <= 1e-12)
    _, _, kw, _ = CASES[case]
    for i in np.nonzero(feas)[0]:
        m = res.best_model(i)
        if kw.get("power_budget") is not None:
            assert DEFAULT_COST_MODEL.power(m) <= kw["power_budget"] * (
                1 + FEASIBLE_RTOL)
        for field, b in (kw.get("area_envelope") or {}).items():
            assert DEFAULT_COST_MODEL.subsystem_area(m, field) <= b * (
                1 + FEASIBLE_RTOL)
    if res.dJ_dbudget is not None:
        assert np.all(res.dJ_dbudget[feas] <= 0.0)
        assert np.all(np.isnan(res.dJ_dbudget[~feas]))


def test_the_binding_case_prices_area(reference):
    """The trio under budget 0.15 binds: a negative dJ*/db, equal to the
    JAX package's (the zero prices of slack rows alone would not show the
    multiplier solve agrees)."""
    res = port("trio-named")
    assert not res.feasible[0] and res.feasible[1:].all()
    assert res.dJ_dbudget[1] < -1e-3
    ref, _ = reference["trio-named"]
    np.testing.assert_allclose(res.dJ_dbudget[1], ref["dJ_dbudget"][1],
                               rtol=THETA_RTOL)


def test_best_at_and_knee_match_reference(reference):
    res = port("trio-named")
    ref, blob = reference["trio-named"]
    assert res.knee() == blob["to_json"]["knee"]
    budgets, feasible = ref["budgets"], ref["feasible"]
    i = max(j for j in range(len(budgets))
            if budgets[j] <= 0.3 and feasible[j])
    m = res.best_at(0.3)
    assert m.name == f"{blob['best_names'][i]}+frontier@{budgets[i]:g}"
    assert DEFAULT_COST_MODEL.area(m) <= 0.3 * (1 + FEASIBLE_RTOL)
    with pytest.raises(ValueError, match="no feasible frontier point"):
        res.best_at(1e-6)


def test_knee_of_a_flat_frontier_is_its_tightest_feasible_budget():
    kw = dict(budgets=np.array([0.5, 1.0, 2.0]),
              objective=np.array([1.0, 1.0, 1.0]),
              best_names=["a"] * 3, best_params=[{}] * 3,
              area=np.array([0.4, 0.4, 0.4]), power=np.array([0.5] * 3),
              feasible=np.array([True] * 3),
              per_seed_objective=np.ones((3, 1)), seed_names=["a"],
              steps=1, refine_steps=1, warm_start=True)
    assert PF.FrontierResult(**kw).knee() == RF.FrontierResult(**kw).knee() == 0.5


@pytest.mark.parametrize("sharded", [False, True], ids=["run_sweep",
                                                        "shard_sweep"])
def test_sweep_frontier_bridge(sharded):
    """``SweepResult.frontier`` / ``ShardedSweepResult.frontier`` trace the
    frontier from the sweep's survivors: the same names and values as
    ``frontier_codesign`` called on them."""
    apps = trio()
    if sharded:
        res = P.shard_sweep(apps, n=64, seed=9, include_named=P.VARIANTS,
                            num_shards=4, device="cpu")
        survivors = res.seed_codesign(k=3)
    else:
        res = P.run_sweep(apps, n=64, seed=9, include_named=P.VARIANTS,
                          device="cpu")
        survivors = res.seed_codesign(k=3)
    fr = res.frontier([0.4, 1.0], k=3, steps=3, refine_steps=1, device="cpu")
    direct = P.frontier_codesign(apps, survivors, [0.4, 1.0], steps=3,
                                 refine_steps=1, device="cpu")
    assert fr.seed_names == direct.seed_names == list(survivors.names)
    assert fr.best_names == direct.best_names
    np.testing.assert_array_equal(fr.objective, direct.objective)
    np.testing.assert_array_equal(params_array(fr.best_params),
                                  params_array(direct.best_params))


@pytest.mark.parametrize("budgets", [[3.0, 1.0, 2.0, 2.0], (0.5,), [1, 2.5]])
def test_budget_schedule_normalization_matches_reference(budgets):
    assert (PF._validate_budget_schedule(budgets)
            == RF._validate_budget_schedule(budgets))


@pytest.mark.parametrize("kw", [
    dict(budgets=None),
    dict(budgets=[]),
    dict(budgets=[1.0, -2.0]),
    dict(budgets=[1.0, "x"]),
    dict(budgets=5.0),
    dict(budgets=[1.0], power_budget=-1.0),
    dict(budgets=[1.0], area_envelope={"mxu_count": 1.0}),
], ids=["none", "empty", "negative", "not-a-number", "not-iterable",
        "power", "envelope"])
def test_validation_matches_reference(kw):
    from repro.core.sweep import MachineBatch as RefMachineBatch

    with pytest.raises(ValueError) as mine:
        P.frontier_codesign(trio(), seeds("named"), device="cpu", **kw)
    ref_seeds = RefMachineBatch(**{
        f: getattr(seeds("named"), f) for f in
        ("names", "peak_flops", "hbm_bw", "ici_bw", "ici_links",
         "inter_pod_bw", "scale_compute", "scale_memory",
         "scale_interconnect")})
    with pytest.raises(ValueError) as theirs:
        RF.frontier_codesign([], ref_seeds, **kw)
    assert str(mine.value) == str(theirs.value)


def test_default_device_is_the_card():
    """Without ``device=`` the frontier asks for the card; on a host
    without one it raises instead of running on the CPU."""
    run = lambda: P.frontier_codesign(trio(), seeds("named"), [0.3],
                                      steps=2)
    if torch.cuda.is_available():
        assert len(run()) == 1
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_frontier_on_card_matches_cpu(case):
    """The same trace in float64 on the card: the same names and
    feasibility, J* within 1e-6 of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the frontier's default device")
    s, m, kw, _ = CASES[case]
    card = P.frontier_codesign(suite(s), seeds(m), device="cuda",
                               **_port_kwargs(kw))
    host = P.frontier_codesign(suite(s), seeds(m), device="cpu",
                               **_port_kwargs(kw))
    assert card.best_names == host.best_names
    np.testing.assert_array_equal(card.feasible, host.feasible)
    np.testing.assert_allclose(card.objective, host.objective, rtol=1e-6)

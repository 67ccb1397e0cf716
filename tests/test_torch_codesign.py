"""Port gradient co-design (``repro_torch.core.codesign``) held against the
JAX package's ``grad_codesign`` on the same inputs, with ``device="cpu"``
(float64 on the host).

The JAX package's descent cannot run in this process on jax 0.9.0
(ROADMAP.md R1), so each reference case runs once in one subprocess
(``torch_codesign_reference.py``) and comes back as an ``.npz``.

What must match, at rtol 1e-8: seed and final objectives and the accepted
trajectories; the seed designs exactly, the final designs, area and power
at 1e-6 (``THETA_RTOL``); names and reports exactly.  Beside that: the
trajectory never rises, the final objective re-scores in NumPy to 1e-6,
the autograd gradient matches central finite differences, and the
descent's rule on a toy objective.
"""

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import codesign as RCD
from repro.core.sweep import MachineBatch as RefMachineBatch

import repro_torch.core as P
from repro_torch.core import codesign as PCD
from repro_torch.core import kernels_xp as PK
from repro_torch.core.sweep import MachineBatch, ParamSpace
from torch_codesign_reference import (
    params_array,
    machines_json,
    result_arrays,
    run_reference,
)

RTOL = 1e-8          # port vs JAX package, both float64
#: The final designs: near convergence a step changes J by an ulp or two,
#: so the two packages may take opposite accept / reject decisions on one
#: step (J agrees to 1e-16 either way) and leave a rate apart by that step:
#: 7.8e-8 relative in ``hbm_bw`` of one trio seed after 50 steps (measured).
THETA_RTOL = 1e-6
RESCORE_RTOL = 1e-6  # tests/test_codesign.py's NumPy re-score


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


#: case -> (suite, seeds, grad_codesign keywords)
CASES = {
    "trio-named": ("trio", "named", dict(steps=60)),
    "gen8-mixed": ("gen:8", "mixed", dict(steps=40)),
    "gen8-overlap": ("gen:8", "named",
                     dict(steps=30, timing_model="overlap", span=4.0, lr=0.3)),
    "trio-weights": ("trio", "mixed",
                     dict(steps=25, beta_ref=1, w_area=0.3, w_power=0.0)),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = {name: {"entry": "grad",
                    "profiles": [p.to_json() for p in suite(s)],
                    "machines": machines_json(seeds(m)), "kwargs": kw}
             for name, (s, m, kw) in CASES.items()}
    return run_reference(cases, tmp_path_factory.mktemp("ref_codesign"))


_PORT = {}


def port(name):
    if name not in _PORT:
        s, m, kw = CASES[name]
        _PORT[name] = P.grad_codesign(suite(s), seeds(m), device="cpu", **kw)
    return _PORT[name]


def frozen_beta(name):
    s, m, kw = CASES[name]
    pb, mb = PCD._as_batches(suite(s), seeds(m))
    return PCD.resolve_beta(pb, mb, None, kw.get("beta_ref", 0))


# --------------------------------------------------------------------------- #
# Against the JAX package
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", CASES)
def test_names_and_reports_match_reference(reference, case):
    res = port(case)
    _, blob = reference[case]
    _, mine = result_arrays(res)
    assert mine["names"] == blob["names"]
    assert mine["mode"] == blob["mode"] == "unconstrained"
    assert mine["suffix"] == blob["suffix"] == "+grad"
    assert mine["best"] == blob["best"]
    assert mine["feasibility_report"] == blob["feasibility_report"]
    assert ([v["name"] for v in mine["to_json"]["variants"]]
            == [v["name"] for v in blob["to_json"]["variants"]])
    assert mine["to_json"]["best_variant"] == blob["to_json"]["best_variant"]


@pytest.mark.parametrize("case", CASES)
def test_objectives_match_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    np.testing.assert_allclose(res.objective_seed, ref["objective_seed"],
                               rtol=RTOL)
    np.testing.assert_allclose(res.objective_final, ref["objective_final"],
                               rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_trajectory_matches_reference(reference, case):
    res = port(case)
    ref, _ = reference[case]
    assert res.trajectory.shape == ref["trajectory"].shape
    assert res.trajectory.shape[0] == CASES[case][2]["steps"] + 1
    np.testing.assert_allclose(res.trajectory, ref["trajectory"], rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_final_designs_match_reference(reference, case):
    """The final theta (every rate of every design) and the seeds'."""
    res = port(case)
    ref, _ = reference[case]
    np.testing.assert_allclose(params_array(res.final_params),
                               ref["final_params"], rtol=THETA_RTOL)
    np.testing.assert_array_equal(params_array(res.seed_params),
                                  ref["seed_params"])
    np.testing.assert_allclose(res.area_final, ref["area_final"],
                               rtol=THETA_RTOL)
    np.testing.assert_allclose(res.power_final, ref["power_final"],
                               rtol=THETA_RTOL)


# --------------------------------------------------------------------------- #
# The port's own invariants
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", CASES)
def test_trajectory_never_rises(case):
    res = port(case)
    assert np.all(np.diff(res.trajectory, axis=0) <= 1e-12)
    assert np.all(res.improvement >= 0)
    np.testing.assert_array_equal(res.trajectory[0], res.objective_seed)
    np.testing.assert_array_equal(res.trajectory[-1], res.objective_final)


def test_grad_strictly_improves_named_seeds():
    res = port("trio-named")
    assert res.names == [m.name for m in P.VARIANTS]
    assert np.all(res.objective_final < res.objective_seed)


@pytest.mark.parametrize("case", CASES)
def test_final_objective_rescores_in_numpy(case):
    """The descended designs, re-scored by the NumPy float64
    ``scalarized_objective`` with the descent's frozen beta, give the
    descent's final objective (the port's and the JAX package's re-score
    alike)."""
    res = port(case)
    s, _, kw = CASES[case]
    opts = {k: kw[k] for k in ("timing_model", "w_area", "w_power") if k in kw}
    beta = frozen_beta(case)
    mine = P.scalarized_objective(suite(s), MachineBatch.from_models(
        res.models()), beta=beta, **opts)
    np.testing.assert_allclose(mine, res.objective_final, rtol=RESCORE_RTOL)
    ref_profiles = [R.WorkloadProfile.from_json(p.to_json()) for p in suite(s)]
    theirs = RCD.scalarized_objective(
        ref_profiles, RefMachineBatch.from_models(
            [R.MachineModel.from_json(m.to_json()) for m in res.models()]),
        beta=beta, **opts)
    np.testing.assert_allclose(theirs, mine, rtol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_optimized_models_are_well_formed(case):
    res = port(case)
    s, m, kw = CASES[case]
    span = kw.get("span", 16.0)
    seed_models = seeds(m).models()
    models = res.models()
    assert [x.name for x in models] == [f"{v.name}+grad" for v in seed_models]
    for x, seed in zip(models, seed_models):
        assert x.ici_links == seed.ici_links
        assert dict(x.scale) == {k: seed.scale_for(P.Subsystem(k))
                                 for k in ("compute", "memory", "interconnect")}
        for f in PCD.OPT_FIELDS:
            assert (getattr(seed, f) / span * (1 - 1e-9) <= getattr(x, f)
                    <= getattr(seed, f) * span * (1 + 1e-9))


@pytest.mark.parametrize("case", ["trio-named", "gen8-mixed", "gen8-overlap"])
def test_autograd_gradient_matches_finite_differences(case):
    """The gradient every port descent follows (``torch.autograd`` of the
    float64 torch objective) against central differences of the NumPy
    objective (the shared ``conftest.gradcheck``)."""
    from conftest import gradcheck

    s, m, kw = CASES[case]
    timing = kw.get("timing_model", "serial")
    pb, mb = PCD._as_batches(suite(s), seeds(m))
    fixed_np = mb.arrays()
    beta = frozen_beta(case)
    theta0, _, _ = PCD.theta_box(mb, 16.0)
    be = PK.get_backend("torch", "cpu")
    p_t, fixed_t = be.profile_arrays(pb.arrays()), be.machine_arrays(fixed_np)
    theta = be.asarray(theta0).requires_grad_(True)
    obj = PCD._objective_terms(
        torch, p_t, PCD.machine_arrays_from_theta(torch, theta, fixed_t),
        be.asarray(beta), timing, P.IDEAL_EPS, P.DEFAULT_COST_MODEL, 0.1, 0.05)
    (grad,) = torch.autograd.grad(obj.sum(), theta)

    def obj_np(flat):
        m_np = PCD.machine_arrays_from_theta(
            np, flat.reshape(theta0.shape), fixed_np)
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.sum(PCD._objective_terms(
                np, pb.arrays(), m_np, beta, timing, P.IDEAL_EPS,
                P.DEFAULT_COST_MODEL, 0.1, 0.05)))

    worst = gradcheck(obj_np, theta0.ravel(), grad.numpy(), rtol=1e-4, h=1e-5)
    assert worst <= 1e-4


def test_backtracking_rule_on_a_toy_objective():
    """Per-variant steps: x1.2 on a strict drop, x0.5 otherwise; the
    retraction after the step; the history starts at the seed; ``lr`` may
    be per variant.  Held against the rule written out in NumPy."""
    target = np.array([[1.0, -2.0], [0.5, 0.5], [3.0, 0.0]])
    theta0 = np.zeros_like(target)
    lr0 = np.array([0.1, 0.9, 1.5])
    box = 2.5
    t_target = torch.as_tensor(target)
    theta, f, hist, aux, lr = PCD.backtracking_descent(
        torch.as_tensor(theta0), lambda th: ((th - t_target) ** 2).sum(dim=1),
        12, torch.as_tensor(lr0), retract=lambda th: th.clamp(-box, box),
        aux_fn=lambda th: th[:, 0])

    obj = lambda th: ((th - target) ** 2).sum(axis=1)
    th, lr_v = np.clip(theta0, -box, box), lr0.copy()
    f_cur = obj(th)
    want = [f_cur.copy()]
    for _ in range(12):
        cand = np.clip(th - lr_v[:, None] * 2 * (th - target), -box, box)
        f_new = obj(cand)
        ok = f_new < f_cur
        th = np.where(ok[:, None], cand, th)
        f_cur = np.where(ok, f_new, f_cur)
        lr_v = np.where(ok, lr_v * 1.2, lr_v * 0.5)
        want.append(f_cur.copy())
    np.testing.assert_allclose(np.stack(hist), np.stack(want), rtol=1e-12)
    np.testing.assert_allclose(theta.numpy(), th, rtol=1e-12)
    np.testing.assert_allclose(lr.numpy(), lr_v, rtol=1e-12)
    assert len(aux) == 13 and not theta.requires_grad


def test_descent_refuses_inference_mode():
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="inference_mode"):
            P.grad_codesign(trio(), seeds("named"), steps=2, device="cpu")


def test_default_device_is_the_card():
    """Without ``device=`` the descent asks for the card; on a host without
    one it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        res = P.grad_codesign(trio(), seeds("named"), steps=2)
        assert res.trajectory.shape == (3, 3)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.grad_codesign(trio(), seeds("named"), steps=2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_grad_codesign_on_card_matches_cpu(case):
    """The same descent in float64 on the card: same names, final
    objectives within 1e-6 of the host's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the descent's default device")
    s, m, kw = CASES[case]
    card = P.grad_codesign(suite(s), seeds(m), device="cuda", **kw)
    host = port(case)
    assert card.names == host.names
    np.testing.assert_allclose(card.objective_final, host.objective_final,
                               rtol=1e-6)
    assert np.all(np.diff(card.trajectory, axis=0) <= 1e-12)

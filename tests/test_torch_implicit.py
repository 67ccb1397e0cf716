"""The port's implicit sensitivities and bilevel split
(``repro_torch.core.implicit``) held against the JAX package's on the same
inputs, with ``device="cpu"`` (float64 on the host).

* ``_nnls_multipliers`` (NumPy in both packages), ``_ridge_multipliers``
  (torch here, the JAX package's with ``jnp=numpy``) and
  ``_constraint_system`` are held in this process, as is the structure
  pin: the implicit J* map's autograd graph does not grow with the
  solver's steps, the unrolled baseline's does.
* ``implicit_sensitivities`` / ``sensitivities_of``, the J* map's value
  and budget gradient, and ``bilevel_codesign`` run once per case in the
  JAX package in one subprocess (``torch_codesign_reference.py``;
  ROADMAP.md R1).

Tolerances, as ``test_torch_constrained.py``: objectives and trajectories
at rtol 1e-8; designs, multipliers and sensitivities at 1e-6 where both
packages chose the same active set (the sets are compared exactly, so a
flip is reported as one); names and picks exactly.  The gradient of J*
is held to central finite differences of its own value path at the
JAX package's rtol 1e-3 (``conftest.gradcheck``).
"""

import numpy as np
import pytest
import torch

from conftest import gradcheck
from repro.core import implicit as RI

import repro_torch.core as P
from repro_torch.core import codesign as PCD
from repro_torch.core import implicit as PI
from repro_torch.core.costmodel import DEFAULT_COST_MODEL
from repro_torch.core.sweep import MachineBatch, ParamSpace
from torch_codesign_reference import (
    assert_blob_close,
    json_round_trip,
    machines_json,
    params_array,
    run_reference,
    sensitivity_arrays,
)
from test_torch_packing import ref_machines

RTOL = 1e-8
THETA_RTOL = 1e-6
B_AREA = 0.18   # binds on every named seed for the synthetic trio


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


#: sensitivity case -> (suite, seeds, constrained keywords or None (at the
#: seeds' own rates), report keywords)
SENSITIVITIES = {
    "of-projected": ("trio", "named", dict(area_budget=B_AREA, steps=60),
                     dict(polish_steps=10)),
    "of-lagrangian": ("trio", "named",
                      dict(area_budget=B_AREA, mode="lagrangian", steps=30),
                      {}),
    "of-envelope": ("trio", "named",
                    dict(area_budget=0.2, power_budget=0.28,
                         area_envelope={"hbm_bw": 0.25}, steps=30), {}),
    # the baseline seed sits exactly on area 1.0 and on its peak-FLOP/s
    # envelope: several active constraints at once
    "at-seeds": ("gen:8", "mixed", None,
                 dict(area_budget=1.0, power_budget=1.5,
                      area_envelope={"peak_flops": 1.0})),
}

#: bilevel case -> keywords (trio, named seeds; cut to a few inner steps)
BILEVEL = {
    "uniform-start": dict(total_budget=0.35, steps=2, outer_steps=1),
    "spec": dict(spec={"total_budget": 0.4, "split0": 0.4, "outer_steps": 1,
                       "steps": 2, "lr": 0.1}),
}

JSTAR_BUDGETS = [B_AREA, 0.30]
JSTAR_STEPS = 3


def _port_kwargs(kw):
    kw = dict(kw)
    if "spec" in kw:
        kw["spec"] = P.CodesignSpec.from_json(kw["spec"])
    return kw


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cases = {}
    for name, (s, m, of, kw) in SENSITIVITIES.items():
        case = {"entry": "sensitivities",
                "profiles": [p.to_json() for p in suite(s)],
                "machines": machines_json(seeds(m)), "kwargs": kw}
        if of is None:
            case["theta"] = PCD.theta_box(seeds(m), 16.0)[0].tolist()
        else:
            case["of"] = of
        cases[name] = case
    for name, kw in BILEVEL.items():
        cases[name] = {"entry": "bilevel",
                       "profiles": [p.to_json() for p in trio()],
                       "machines": machines_json(seeds("named")),
                       "kwargs": kw}
    cases["jstar"] = {"entry": "jstar_grad",
                      "profiles": [p.to_json() for p in trio()],
                      "machines": machines_json(seeds("named")),
                      "kwargs": {"steps": JSTAR_STEPS},
                      "budgets": JSTAR_BUDGETS}
    return run_reference(cases, tmp_path_factory.mktemp("ref_implicit"))


_PORT = {}


def port_report(name):
    """``(report, constrained result or None)`` of a sensitivity case."""
    if name not in _PORT:
        s, m, of, kw = SENSITIVITIES[name]
        if of is None:
            _PORT[name] = (P.implicit_sensitivities(suite(s), seeds(m),
                                                    device="cpu", **kw), None)
        else:
            res = P.constrained_codesign(suite(s), seeds(m), device="cpu",
                                         **of)
            _PORT[name] = (P.sensitivities_of(res, suite(s), device="cpu",
                                              **kw), res)
    return _PORT[name]


def port_bilevel(name):
    if name not in _PORT:
        _PORT[name] = P.bilevel_codesign(trio(), seeds("named"), device="cpu",
                                         **_port_kwargs(BILEVEL[name]))
    return _PORT[name]


def assert_reports_match(rep, ref, blob, prefix=""):
    """Active / free sets exactly, then the multipliers and every
    sensitivity at 1e-6 (objective at 1e-8)."""
    flips = np.argwhere(rep.active != ref[prefix + "active"])
    assert flips.size == 0, f"active-set flips at (variant, constraint) {flips.tolist()}"
    np.testing.assert_array_equal(rep.free, ref[prefix + "free"])
    for f in ("multipliers", "dJ_dbudget", "area", "power", "dJ_dw_area",
              "dJ_dw_power"):
        np.testing.assert_allclose(getattr(rep, f), ref[prefix + f],
                                   rtol=THETA_RTOL, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(rep.residual, ref[prefix + "residual"],
                               rtol=THETA_RTOL, atol=1e-9)
    np.testing.assert_allclose(rep.objective, ref[prefix + "objective"],
                               rtol=RTOL)
    mine, mine_blob = sensitivity_arrays(rep, prefix)
    for f in ("dJ_darea_weights", "dJ_dpower_weights"):
        np.testing.assert_allclose(mine[prefix + f], ref[prefix + f],
                                   rtol=THETA_RTOL, atol=1e-12, err_msg=f)
    mine_blob = json_round_trip(mine_blob)
    for key in ("names", "constraint_names", "best_relaxation"):
        assert mine_blob[key] == blob[key], key
    assert_blob_close(mine_blob["to_json"], blob["to_json"], THETA_RTOL)


# --------------------------------------------------------------------------- #
# Against the JAX package (subprocess)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("case", SENSITIVITIES)
def test_sensitivities_match_reference(reference, case):
    rep, res = port_report(case)
    ref, blob = reference[case]
    if res is not None:
        np.testing.assert_allclose(res.objective_final,
                                   ref["of_objective_final"], rtol=RTOL)
        np.testing.assert_allclose(params_array(res.final_params),
                                   ref["of_final_params"], rtol=THETA_RTOL)
    assert_reports_match(rep, ref, blob)


@pytest.mark.parametrize("case", SENSITIVITIES)
def test_kkt_structure(case):
    """Multipliers nonnegative, zero on slack constraints (complementary
    slackness), ``dJ*/db = -lambda <= 0``, and the best relaxation is the
    largest price."""
    rep, _ = port_report(case)
    assert np.all(rep.multipliers >= 0.0)
    assert np.all(rep.multipliers[~rep.active] == 0.0)
    np.testing.assert_array_equal(rep.dJ_dbudget, -rep.multipliers)
    for i in range(len(rep.names)):
        best = rep.best_relaxation(i)
        if best is not None:
            j = list(rep.constraint_names).index(best)
            assert rep.multipliers[i, j] == rep.multipliers[i].max()


def test_binding_area_budget_is_priced(reference):
    """The trio under area 0.18 binds on every named seed: a positive price
    on each (the JAX package's own pin), not only zeros that agree."""
    rep, _ = port_report("of-projected")
    assert list(rep.constraint_names) == ["area"]
    assert np.all(rep.active[:, 0]) and np.all(rep.multipliers[:, 0] > 0)


def test_envelope_prices_route_to_named_subsystem():
    rep, _ = port_report("of-envelope")
    assert list(rep.constraint_names) == ["area", "power", "hbm_bw"]
    md = rep.markdown()
    assert "hbm_bw" in md and "relax first" in md


def test_jstar_value_and_gradient_match_reference(reference):
    ref, _ = reference["jstar"]
    f = P.implicit_jstar_fn(trio(), seeds("named"), steps=JSTAR_STEPS,
                            device="cpu")
    b = torch.tensor(JSTAR_BUDGETS, dtype=torch.float64, requires_grad=True)
    value = f(b)
    (grad,) = torch.autograd.grad(torch.amin(value), b)
    np.testing.assert_allclose(value.detach().numpy(), ref["value"],
                               rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), ref["grad"], rtol=THETA_RTOL,
                               atol=1e-12)


@pytest.mark.parametrize("case", BILEVEL)
def test_bilevel_matches_reference(reference, case):
    res = port_bilevel(case)
    ref, blob = reference[case]
    for f in ("split_trajectory", "objective_trajectory",
              "objective_uniform"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=RTOL,
                                   err_msg=f)
    inner = res.inner
    np.testing.assert_allclose(inner.trajectory, ref["inner_trajectory"],
                               rtol=RTOL)
    np.testing.assert_allclose(params_array(inner.final_params),
                               ref["inner_final_params"], rtol=THETA_RTOL)
    np.testing.assert_array_equal(inner.feasible, ref["inner_feasible"])
    assert_reports_match(res.sensitivity, ref, blob["sensitivity"], "sens_")
    assert_blob_close(json_round_trip(res.to_json()), blob["to_json"],
                      THETA_RTOL)


@pytest.mark.parametrize("case", BILEVEL)
def test_bilevel_never_rises(case):
    """Only improving outer steps are taken, so the result is never worse
    than the starting split -- the uniform one unless ``split0`` moves
    it."""
    res = port_bilevel(case)
    assert np.all(np.diff(res.objective_trajectory) <= 1e-12)
    if res.split_trajectory[0] == 0.5:
        assert res.objective_final <= res.objective_uniform + 1e-12
    assert abs(res.area_budget + res.power_budget - res.total_budget) < 1e-12
    md = res.markdown()
    assert "split" in md and "uniform" in md


# --------------------------------------------------------------------------- #
# In process: the multiplier solves and the constraint system
# --------------------------------------------------------------------------- #


def _kkt_system(seed, v=6, c=3, d=4, all_free=False):
    rng = np.random.default_rng(seed)
    gj = rng.normal(size=(v, d))
    grads = rng.uniform(0.1, 2.0, size=(v, c, d))
    active = rng.uniform(size=(v, c)) < 0.6
    free = (np.ones((v, d), dtype=bool) if all_free
            else rng.uniform(size=(v, d)) < 0.85)
    return gj, grads, active, free


@pytest.mark.parametrize("seed", range(5))
def test_nnls_multipliers_match_reference(seed):
    gj, grads, active, free = _kkt_system(seed)
    lam, res = PI._nnls_multipliers(gj, grads, active, free)
    lam_ref, res_ref = RI._nnls_multipliers(gj, grads, active, free)
    np.testing.assert_array_equal(lam, lam_ref)
    np.testing.assert_array_equal(res, res_ref)
    assert np.all(lam >= 0.0) and np.all(lam[~active] == 0.0)


@pytest.mark.parametrize("seed", range(5))
def test_ridge_multipliers_match_reference(seed):
    """Every coordinate free and at most 3 constraints on 4 coordinates:
    well-posed normal equations (a box-pinned coordinate can leave more
    active constraints than free coordinates, where the 1e-10 ridge alone
    decides the solve and two LAPACK calls part at ~1e-6)."""
    gj, grads, active, free = _kkt_system(seed, all_free=True)
    t = lambda a: torch.as_tensor(a)
    lam = PI._ridge_multipliers(t(gj), t(grads), t(active), t(free)).numpy()
    lam_ref = RI._ridge_multipliers(np, gj, grads, active, free)
    np.testing.assert_allclose(lam, lam_ref, rtol=1e-9, atol=1e-12)
    assert np.all(lam >= 0.0) and np.all(lam[~active] == 0.0)


def test_ridge_agrees_with_nnls_on_a_kkt_point():
    """Gradients built as ``-G_A^T lam`` with positive ``lam``: both solves
    recover ``lam`` (the careful host solve and the backward pass's)."""
    rng = np.random.default_rng(11)
    v, c, d = 5, 2, 4
    grads = rng.uniform(0.1, 2.0, size=(v, c, d))
    lam_true = rng.uniform(0.5, 2.0, size=(v, c))
    gj = -np.einsum("vcd,vc->vd", grads, lam_true)
    active = np.ones((v, c), dtype=bool)
    free = np.ones((v, d), dtype=bool)
    lam_nnls, res = PI._nnls_multipliers(gj, grads, active, free)
    lam_ridge = PI._ridge_multipliers(*(torch.as_tensor(a) for a in
                                        (gj, grads, active, free))).numpy()
    np.testing.assert_allclose(lam_nnls, lam_true, rtol=1e-9)
    np.testing.assert_allclose(lam_ridge, lam_true, rtol=1e-6)
    assert np.all(res < 1e-9)


#: constraint sets for ``_constraint_system``
SYSTEMS = {
    "area": dict(area_budget=0.7, power_budget=None, area_envelope=None),
    "power": dict(area_budget=None, power_budget=0.9, area_envelope=None),
    "both+envelopes": dict(area_budget=0.8, power_budget=1.0,
                           area_envelope={"ici_bw_total": 0.6,
                                          "hbm_bw": 0.5}),
    "per-variant area": dict(area_budget=np.linspace(0.5, 1.5, 8),
                             power_budget=1.2, area_envelope=None),
}


@pytest.mark.parametrize("system", SYSTEMS)
def test_constraint_system_matches_reference(system):
    mb = seeds("mixed")
    theta0, lo, hi = PCD.theta_box(mb, 16.0)
    theta = theta0 + np.random.default_rng(2).uniform(-1, 1, theta0.shape)
    kw = SYSTEMS[system]
    args = (DEFAULT_COST_MODEL, kw["area_budget"], kw["power_budget"],
            kw["area_envelope"])
    want = RI._constraint_system(np, theta, ref_machines(mb).arrays(), *args)
    got_np = PI._constraint_system(np, theta, mb.arrays(), *args)
    fixed = P.get_backend("torch", "cpu").machine_arrays(mb.arrays())
    got_t = PI._constraint_system(torch, torch.as_tensor(theta), fixed,
                                  *args[:1],
                                  None if kw["area_budget"] is None
                                  else torch.as_tensor(kw["area_budget"],
                                                       dtype=torch.float64),
                                  *args[2:])
    for g_np, g_t, w in zip(got_np, got_t, want):
        np.testing.assert_allclose(g_np, w, rtol=1e-14)
        np.testing.assert_allclose(g_t.numpy(), w, rtol=1e-14)
    mask = PI._free_mask(torch, torch.as_tensor(theta), torch.as_tensor(lo),
                         torch.as_tensor(hi), PI.BOX_ATOL).numpy()
    np.testing.assert_array_equal(mask, RI._free_mask(np, theta, lo, hi,
                                                      RI.BOX_ATOL))


# --------------------------------------------------------------------------- #
# The J* map: structure and gradient
# --------------------------------------------------------------------------- #


def _autograd_nodes(t) -> int:
    """Autograd nodes reachable from ``t.grad_fn``."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return len(seen)


def test_implicit_graph_size_is_steps_independent():
    """The implicit map's autograd graph is the same at 2 and at 6 solver
    steps (the forward runs without a graph; one Function node), while
    the unrolled baseline's grows with its steps."""
    def size_of(fn):
        b = torch.tensor(JSTAR_BUDGETS, dtype=torch.float64,
                         requires_grad=True)
        return _autograd_nodes(torch.amin(fn(b)))

    kw = dict(projection="shift", device="cpu")
    imp2 = size_of(P.implicit_jstar_fn(trio(), seeds("named"), steps=2, **kw))
    imp6 = size_of(P.implicit_jstar_fn(trio(), seeds("named"), steps=6, **kw))
    assert imp2 == imp6 and imp2 <= 4
    unr2 = size_of(P.unrolled_jstar_fn(trio(), seeds("named"), steps=2,
                                       device="cpu"))
    unr6 = size_of(P.unrolled_jstar_fn(trio(), seeds("named"), steps=6,
                                       device="cpu"))
    assert unr6 > 1.5 * unr2
    assert unr6 > 2 * imp6


def test_unrolled_gradient_matches_fd():
    """The unrolled baseline differentiates through its own steps (the
    inner gradients keep their graph): autograd equals central finite
    differences of its value."""
    f = P.unrolled_jstar_fn(trio(), seeds("named"), steps=4, device="cpu")
    b = torch.tensor(JSTAR_BUDGETS, dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(torch.amin(f(b)), b)

    def value(bv):
        return float(torch.amin(f(torch.as_tensor(bv))).detach())

    gradcheck(value, np.array(JSTAR_BUDGETS), grad.numpy(), rtol=1e-3,
              atol=1e-8, log_space=True)


def test_implicit_gradient_matches_fd():
    """``torch.autograd.grad`` through the implicit J* map equals central
    finite differences of its own value path at the JAX package's rtol
    1e-3, on the JAX package's pin (the synthetic trio on the named seeds,
    area 0.18 binding, power 0.30 slack).  The implicit gradient holds at
    the optimum: an initial step of 30 (default 0.1) reaches it in 8
    solver steps (the JAX package's pin runs 60 at 0.1), and the variants'
    sum keeps two seeds that converge to one design from meeting at a
    kink of the minimum."""
    f = P.implicit_jstar_fn(trio(), seeds("named"), steps=8, lr=30.0,
                            device="cpu")
    b = torch.tensor(JSTAR_BUDGETS, dtype=torch.float64, requires_grad=True)
    (grad,) = torch.autograd.grad(f(b).sum(), b)
    assert grad[0] < 0.0 and grad[1] == 0.0   # area binds, power is slack

    def value(x):
        with torch.no_grad():
            return float(f([x[0], JSTAR_BUDGETS[1]]).sum())

    worst = gradcheck(value, np.array(JSTAR_BUDGETS[:1]), grad.numpy()[:1],
                      rtol=1e-3, atol=1e-8, log_space=True)
    assert worst <= 1e-3


# --------------------------------------------------------------------------- #
# Validation and devices
# --------------------------------------------------------------------------- #


def test_sensitivities_need_a_constraint():
    with pytest.raises(ValueError, match="at least one"):
        P.implicit_sensitivities(trio(), seeds("named"), device="cpu")


def test_sensitivities_of_rejects_joint_results():
    res = P.joint_codesign([[p] for p in trio()], seeds("named"), rounds=1,
                           steps=2, device="cpu")
    with pytest.raises(ValueError, match="joint"):
        P.sensitivities_of(res, trio(), device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(total_budget=-1.0),
                                dict(total_budget=0.4, split0=1.5)],
                         ids=["no-budget", "negative", "split"])
def test_bilevel_validation_matches_reference(kw):
    with pytest.raises(ValueError) as mine:
        P.bilevel_codesign(trio(), seeds("named"), device="cpu", **kw)
    with pytest.raises(ValueError) as theirs:
        RI.bilevel_codesign([], ref_machines(seeds("named")), **kw)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("entry", ["sensitivities", "jstar", "bilevel"])
def test_default_device_is_the_card(entry):
    run = {
        "sensitivities": lambda: P.implicit_sensitivities(
            trio(), seeds("named"), area_budget=B_AREA),
        "jstar": lambda: P.implicit_jstar_fn(trio(), seeds("named"),
                                             steps=1)(JSTAR_BUDGETS),
        "bilevel": lambda: P.bilevel_codesign(
            trio(), seeds("named"), total_budget=0.35, steps=1,
            outer_steps=1),
    }[entry]
    if torch.cuda.is_available():
        run()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()


@pytest.mark.cuda
@pytest.mark.parametrize("case", SENSITIVITIES)
def test_sensitivities_on_card_match_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sensitivities' default device")
    s, m, of, kw = SENSITIVITIES[case]
    if of is None:
        card = P.implicit_sensitivities(suite(s), seeds(m), device="cuda",
                                        **kw)
    else:
        res = P.constrained_codesign(suite(s), seeds(m), device="cuda", **of)
        card = P.sensitivities_of(res, suite(s), device="cuda", **kw)
    host, _ = port_report(case)
    np.testing.assert_array_equal(card.active, host.active)
    np.testing.assert_allclose(card.multipliers, host.multipliers, rtol=1e-6,
                               atol=1e-9)

"""Run the JAX package's co-design descents in a subprocess, for the port's
parity tests (``test_torch_codesign.py``, ``test_torch_constrained.py``,
``test_torch_frontier.py``, ``test_torch_implicit.py``,
``test_torch_packing.py``, ``test_torch_service.py``,
``test_torch_hillclimb.py``).

On jax 0.9.0 the JAX package's ``jax`` backend cannot be built in the test
process: ``kernels_xp.JaxBackend`` imports ``jax.experimental.enable_x64``,
which that release removed (ROADMAP.md R1).  This script sets the one-line
stand-in ``jax.experimental.enable_x64 = lambda: jax.enable_x64(True)``
before the JAX package is imported, runs each requested case once and
writes the results to an ``.npz``; the backend cache is process-wide, so
the stand-in stays inside this process.

    python tests/torch_codesign_reference.py CASES.json OUT.npz

``CASES.json`` maps a case name to ``{"entry": "grad" | "constrained" |
"joint" | "frontier" | "pack" | "bilevel" | "sensitivities" |
"jstar_grad" | "hillclimb", "profiles": [WorkloadProfile JSON, ...] (or "groups":
[[...], ...] for "joint"), "machines": {MachineBatch field: list},
"kwargs": {...}}``; a ``"spec"`` entry in ``kwargs`` is a ``CodesignSpec``
JSON.  Entry-specific keys:

* ``frontier``: ``"resume": [budgets]`` traces the case, then a second
  schedule warm-started from its continuation at the budget the co-design
  service would pick (the tightest solved budget at or above the new
  loosest one, else the loosest solved), and reports that second trace;
* ``sensitivities``: ``"theta"`` (a ``(V, 4)`` list) evaluates
  ``implicit_sensitivities`` there; ``"of": {constrained keywords}`` runs
  ``constrained_codesign`` first and reports ``sensitivities_of`` its
  result (``kwargs`` then go to ``sensitivities_of``);
* ``jstar_grad``: ``"budgets": [area, power]``; reports
  ``implicit_jstar_fn(**kwargs)(budgets)`` and ``jax.grad`` of its
  minimum over the variants;
* ``hillclimb``: ``"fn"`` names a co-design wrapper of
  ``repro.launch.hillclimb`` (``codesign_grad``, ``codesign_frontier``,
  ``codesign_pack``, ``codesign_bilevel``, ``codesign_joint``), called as
  ``fn(profiles[0], *args, **kwargs)`` (``codesign_joint`` on ``profiles``
  as one group); ``"bilevel_defaults"`` overrides
  ``repro.core.implicit._BILEVEL_DEFAULTS`` for the call.  No
  ``"machines"``: the wrappers seed from the named variants.  The module's
  import appends a 512-device request to ``XLA_FLAGS``; JAX is initialised
  before it, so the request has no effect.

Every case's arrays land under ``<case>.<field>``; its names, reports and
picks under ``<case>.json``.
"""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MACHINE_FIELDS = ("peak_flops", "hbm_bw", "ici_bw", "ici_links",
                  "inter_pod_bw", "scale_compute", "scale_memory",
                  "scale_interconnect")
PARAM_KEYS = ("peak_flops", "hbm_bw", "ici_bw", "ici_links", "inter_pod_bw",
              "scale_compute", "scale_memory", "scale_interconnect")
ARRAY_FIELDS = ("objective_seed", "objective_final", "trajectory",
                "area_final", "power_final", "feasible", "violation_trace",
                "multipliers")
FRONTIER_FIELDS = ("budgets", "objective", "area", "power", "feasible",
                   "per_seed_objective", "final_lr", "dJ_dbudget",
                   "shadow_prices")
PACKING_FIELDS = ("assignment", "trajectory", "per_app_aggregate",
                  "objective_seed", "objective_final", "area_total",
                  "power_total", "budgets", "frontier_objective",
                  "frontier_area", "frontier_feasible")
SENSITIVITY_FIELDS = ("multipliers", "dJ_dbudget", "active", "free",
                      "residual", "objective", "area", "power", "dJ_dw_area",
                      "dJ_dw_power")
RATE_FIELDS = ("peak_flops", "hbm_bw", "ici_bw_total", "inter_pod_bw")


def machines_json(mb):
    """A ``MachineBatch`` (either package's) as plain JSON."""
    out = {"names": list(mb.names)}
    out.update({f: [float(x) for x in getattr(mb, f)] for f in MACHINE_FIELDS})
    return out


def params_array(params):
    """``final_params`` / ``seed_params`` as a ``(V, 8)`` array."""
    return np.array([[p[k] for k in PARAM_KEYS] for p in params])


def result_arrays(res):
    """The arrays and the JSON blob of one ``CodesignResult``."""
    arrays = {f: np.asarray(getattr(res, f)) for f in ARRAY_FIELDS
              if getattr(res, f) is not None}
    arrays["final_params"] = params_array(res.final_params)
    arrays["seed_params"] = params_array(res.seed_params)
    blob = {"names": list(res.names), "mode": res.mode, "suffix": res.suffix,
            "feasibility_report": res.feasibility_report(),
            "selection_names": res.selection_names,
            "constraint_names": (list(res.constraint_names)
                                 if res.constraint_names else None),
            "to_json": res.to_json(), "best": res.best}
    return arrays, blob


def assert_blob_close(got, want, rtol, path="blob"):
    """Equal JSON structure and keys; floats at ``rtol`` (NaN where NaN),
    the rest exactly."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_blob_close(got[k], want[k], rtol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_blob_close(g, w, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-15,
                                   err_msg=path)
    else:
        assert got == want, (path, got, want)


def json_round_trip(blob):
    """``blob`` as the reference's arrives: through JSON."""
    return json.loads(json.dumps(blob))


def _arrays_of(obj, fields, prefix=""):
    return {prefix + f: np.asarray(getattr(obj, f)) for f in fields
            if getattr(obj, f) is not None}


def frontier_arrays(res):
    """The arrays and the JSON blob of one ``FrontierResult``."""
    arrays = _arrays_of(res, FRONTIER_FIELDS)
    arrays["best_params"] = params_array(res.best_params)
    if res.continuation is not None:
        arrays["continuation"] = np.stack(
            [res.continuation[b] for b in sorted(res.continuation)])
    blob = {"best_names": list(res.best_names),
            "seed_names": list(res.seed_names), "steps": res.steps,
            "refine_steps": res.refine_steps, "warm_start": res.warm_start,
            "sensitivity_constraints": (
                list(res.sensitivity_constraints)
                if res.sensitivity_constraints is not None else None),
            "to_json": res.to_json(), "markdown": res.markdown()}
    return arrays, blob


def packing_arrays(res):
    """The arrays and the JSON blob of one ``PackingResult``."""
    arrays = _arrays_of(res, PACKING_FIELDS)
    arrays["final_params"] = params_array(res.final_params)
    arrays["seed_params"] = params_array(res.seed_params)
    blob = {"app_names": list(res.app_names),
            "machine_names": list(res.machine_names),
            "feasible": res.feasible, "mode": res.mode,
            "to_json": res.to_json(), "markdown": res.markdown()}
    return arrays, blob


def sensitivity_arrays(rep, prefix=""):
    """The arrays and the JSON blob of one ``SensitivityReport``."""
    arrays = _arrays_of(rep, SENSITIVITY_FIELDS, prefix)
    arrays[prefix + "dJ_darea_weights"] = np.stack(
        [rep.dJ_darea_weights[f] for f in RATE_FIELDS])
    arrays[prefix + "dJ_dpower_weights"] = np.stack(
        [rep.dJ_dpower_weights[f] for f in RATE_FIELDS])
    blob = {"names": list(rep.names),
            "constraint_names": list(rep.constraint_names),
            "best_relaxation": [rep.best_relaxation(i)
                                for i in range(len(rep.names))],
            "to_json": rep.to_json()}
    return arrays, blob


def bilevel_arrays(res):
    """The arrays and the JSON blob of one ``BilevelResult``."""
    arrays = {"split_trajectory": np.asarray(res.split_trajectory),
              "objective_trajectory": np.asarray(res.objective_trajectory),
              "objective_uniform": np.asarray(res.objective_uniform)}
    inner, inner_blob = result_arrays(res.inner)
    arrays.update({f"inner_{k}": v for k, v in inner.items()})
    sens, sens_blob = sensitivity_arrays(res.sensitivity, "sens_")
    arrays.update(sens)
    return arrays, {"to_json": res.to_json(), "inner": inner_blob,
                    "sensitivity": sens_blob}


def run_reference(cases, workdir):
    """Run ``cases`` through the JAX package in one subprocess; returns
    ``{case: (arrays, blob)}``."""
    src = os.path.join(str(workdir), "cases.json")
    out = os.path.join(str(workdir), "reference.npz")
    with open(src, "w") as f:
        json.dump(cases, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), ROOT])
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), src, out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    got = {}
    with np.load(out) as z:
        for name in cases:
            arrays = {k.split(".", 1)[1]: z[k] for k in z.files
                      if k.startswith(name + ".") and not k.endswith(".json")}
            got[name] = (arrays, json.loads(str(z[name + ".json"])))
    return got


def resume_pick(solved, budgets):
    """The co-design service's warm-start pick: the tightest solved budget
    at or above the new schedule's loosest, else the loosest solved."""
    loosest = max(float(b) for b in budgets)
    ge = [b for b in sorted(solved) if b >= loosest]
    return min(ge) if ge else max(solved)


def _reference_case(case):
    """Run one case; returns ``(arrays, blob)``."""
    from repro.core import WorkloadProfile
    from repro.core.codesign import grad_codesign
    from repro.core.constrained import constrained_codesign, joint_codesign
    from repro.core.spec import CodesignSpec
    from repro.core.sweep import MachineBatch

    if case["entry"] == "hillclimb":
        return _hillclimb_case(case)
    m = case["machines"]
    mb = MachineBatch(names=list(m["names"]),
                      **{f: np.asarray(m[f], dtype=np.float64)
                         for f in MACHINE_FIELDS})
    kwargs = dict(case.get("kwargs", {}))
    if "spec" in kwargs:
        kwargs["spec"] = CodesignSpec.from_json(kwargs["spec"])
    entry = case["entry"]
    if entry == "joint":
        groups = [[WorkloadProfile.from_json(p) for p in g]
                  for g in case["groups"]]
        return result_arrays(joint_codesign(groups, mb, **kwargs))
    profiles = [WorkloadProfile.from_json(p) for p in case["profiles"]]
    if entry in ("grad", "constrained"):
        fn = {"grad": grad_codesign, "constrained": constrained_codesign}
        return result_arrays(fn[entry](profiles, mb, **kwargs))
    if entry == "frontier":
        from repro.core.frontier import frontier_codesign

        res = frontier_codesign(profiles, mb, **kwargs)
        if "resume" in case:
            pick = resume_pick(res.continuation, case["resume"])
            kwargs.update(budgets=case["resume"],
                          warm_theta=res.continuation[pick],
                          warm_lr=res.final_lr)
            res = frontier_codesign(profiles, mb, **kwargs)
        return frontier_arrays(res)
    if entry == "pack":
        from repro.core.packing import fleet_objective, pack_codesign

        res = pack_codesign(profiles, mb, **kwargs)
        arrays, blob = packing_arrays(res)
        beta = kwargs.get("beta", getattr(kwargs.get("spec"), "beta", None))
        blob["fleet_objective"] = fleet_objective(profiles, res.machines,
                                                  beta=beta)
        return arrays, blob
    if entry == "bilevel":
        from repro.core.implicit import bilevel_codesign

        return bilevel_arrays(bilevel_codesign(profiles, mb, **kwargs))
    if entry == "sensitivities":
        from repro.core.implicit import (implicit_sensitivities,
                                         sensitivities_of)

        if "of" in case:
            res = constrained_codesign(profiles, mb, **case["of"])
            arrays, blob = sensitivity_arrays(
                sensitivities_of(res, profiles, **kwargs))
            inner, _ = result_arrays(res)
            arrays.update({f"of_{k}": v for k, v in inner.items()})
            return arrays, blob
        theta = np.asarray(case["theta"], dtype=np.float64)
        return sensitivity_arrays(
            implicit_sensitivities(profiles, mb, theta, **kwargs))
    if entry == "jstar_grad":
        from repro.core.implicit import implicit_jstar_fn
        from repro.core.kernels_xp import get_backend

        backend = get_backend("jax")
        jax, jnp = backend._jax, backend._jnp
        f = implicit_jstar_fn(profiles, mb, **kwargs)
        with backend._x64():
            b = jnp.asarray(case["budgets"], dtype=jnp.float64)
            value = np.asarray(f(b))
            grad = np.asarray(jax.grad(lambda bb: jnp.min(f(bb)))(b))
        return {"value": value, "grad": grad}, {}
    raise ValueError(f"unknown entry {entry!r}")


def _hillclimb_case(case):
    """One ``repro.launch.hillclimb`` co-design wrapper; ``(arrays, blob)``."""
    import jax

    jax.devices()   # initialise before the launcher's XLA_FLAGS request
    from repro.core import WorkloadProfile
    from repro.core import implicit as RI
    from repro.launch import hillclimb as RH

    profiles = [WorkloadProfile.from_json(p) for p in case["profiles"]]
    fn = case["fn"]
    first = profiles if fn == "codesign_joint" else profiles[0]
    defaults = dict(RI._BILEVEL_DEFAULTS)
    RI._BILEVEL_DEFAULTS.update(case.get("bilevel_defaults", {}))
    try:
        out = getattr(RH, fn)(first, *case.get("args", []),
                              **case.get("kwargs", {}))
    finally:
        RI._BILEVEL_DEFAULTS.clear()
        RI._BILEVEL_DEFAULTS.update(defaults)
    if fn == "codesign_frontier":
        return frontier_arrays(out)
    if fn == "codesign_pack":
        return packing_arrays(out)
    if fn == "codesign_bilevel":
        return bilevel_arrays(out)
    return {}, {"to_json": out}


def main(src, out):
    import jax
    import jax.experimental

    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    with open(src) as f:
        cases = json.load(f)
    blob = {}
    for name, case in cases.items():
        arrays, meta = _reference_case(case)
        blob.update({f"{name}.{k}": v for k, v in arrays.items()})
        blob[f"{name}.json"] = np.array(json.dumps(meta))
    np.savez(out, **blob)


if __name__ == "__main__":
    main(*sys.argv[1:3])

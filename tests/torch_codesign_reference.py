"""Run the JAX package's co-design descents in a subprocess, for the port's
parity tests (``test_torch_codesign.py``, ``test_torch_constrained.py``).

On jax 0.9.0 the JAX package's ``jax`` backend cannot be built in the test
process: ``kernels_xp.JaxBackend`` imports ``jax.experimental.enable_x64``,
which that release removed (ROADMAP.md R1).  This script sets the one-line
stand-in ``jax.experimental.enable_x64 = lambda: jax.enable_x64(True)``
before the JAX package is imported, runs each requested case once and
writes the results to an ``.npz``; the backend cache is process-wide, so
the stand-in stays inside this process.

    python tests/torch_codesign_reference.py CASES.json OUT.npz

``CASES.json`` maps a case name to ``{"entry": "grad" | "constrained" |
"joint", "profiles": [WorkloadProfile JSON, ...] (or "groups": [[...],
...] for "joint"), "machines": {MachineBatch field: list}, "kwargs":
{...}}``; a ``"spec"`` entry in ``kwargs`` is a ``CodesignSpec`` JSON.
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


def _reference_case(case):
    from repro.core import WorkloadProfile
    from repro.core.codesign import grad_codesign
    from repro.core.constrained import constrained_codesign, joint_codesign
    from repro.core.spec import CodesignSpec
    from repro.core.sweep import MachineBatch

    m = case["machines"]
    mb = MachineBatch(names=list(m["names"]),
                      **{f: np.asarray(m[f], dtype=np.float64)
                         for f in MACHINE_FIELDS})
    kwargs = dict(case.get("kwargs", {}))
    if "spec" in kwargs:
        kwargs["spec"] = CodesignSpec.from_json(kwargs["spec"])
    if case["entry"] == "joint":
        groups = [[WorkloadProfile.from_json(p) for p in g]
                  for g in case["groups"]]
        return joint_codesign(groups, mb, **kwargs)
    profiles = [WorkloadProfile.from_json(p) for p in case["profiles"]]
    entry = {"grad": grad_codesign, "constrained": constrained_codesign}
    return entry[case["entry"]](profiles, mb, **kwargs)


def main(src, out):
    import jax
    import jax.experimental

    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    with open(src) as f:
        cases = json.load(f)
    blob = {}
    for name, case in cases.items():
        arrays, meta = result_arrays(_reference_case(case))
        blob.update({f"{name}.{k}": v for k, v in arrays.items()})
        blob[f"{name}.json"] = np.array(json.dumps(meta))
    np.savez(out, **blob)


if __name__ == "__main__":
    main(*sys.argv[1:3])

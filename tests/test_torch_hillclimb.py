"""The port's hillclimb launcher (``repro_torch.launch.hillclimb``) held
against the JAX package's (``repro.launch.hillclimb``) on the CPU.

Importing the JAX module appends a 512-host-device request to
``XLA_FLAGS`` (``repro/launch/xla_flags.py``): the ``RH`` fixture imports it
once and puts the variable back.  Its co-design wrappers build the JAX
package's ``jax`` backend, which jax 0.9.0 cannot (ROADMAP.md R1): they run
once per case in one subprocess (``torch_codesign_reference.py``, entry
``hillclimb``), on the profile the port's launcher substituted at smoke
size; the bilevel wrapper with both packages' ``_BILEVEL_DEFAULTS`` cut to
one outer step and the shift projection (``test_torch_implicit.py`` holds
the Euclidean one).  Tolerances, as ``test_torch_constrained.py``: objectives at rtol
1e-8, the results' JSON at 1e-6, names exactly.  The parsers, the analytic
kernel terms and ``machine_candidates`` agree exactly; ``codesign_sweep``
(the JAX package's NumPy backend against the port's float64 torch on the
CPU) by name and at 1e-9.

The port's probes count with the op counter, whose counts are exact
polynomials in S (and N): the quadratic fitted at S, S/2, S/4 holds at S/8,
and its S^2 term equals the score traffic written out by hand
(``chip_smoke.attention_score_bytes``); the decode step's N term equals the
state traffic written out by hand (``chip_smoke.scan_state_bytes_by_hand``).
"""

import inspect
import json
import os
import sys
import types

import numpy as np
import pytest

import repro_torch.core as P
from repro_torch import configs as C
from repro_torch.configs.shapes import SHAPES, ShapeSpec, resolve_shape
from repro_torch.core.costs import WorkloadProfile
from repro_torch.launch import hillclimb as HC
from repro_torch.launch.extract import run_cell
from torch_codesign_reference import (
    MACHINE_FIELDS,
    assert_blob_close,
    json_round_trip,
    params_array,
    run_reference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-8
THETA_RTOL = 1e-6
SWEEP_RTOL = 1e-9
FIT_RTOL = 1e-6


@pytest.fixture(scope="module")
def RH():
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return hillclimb


def chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    return CS


# --------------------------------------------------------------------------- #
# parse-time validation: one table, both packages
# --------------------------------------------------------------------------- #


class _Boom(Exception):
    pass


class _Parser:
    def error(self, message):
        raise _Boom(message)


def _outcome(fn, *args):
    try:
        return ("ok", fn(_Parser(), *args))
    except _Boom as exc:
        return ("error", str(exc))


#: the namespaces of tests/test_constrained.py (the first six flags only,
#: so the getattr defaults are taken) and of test_frontier.py /
#: test_implicit.py (every flag)
SHORT = dict(grad=0, area_budget=None, power_budget=None,
             constraint_mode=None, opt_links=False, joint=False)
FULL = dict(SHORT, budget_sweep=None, area_envelope=None, pack=0, pack_gen=0,
            sensitivities=False, bilevel=None)

VALIDATE = [
    # tests/test_constrained.py
    ("short", {}), ("short", dict(grad=5, area_budget=1.0)),
    ("short", dict(grad=5, joint=True)),
    ("short", dict(grad=5, area_budget=0.0)), ("short", dict(area_budget=1.0)),
    ("short", dict(joint=True)), ("short", dict(grad=5, opt_links=True)),
    ("short", dict(grad=5, constraint_mode="lagrangian")),
    ("short", dict(grad=5, joint=True, area_budget=1.0, opt_links=True)),
    ("short", dict(grad=5, joint=True, area_budget=1.0,
                   constraint_mode="lagrangian")),
    # tests/test_frontier.py
    ("full", dict(grad=5, budget_sweep="0.5:1.5:3")),
    ("full", dict(grad=5, area_envelope="hbm_bw=0.8")),
    ("full", dict(budget_sweep="0.5:1.5:3")),
    ("full", dict(area_envelope="hbm_bw=0.8")),
    ("full", dict(grad=5, budget_sweep="0.5:1.5:3", area_budget=1.0)),
    ("full", dict(grad=5, budget_sweep="0.5:1.5:3", opt_links=True)),
    ("full", dict(grad=5, budget_sweep="0.5:1.5:3",
                  constraint_mode="lagrangian")),
    ("full", dict(grad=5, joint=True, area_envelope="hbm_bw=0.8")),
    # tests/test_implicit.py
    ("full", dict(grad=5, bilevel=-1.0)), ("full", dict(bilevel=0.4)),
    ("full", dict(grad=5, bilevel=0.4, area_budget=0.2)),
    ("full", dict(grad=5, bilevel=0.4, joint=True)),
    ("full", dict(grad=5, bilevel=0.4, pack=2)),
    ("full", dict(sensitivities=True)),
    ("full", dict(grad=5, sensitivities=True)),
    ("full", dict(grad=5, sensitivities=True, joint=True, area_budget=0.2)),
    ("full", dict(grad=5, bilevel=0.4)),
    ("full", dict(grad=5, bilevel=0.4, sensitivities=True)),
    ("full", dict(grad=5, bilevel=0.4, area_envelope={"hbm_bw": 0.5})),
    ("full", dict(grad=5, sensitivities=True, area_budget=0.2)),
    ("full", dict(grad=5, sensitivities=True, budget_sweep=[0.1, 0.2])),
    # packing and the rest of the rules
    ("full", dict(pack=-1)), ("full", dict(pack_gen=-1)),
    ("full", dict(pack=4, area_budget=2.0)),
    ("full", dict(pack=4, grad=5)), ("full", dict(pack=4, opt_links=True)),
    ("full", dict(power_budget=-1.0, grad=5)),
    ("full", dict(grad=5, bilevel=0.4, budget_sweep=[0.1, 0.2])),
    ("full", dict(grad=5, constraint_mode="projected", power_budget=1.0)),
]


@pytest.mark.parametrize("base,kw", VALIDATE,
                         ids=[f"{b}-{i}" for i, (b, _) in enumerate(VALIDATE)])
def test_validate_codesign_args_matches_reference(RH, base, kw):
    ns = dict(SHORT if base == "short" else FULL, **kw)
    got = _outcome(HC.validate_codesign_args, types.SimpleNamespace(**ns))
    want = _outcome(RH.validate_codesign_args, types.SimpleNamespace(**ns))
    assert got == want


BUDGET_SWEEPS = [None, "0.5:1.5:3", "0.1:0.9:5", "1e-1:2:2", "nope", "1:2",
                 "0:1:4", "2:1:4", "0.5:1.5:1", "a:b:3", "1:2:x"]
ENVELOPES = [None, "peak_flops=1.5, hbm_bw=0.8", "hbm_bw=0.5",
             "ici_bw_total=1,inter_pod_bw=2", "peak_flops", "peak_flops=x",
             "sram=1.0", "hbm_bw=0", "hbm_bw=-1"]


@pytest.mark.parametrize("spec", BUDGET_SWEEPS)
def test_parse_budget_sweep_matches_reference(RH, spec):
    assert (_outcome(HC.parse_budget_sweep, spec)
            == _outcome(RH.parse_budget_sweep, spec))


@pytest.mark.parametrize("spec", ENVELOPES)
def test_parse_area_envelope_matches_reference(RH, spec):
    assert (_outcome(HC.parse_area_envelope, spec)
            == _outcome(RH.parse_area_envelope, spec))


# --------------------------------------------------------------------------- #
# the analytic kernel terms, every registry arch at full width
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_analytic_kernel_terms_match_reference(RH, arch):
    from repro import configs as RC
    from repro.configs.shapes import SHAPES as R_SHAPES

    for smoke in (False, True):
        cfg, rcfg = C.get_config(arch, smoke=smoke), RC.get_config(arch, smoke=smoke)
        assert HC.attention_layers(cfg) == RH.attention_layers(rcfg)
        for name in SHAPES:
            shape, rshape = SHAPES[name], R_SHAPES[name]
            for n_dev in (1, 256):
                assert (HC.flash_kernel_bytes_per_layer(cfg, shape, n_dev)
                        == RH.flash_kernel_bytes_per_layer(rcfg, rshape, n_dev))
                if cfg.ssm is not None:
                    assert (HC.scan_kernel_bytes_per_layer(cfg, shape, n_dev)
                            == RH.scan_kernel_bytes_per_layer(rcfg, rshape, n_dev))
        # the port's profile is one device: n_dev defaults to 1
        assert (HC.flash_kernel_bytes_per_layer(cfg, SHAPES["train_4k"])
                == RH.flash_kernel_bytes_per_layer(rcfg, R_SHAPES["train_4k"], 1))


# --------------------------------------------------------------------------- #
# candidates and the sweep
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,seed", [(0, 0), (5, 0), (64, 3), (257, 11)])
def test_machine_candidates_match_reference(RH, n, seed):
    got, want = HC.machine_candidates(n, seed), RH.machine_candidates(n, seed)
    assert list(got.names) == list(want.names)
    for f in MACHINE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def _ref_profile(p):
    from repro.core import WorkloadProfile as RW

    return RW.from_json(p.to_json())


SWEEP_SUITE = P.resolve_suite("zoo-smoke") + P.resolve_suite("gen:2")


@pytest.mark.parametrize("i", range(len(SWEEP_SUITE)),
                         ids=[p.name for p in SWEEP_SUITE])
def test_codesign_sweep_matches_reference(RH, i):
    p = SWEEP_SUITE[i]
    got = HC.codesign_sweep(p, 257, seed=1, device="cpu")
    want = RH.codesign_sweep(_ref_profile(p), 257, seed=1, backend="numpy")
    assert (got.pop("backend"), want.pop("backend")) == ("torch", "numpy")
    assert_blob_close(json_round_trip(got), json_round_trip(want), SWEEP_RTOL)


# --------------------------------------------------------------------------- #
# the launcher end to end (smoke config), and its co-design wrappers
# --------------------------------------------------------------------------- #

SMOKE_ARGS = ["--arch", "chatglm3-6b", "--shape", "zoo_smoke_train_s128_b8",
              "--smoke", "--mesh", "1x1", "--extract-device", "cpu", "--device", "cpu"]
MAIN_CODESIGN = ["--sweep", "64", "--grad", "5", "--area-budget", "0.3",
                 "--sensitivities"]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The port's launcher on a smoke cell: its JSON and the substituted
    profile without the co-design entries."""
    out = tmp_path_factory.mktemp("hillclimb")
    assert HC.main(SMOKE_ARGS + MAIN_CODESIGN + ["--out", str(out)]) == 0
    path = out / "chatglm3-smoke__zoo_smoke_train_s128_b8__1x1__flash.json"
    with open(path) as f:
        blob = json.load(f)
    profile = WorkloadProfile.from_json(blob)
    profile.meta = {k: v for k, v in profile.meta.items()
                    if k not in ("codesign_sweep", "grad_codesign")}
    return blob, profile


#: case -> (wrapper, args, keywords, bilevel defaults)
CASES = {
    "main-grad": ("codesign_grad", [5], dict(area_budget=0.3,
                                              sensitivities=True), None),
    "grad": ("codesign_grad", [15], dict(lr=0.2), None),
    "grad-area-sensitivities": ("codesign_grad", [15],
                                dict(area_budget=0.1, sensitivities=True), None),
    "grad-lagrangian": ("codesign_grad", [10],
                        dict(area_budget=0.2, constraint_mode="lagrangian"), None),
    "grad-power-envelope-links": (
        "codesign_grad", [5], dict(power_budget=0.5, area_envelope={"hbm_bw": 0.8},
                                   opt_links=True, sensitivities=True), None),
    "frontier": ("codesign_frontier", [[0.1, 0.2, 0.4]], dict(steps=10), None),
    "pack": ("codesign_pack", [2], dict(gen=7, lr=0.1, area_budget=1.0), None),
    "bilevel": ("codesign_bilevel", [0.35, 1], {},
                {"outer_steps": 1, "projection": "shift"}),
    "joint": ("codesign_joint", [10], dict(area_budget=0.3), None),
}
#: the co-tenants of the joint case's group (profiles of one app under
#: other shardings in the JAX package; here any two profiles)
JOINT_GROUP = P.resolve_suite("gen:2")


@pytest.fixture(scope="module")
def reference(launched, tmp_path_factory):
    profile = launched[1]
    cases = {}
    for name, (fn, args, kw, defaults) in CASES.items():
        group = [profile] + (JOINT_GROUP if fn == "codesign_joint" else [])
        case = {"entry": "hillclimb", "fn": fn, "args": args, "kwargs": kw,
                "profiles": [p.to_json() for p in group]}
        if defaults:
            case["bilevel_defaults"] = defaults
        cases[name] = case
    return run_reference(cases, tmp_path_factory.mktemp("ref_hillclimb"))


def _port_call(name, profile, monkeypatch):
    fn, args, kw, defaults = CASES[name]
    if defaults:
        from repro_torch.core import implicit as PI
        for k, v in defaults.items():
            monkeypatch.setitem(PI._BILEVEL_DEFAULTS, k, v)
    first = [profile] + JOINT_GROUP if fn == "codesign_joint" else profile
    return getattr(HC, fn)(first, *args, device="cpu", **kw)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0]
                                  in ("codesign_grad", "codesign_joint")])
def test_grad_wrappers_match_reference(launched, reference, monkeypatch, case):
    got = _port_call(case, launched[1], monkeypatch)
    want = reference[case][1]["to_json"]
    assert_blob_close(json_round_trip(got), want, THETA_RTOL)
    for g, w in zip(got["variants"], want["variants"]):
        np.testing.assert_allclose(g["objective_final"], w["objective_final"],
                                   rtol=RTOL)


def test_frontier_wrapper_matches_reference(launched, reference, monkeypatch):
    res = _port_call("frontier", launched[1], monkeypatch)
    ref, blob = reference["frontier"]
    np.testing.assert_array_equal(res.budgets, ref["budgets"])
    np.testing.assert_array_equal(res.feasible, ref["feasible"])
    np.testing.assert_allclose(res.objective, ref["objective"], rtol=RTOL)
    np.testing.assert_allclose(params_array(res.best_params), ref["best_params"],
                               rtol=THETA_RTOL)
    assert list(res.best_names) == blob["best_names"]
    assert_blob_close(json_round_trip(res.to_json()), blob["to_json"], THETA_RTOL)


def test_pack_wrapper_matches_reference(launched, reference, monkeypatch):
    res = _port_call("pack", launched[1], monkeypatch)
    ref, blob = reference["pack"]
    assert list(res.app_names) == blob["app_names"]
    assert res.app_names[0] == launched[1].name
    np.testing.assert_array_equal(res.assignment, ref["assignment"])
    np.testing.assert_allclose(res.trajectory, ref["trajectory"], rtol=RTOL)
    np.testing.assert_allclose(params_array(res.final_params), ref["final_params"],
                               rtol=THETA_RTOL)
    assert res.feasible == blob["feasible"]
    assert_blob_close(json_round_trip(res.to_json()), blob["to_json"], THETA_RTOL)


def test_bilevel_wrapper_matches_reference(launched, reference, monkeypatch):
    res = _port_call("bilevel", launched[1], monkeypatch)
    ref, blob = reference["bilevel"]
    assert res.outer_steps == 1
    for f in ("split_trajectory", "objective_trajectory", "objective_uniform"):
        np.testing.assert_allclose(getattr(res, f), ref[f], rtol=RTOL, err_msg=f)
    np.testing.assert_allclose(params_array(res.inner.final_params),
                               ref["inner_final_params"], rtol=THETA_RTOL)
    assert_blob_close(json_round_trip(res.to_json()), blob["to_json"], THETA_RTOL)


def test_main_writes_the_reference_keys_and_the_substituted_bytes(RH, launched,
                                                                   reference):
    blob, profile = launched
    meta = blob["meta"]
    assert blob["name"] == "chatglm3-smoke/zoo_smoke_train_s128_b8@1x1+flash"
    assert {"flash_substitution", "codesign_sweep", "grad_codesign"} <= set(meta)
    assert set(meta["flash_substitution"]) == {"removed_bytes", "added_bytes",
                                               "layers"}
    cfg = C.get_config("chatglm3-6b", smoke=True)
    shape = resolve_shape("zoo_smoke_train_s128_b8")
    sub = meta["flash_substitution"]
    L = HC.attention_layers(cfg)
    assert sub["layers"] == L
    assert sub["added_bytes"] == HC.flash_kernel_bytes_per_layer(cfg, shape) * L
    np.testing.assert_allclose(
        sub["removed_bytes"],
        HC.quadratic_attention_bytes(cfg, shape, device="cpu") / 2.0 * L,
        rtol=FIT_RTOL)
    h = run_cell(cfg, shape, device="cpu").hbm_bytes
    assert blob["hbm_bytes"] == max(h - sub["removed_bytes"] + sub["added_bytes"],
                                    sub["added_bytes"])
    # the sweep entry is the JAX wrapper's on the same profile (NumPy)
    want = RH.codesign_sweep(_ref_profile(profile), 64, seed=0, backend="numpy")
    got = dict(meta["codesign_sweep"])
    assert (got.pop("backend"), want.pop("backend")) == ("torch", "numpy")
    assert_blob_close(got, json_round_trip(want), SWEEP_RTOL)
    # the grad entry is the JAX wrapper's on the same profile
    assert_blob_close(meta["grad_codesign"], reference["main-grad"][1]["to_json"],
                      THETA_RTOL)


# --------------------------------------------------------------------------- #
# the probes: an exact fit, and the S^2 term against a count by hand
# --------------------------------------------------------------------------- #


def _smoke(arch, kind, seq=64, batch=2):
    return C.get_config(arch, smoke=True), ShapeSpec(f"probe_{kind}", seq, batch, kind)


@pytest.mark.parametrize("arch,kind", [
    ("chatglm3-6b", "train"), ("chatglm3-6b", "prefill"),
    ("chatglm3-6b", "decode"), ("whisper-medium", "prefill"),
    ("recurrentgemma-9b", "prefill")])
def test_the_probe_fit_is_exact(arch, kind):
    cfg, shape = _smoke(arch, kind)
    S, B = shape.seq_len, shape.global_batch
    ss = np.array([S, S // 2, S // 4], dtype=np.float64)
    hs = [HC._probe_hbm(cfg, shape, int(s), B) for s in ss]
    coeffs = np.polyfit(ss, hs, 2)
    h8 = HC._probe_hbm(cfg, shape, S // 8, B)
    np.testing.assert_allclose(np.polyval(coeffs, S // 8), h8, rtol=FIT_RTOL)
    np.testing.assert_allclose(HC.quadratic_attention_bytes(cfg, shape),
                               max(coeffs[0], 0.0) * S * S, rtol=1e-12)
    if kind == "decode":
        # 1 x T scores: nothing is quadratic in S
        assert coeffs[0] * S * S < FIT_RTOL * h8


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_the_scan_probe_is_linear_in_the_state_dim(kind):
    """At falcon-mamba's N 16 (the smoke config's 4 would reach N/4 = 1,
    where size-1 dims broadcast and the train step's counts change form)."""
    import dataclasses

    cfg, shape = _smoke("falcon-mamba-7b", kind)
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, state_dim=16))
    N, S, B = cfg.ssm.state_dim, shape.seq_len, shape.global_batch
    h = [HC._probe_hbm(cfg, shape, S, B, state_dim=n) for n in (N, N // 2, N // 4)]
    np.testing.assert_allclose(h[0] - h[1], 2.0 * (h[1] - h[2]), rtol=FIT_RTOL)
    np.testing.assert_allclose(HC.scan_state_bytes(cfg, shape),
                               (h[0] - h[1]) / (N - N // 2) * N, rtol=1e-12)
    assert h[0] > h[1] > h[2]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("seq,batch", [(96, 2), (64, 3)])
def test_the_fitted_score_term_equals_the_count_by_hand(kind, seq, batch):
    cfg, shape = _smoke("chatglm3-6b", kind, seq, batch)
    quad2 = HC.quadratic_attention_bytes(cfg, shape)
    per_layer = chip_smoke().attention_score_bytes(cfg, shape)
    np.testing.assert_allclose(quad2, 2.0 * per_layer, rtol=FIT_RTOL)


@pytest.mark.parametrize("state_dim", [4, 16])
@pytest.mark.parametrize("seq,batch", [(96, 2), (64, 3)])
def test_the_measured_state_term_equals_the_count_by_hand(state_dim, seq, batch):
    import dataclasses

    cfg, shape = _smoke("falcon-mamba-7b", "decode", seq, batch)
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, state_dim=state_dim))
    per_layer = chip_smoke().scan_state_bytes_by_hand(cfg, shape)
    np.testing.assert_allclose(HC.scan_state_bytes(cfg, shape), 2.0 * per_layer,
                               rtol=FIT_RTOL)


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #


JOINT_ARGS = ["--arch", "chatglm3-6b", "--shape", "zoo_smoke_train_s128_b8",
              "--smoke", "--mesh", "2x2", "--device", "cpu", "--joint"]


@pytest.mark.parametrize("extra", [[], ["--grad", "5"],
                                   ["--grad", "5", "--area-budget", "1.0"]])
def test_joint_runs_on_a_small_mesh(tmp_path, extra):
    """``--joint`` profiles the cell per device under tp / zero1 / fsdp on a
    (2, 2) mesh (in its own process: the fake world owns it) and descends
    over the three; without ``--grad`` it is refused as in the JAX
    launcher."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", *JOINT_ARGS,
         *extra, "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    if not extra:
        assert out.returncode == 2 and "--joint" in out.stderr, out.stderr[-2000:]
        return
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "joint codesign over 3 shardings" in out.stdout
    prof = WorkloadProfile.load(str(
        tmp_path / "chatglm3-smoke__zoo_smoke_train_s128_b8__2x2__zero1__flash.json"))
    assert prof.num_devices == 4 and prof.total_collective_bytes > 0
    jd = prof.meta["joint_codesign"]
    assert len(jd["selection"]) == len(jd["variants"]) == 3
    for v in jd["variants"]:
        assert v["objective_final"] <= v["objective_seed"] + 1e-12
    if "--area-budget" in extra:
        assert jd["feasibility"]["area_budget"] == 1.0


@pytest.mark.parametrize("arch,mode,msg", [
    ("falcon-mamba-7b", "flash",
     "arch is attention-free; flash substitution not applicable"),
    ("chatglm3-6b", "scan", "arch has no SSM; scan substitution not applicable")])
def test_a_mode_the_arch_lacks_returns_1_with_the_reference_message(
        RH, capsys, arch, mode, msg):
    assert HC.main(["--arch", arch, "--shape", "train_4k", "--mode", mode,
                    "--device", "cpu"]) == 1
    assert capsys.readouterr().out.strip() == msg
    assert msg in inspect.getsource(RH.main)


def test_a_pallas_config_is_refused():
    cfg, shape = _smoke("chatglm3-6b", "prefill")
    kernel = cfg.replace(attn_impl="pallas")
    with pytest.raises(ValueError, match="ctypes"):
        HC.quadratic_attention_bytes(kernel, shape)
    ssm, sshape = _smoke("falcon-mamba-7b", "prefill")
    with pytest.raises(ValueError, match="ctypes"):
        HC.scan_state_bytes(ssm.replace(attn_impl="pallas"), sshape)


@pytest.mark.parametrize("flag", [["--mesh", "16x16"], ["--variant", "tp"], None])
def test_a_flag_of_the_multi_device_launcher_is_refused_at_parse_time(capsys, flag):
    """A mesh needs the dry run's device (SMOKE_ARGS extract on the CPU),
    and ``--variant`` needs a mesh.  Without ``--mesh 1x1`` (``None``) the
    launcher takes the pod mesh, as the JAX launcher defaults to it, and
    refuses the CPU's extraction the same way."""
    argv = SMOKE_ARGS + flag if flag else [a for a in SMOKE_ARGS if a not in ("--mesh", "1x1")]
    with pytest.raises(SystemExit) as exc:
        HC.main(argv)
    assert exc.value.code == 2
    assert ("--variant shards the cell over a mesh" if flag and flag[0] == "--variant"
            else "placeholder devices exist on meta only") in capsys.readouterr().err


def test_an_unknown_backend_is_refused_at_parse_time(capsys):
    with pytest.raises(SystemExit) as exc:
        HC.main(SMOKE_ARGS + ["--backend", "bogus"])
    assert exc.value.code == 2
    assert "unknown backend" in capsys.readouterr().err


def test_the_defaults_are_the_card_and_the_dry_run():
    sig = inspect.signature
    for fn in (HC.codesign_sweep, HC.codesign_grad, HC.codesign_frontier,
               HC.codesign_pack, HC.codesign_bilevel, HC.codesign_joint):
        assert sig(fn).parameters["device"].default == "cuda"
    for fn in (HC._probe_hbm, HC.quadratic_attention_bytes, HC.scan_state_bytes):
        assert sig(fn).parameters["device"].default == "meta"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HC.codesign_sweep(SWEEP_SUITE[0], 4)


# --------------------------------------------------------------------------- #
# R14: the flash substitution credits layers where K5 never runs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_attention_layers_over_credits_as_the_reference_does(RH, monkeypatch, arch):
    """Both packages count the AUDIO family's encoder and cross-attention
    layers and every VLM layer, while K5 (the JAX package's gate, which the
    port keeps: causal self-attention, no kv_x, no prefix) runs only in the
    audio decoder's self-attention and never under the VLM's prefix; so
    ``added`` credits kernel traffic that ``removed`` never took out."""
    import torch

    from repro import configs as RC
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T

    full, rfull = C.get_config(arch), RC.get_config(arch)
    credited = {"whisper-medium": 2 * full.n_layers + full.n_encoder_layers,
                "paligemma-3b": full.n_layers}[arch]
    assert HC.attention_layers(full) == RH.attention_layers(rfull) == credited

    cfg = C.get_config(arch, smoke=True).replace(attn_impl="pallas")
    calls = []
    plain = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
    if arch == "whisper-medium":
        batch["frames"] = torch.zeros((2, cfg.encoder_seq_len, cfg.d_model))
    else:
        batch["patches"] = torch.zeros((2, cfg.n_vision_tokens, cfg.d_model))
    T.forward(model, cfg, batch)
    runs_k5 = {"whisper-medium": cfg.n_layers, "paligemma-3b": 0}[arch]
    assert len(calls) == runs_k5
    assert HC.attention_layers(cfg) > runs_k5

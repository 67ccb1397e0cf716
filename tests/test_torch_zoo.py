"""The port's model zoo (extraction half) against the JAX package's, on the
CPU.

* ``zoo_cells`` order and ``cell_fingerprint`` equal the JAX package's for
  all 120 full cells and the 6 smoke cells (the digests are the JAX
  package's: the same config ``repr``, shape, scenario and version);
* ``calibration_report`` with the port's float64 torch backend equals the
  JAX package's with its NumPy backend to 1e-9 (the same float64 math);
  ``to_json`` and ``markdown`` are equal but for the backend's name;
* the smoke cells extracted on the CPU: ``model_flops``, ``tokens``,
  ``params``, ``params_active`` and ``num_devices`` equal the JAX package's
  goldens exactly; every count on ``meta`` equals the CPU run's exactly;
  ``dot_flops`` equals the JAX package's calibrated extraction
  (``extract_profile(cell, calibrate=True)``) exactly where both programs
  run the same matmuls -- chatglm3's three cells and falcon-mamba's
  decode.  falcon-mamba's prefill and train differ by a pinned amount: the
  JAX package's scan computes ``y_t = einsum(h_t, C_t)`` inside the
  ``lax.scan`` over time, whose body XLA counts once, so its count holds 1
  of the S per-step dots of each layer (and 1 of the backward's 2 x S; the
  other backward product of the outer-product einsum is elementwise
  there), where the port counts all of them: the port's count is
  higher by 2 B Din N L x (S - 1) in prefill and x (3 S - 2) in train;
* a small MoE (qwen2-moe's smoke config) counts the same on ``meta`` as on
  the CPU under the default ``gmm`` dispatch (every expert gets rows); the
  tracker's peak, which follows the split's temporaries, within 1e-3;
* full cells (chatglm3-6b's decode grid) extract per device on the pod
  mesh, as the JAX package's do, and as one device only when asked;
* the port's checked-in goldens (``zoo_cache_torch/``) are fresh: their
  fingerprints match and a re-extraction on ``meta`` under the torch
  version that wrote them is byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import model_zoo as RZ

import repro_torch.core as P
from repro_torch import configs as C
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import model_zoo as PZ
from repro_torch.core import roofline as PR
from repro_torch.launch.extract import run_cell

CAL_RTOL = 1e-9
IDENTITY = ("model_flops", "tokens", "params", "params_active", "num_devices")
COUNTS = ("dot_flops", "dot_count", "flops", "transcendentals", "bytes_accessed",
          "hbm_bytes", "argument_bytes", "output_bytes", "peak_memory_bytes",
          "temp_bytes")
SMOKE_KEYS = [c.cache_key for c in PZ.zoo_cells(smoke=True)]


def _cell(key):
    return next(c for c in PZ.zoo_cells(smoke=True) if c.cache_key == key)


# --------------------------------------------------------------------------- #
# Cells and fingerprints
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("smoke", [False, True])
def test_cells_and_fingerprints_match_reference(smoke):
    ref, port = RZ.zoo_cells(smoke=smoke), PZ.zoo_cells(smoke=smoke)
    assert len(port) == (6 if smoke else 120)
    assert [(c.arch, c.scenario, dataclasses.asdict(c.shape), c.name, c.cache_key)
            for c in port] == [
        (c.arch, c.scenario, dataclasses.asdict(c.shape), c.name, c.cache_key)
        for c in ref]
    assert [PZ.cell_fingerprint(c) for c in port] == [RZ.cell_fingerprint(c) for c in ref]
    # and they name the goldens the JAX package wrote
    if smoke:
        for c in port:
            with open(RZ.cache_path(c, RZ.SMOKE_CACHE_DIR)) as f:
                assert json.load(f)["meta"]["fingerprint"] == PZ.cell_fingerprint(c)


def test_zoo_cells_validate_scenarios_and_filter():
    with pytest.raises(ValueError):
        PZ.zoo_cells(scenarios=("bogus",))
    cells = PZ.zoo_cells(archs=("whisper-medium",), scenarios=("serve-decode",))
    assert [c.shape.name for c in cells] == [
        c.shape.name for c in RZ.zoo_cells(archs=("whisper-medium",),
                                           scenarios=("serve-decode",))]


# --------------------------------------------------------------------------- #
# Calibration report
# --------------------------------------------------------------------------- #


def _suites():
    smoke = RZ.resolve_suite("zoo-smoke")
    gen = R.resolve_suite("gen:24:seed=5")
    return {"zoo-smoke": smoke, "gen": gen}


@pytest.mark.parametrize("timing", ["serial", "overlap"])
@pytest.mark.parametrize("machine", [0, 1])
@pytest.mark.parametrize("suite", ["zoo-smoke", "gen"])
def test_calibration_report_matches_reference(suite, machine, timing):
    ref_profiles = _suites()[suite]
    port_profiles = [P.WorkloadProfile.from_json(p.to_json()) for p in ref_profiles]
    rm, pm = R.VARIANTS[machine], P.VARIANTS[machine]
    assert rm.name == pm.name
    want = RZ.calibration_report(ref_profiles, rm, backend="numpy", timing_model=timing)
    got = PZ.calibration_report(port_profiles, pm, backend="torch", timing_model=timing,
                                device="cpu")
    assert (want.backend, got.backend) == ("numpy", "torch")
    for a, b in zip(got.cells, want.cells):
        assert (a.name, a.scenario, a.dominant_eq1, a.dominant_roofline) == (
            b.name, b.scenario, b.dominant_eq1, b.dominant_roofline)
        for f in ("eq1_s", "roofline_s", "ratio"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=CAL_RTOL)
    assert got.dominant_agreement == want.dominant_agreement
    assert [c.name for c in got.worst_offenders()] == [c.name for c in want.worst_offenders()]
    gj, wj = got.to_json(), want.to_json()
    assert gj.pop("backend") == "torch" and wj.pop("backend") == "numpy"
    for cg, cw in zip(gj.pop("cells"), wj.pop("cells")):
        for k in cw:
            if isinstance(cw[k], float):
                np.testing.assert_allclose(cg[k], cw[k], rtol=CAL_RTOL)
            else:
                assert cg[k] == cw[k]
    assert gj == wj
    assert got.markdown(top_k=4) == want.markdown(top_k=4).replace(
        "numpy backend", "torch backend")


# --------------------------------------------------------------------------- #
# Extraction of the smoke cells
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def extracted():
    out = {}
    for cell in PZ.zoo_cells(smoke=True):
        out[cell.cache_key] = {dev: PZ.extract_profile(cell, device=dev)
                               for dev in ("meta", "cpu")}
    return out


@pytest.fixture(scope="module")
def calibrated():
    """The JAX package's calibrated extraction of the smoke cells (depth
    probes: every layer counted)."""
    return {c.cache_key: RZ.extract_profile(c, calibrate=True)
            for c in RZ.zoo_cells(smoke=True)}


def _golden(key):
    with open(os.path.join(RZ.SMOKE_CACHE_DIR, key + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("key", SMOKE_KEYS)
def test_smoke_identity_fields_equal_the_reference_goldens(extracted, key):
    gold = _golden(key)
    for dev, p in extracted[key].items():
        for f in IDENTITY:
            assert getattr(p, f) == gold[f], (dev, f)
        assert p.model_flops == PR.model_flops_for(
            params_active=p.params_active, tokens=p.tokens,
            step_kind="train" if p.step_kind == "train" else "infer")
        assert p.total_collective_bytes == 0.0 and p.pod_collective_bytes == 0.0
        assert p.meta["device"] == dev and p.meta["fingerprint"] == gold["meta"]["fingerprint"]


@pytest.mark.parametrize("key", SMOKE_KEYS)
def test_meta_counts_equal_cpu_counts(extracted, key):
    meta, cpu = extracted[key]["meta"], extracted[key]["cpu"]
    for f in COUNTS:
        assert getattr(meta, f) == getattr(cpu, f), f
    assert meta.meta["aten_ops"] == cpu.meta["aten_ops"]
    assert meta.dot_flops > 0 and meta.hbm_bytes > meta.argument_bytes > 0
    assert meta.flops >= meta.dot_flops and meta.peak_memory_bytes >= meta.argument_bytes


def _scan_dot_gap(key):
    """The port's dot_flops above the JAX package's calibrated count (module
    docstring): 0 but for falcon-mamba's prefill and train."""
    cell = _cell(key)
    cfg, shape = cell.config, cell.shape
    if cfg.ssm is None or shape.kind == "decode":
        return 0.0
    unit = 2.0 * shape.global_batch * cfg.ssm.expand * cfg.d_model * cfg.ssm.state_dim \
        * cfg.n_layers
    steps = shape.seq_len - 1 if shape.kind == "prefill" else 3 * shape.seq_len - 2
    return unit * steps


@pytest.mark.parametrize("key", SMOKE_KEYS)
def test_dot_flops_equal_the_calibrated_reference(extracted, calibrated, key):
    got = extracted[key]["cpu"].dot_flops
    want = calibrated[key].dot_flops
    gap = _scan_dot_gap(key)
    assert got - want == gap
    if key.startswith("chatglm3") or "decode" in key:
        assert got == want
    # the checked-in goldens count one layer of the two-layer stack (R11)
    assert _golden(key)["dot_flops"] < want


def test_moe_counts_on_meta_equal_a_cpu_run():
    """qwen2-moe's smoke config (8 experts, top 4): on ``meta`` the T*k rows
    are split evenly over the experts; a real run's split differs, its
    counts do not (every expert gets rows here)."""
    cfg = C.get_config("qwen2-moe-a2.7b", smoke=True)
    for shape in (ShapeSpec("moe_train", 16, 4, "train"),
                  ShapeSpec("moe_prefill", 32, 2, "prefill")):
        meta = run_cell(cfg, shape, device="meta")
        cpu = run_cell(cfg, shape, device="cpu", seed=3)
        for f in COUNTS[:-2]:
            assert getattr(meta, f) == getattr(cpu, f), (shape.name, f)
        # the per-expert temporaries live at the split's sizes: the peak
        # moves with the routing (by 1.4e-4 here), the counts do not
        assert abs(meta.peak_memory_bytes - cpu.peak_memory_bytes) <= \
            1e-3 * cpu.peak_memory_bytes
    # under capacity dispatch the experts' matmuls still count alike
    cap = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="capacity"))
    shape = ShapeSpec("moe_prefill", 32, 2, "prefill")
    assert run_cell(cap, shape, device="meta").dot_flops == \
        run_cell(cap, shape, device="cpu").dot_flops


# --------------------------------------------------------------------------- #
# The port's own caches
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("key", SMOKE_KEYS)
def test_port_goldens_are_fresh(extracted, key):
    cell = _cell(key)
    path = PZ.cache_path(cell, PZ.SMOKE_CACHE_DIR)
    with open(path, "rb") as f:
        on_disk = f.read()
    gold = json.loads(on_disk)
    assert gold["meta"]["fingerprint"] == PZ.cell_fingerprint(cell)
    assert gold["meta"]["device"] == "meta" and gold["meta"]["extractor"] == "OpCounter"
    fresh = extracted[key]["meta"]
    if gold["meta"]["torch_version"] == torch.__version__:
        assert PZ.canonical_profile_bytes(fresh) == on_disk
    else:   # another torch: the counts must still hold
        for f in COUNTS + IDENTITY:
            assert getattr(fresh, f) == gold[f], f


def test_smoke_suite_loads_from_the_port_cache():
    got = PZ.profiles_from_configs(smoke=True, extract_missing=False)
    assert [p.meta["fingerprint"] for p in got] == [
        PZ.cell_fingerprint(c) for c in PZ.zoo_cells(smoke=True)]


def test_full_cells_extract_on_meta_and_resolve_cache_only(tmp_path, monkeypatch):
    """chatglm3-6b's four decode cells at published width on ``meta``, per
    device on the pod mesh under the default variant (zero1), as the JAX
    package extracts its full cells; then the cache-only ``zoo`` suite
    reads them back."""
    got = PZ.profiles_from_configs(archs=("chatglm3-6b",), scenarios=("serve-decode",),
                                   cache_dir=str(tmp_path), device="meta")
    ref_cells = RZ.zoo_cells(archs=("chatglm3-6b",), scenarios=("serve-decode",))
    total, active = C.get_config("chatglm3-6b").param_counts()
    for p, c in zip(got, ref_cells):
        assert p.meta["fingerprint"] == RZ.cell_fingerprint(c)
        assert (p.params, p.params_active, p.tokens) == (total, active, c.shape.global_batch)
        assert p.model_flops == 2.0 * active * c.shape.global_batch
        assert (p.num_devices, p.mesh, p.meta["variant"]) == (256, "pod16x16", "zero1")
        assert p.total_collective_bytes > 0 and p.pod_collective_bytes == 0
        assert p.dot_flops * p.num_devices > 2.0 * active * c.shape.global_batch * 0.9
    again = PZ.profiles_from_configs(archs=("chatglm3-6b",), scenarios=("serve-decode",),
                                     cache_dir=str(tmp_path), extract_missing=False)
    assert [p.to_json() for p in again] == [p.to_json() for p in got]
    monkeypatch.setattr(PZ, "FULL_CACHE_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="is missing"):
        P.resolve_suite("zoo:serve-decode")   # the other archs are not cached


def test_a_full_cell_runs_as_one_device_only_when_asked():
    """``mesh="1x1"`` profiles a full cell as one device; the pod mesh is
    refused off ``meta`` and beside a model's weights, never run smaller."""
    cell = next(c for c in PZ.zoo_cells(archs=("chatglm3-6b",), scenarios=("serve-decode",)))
    one = PZ.extract_profile(cell, device="meta", mesh="1x1")
    assert (one.num_devices, one.mesh, one.total_collective_bytes) == (1, "1x1", 0.0)
    total, active = C.get_config("chatglm3-6b").param_counts()
    assert one.dot_flops > 2.0 * active * cell.shape.global_batch * 0.9
    for kw in ({"device": "cpu"}, {"device": "meta", "model": object()}):
        with pytest.raises(ValueError, match="meta only"):
            PZ.extract_profile(cell, **kw)


def test_model_zoo_cli_extracts_and_reports(tmp_path, capsys):
    out = str(tmp_path / "cal")
    assert PZ.main(["--smoke", "--device", "cpu", "--cache-dir", str(tmp_path / "c"),
                    "--out", out]) == 0
    assert "6 profiles" in capsys.readouterr().out
    with open(out + ".json") as f:
        rep = json.load(f)
    assert rep["num_cells"] == 6 and rep["backend"] == "torch"
    assert rep["dominant_agreement"] == 1.0
    for name in os.listdir(tmp_path / "c"):
        with open(tmp_path / "c" / name, "rb") as a, \
                open(os.path.join(PZ.SMOKE_CACHE_DIR, name), "rb") as b:
            assert a.read() == b.read() or torch.__version__ != json.loads(
                open(os.path.join(PZ.SMOKE_CACHE_DIR, name)).read())["meta"]["torch_version"]

"""Port sweep path end to end (``run_sweep`` / ``evaluate`` /
``shard_sweep``, plain and streamed, the CLI, suites, checkpoints and
carried state) held against the JAX package's NumPy backend on the same
inputs, with ``device="cpu"`` (the plain float64 version).

What must match: best fits, 2-D and 3-D fronts and ``candidate_indices``
by name; aggregates to 1e-9; populations byte for byte; a resumed
``shard_sweep`` byte for byte with an uninterrupted one; the CLI's JSON
keys.
"""

import json
import os

import numpy as np
import pytest

import repro.core as R
from repro.core import sweep as RS

import repro_torch.core as P
from repro_torch import carry
from repro_torch.checkpoint import store as PSTORE
from repro_torch.core import suites as PSUITES
from repro_torch.core import sweep as PS
from test_torch_backend import (
    F64_TOL,
    assert_result_close,
    both_machines,
    both_profiles,
    port_batches,
    profile_dicts,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synthetic_trio():
    """The synthetic trio of the sweep CLI, for both packages."""
    from repro_torch.launch.sweep import synthetic_profiles

    port = synthetic_profiles()
    ref = [R.WorkloadProfile.from_json(p.to_json()) for p in port]
    return ref, port


def suites(name):
    if name == "trio":
        return synthetic_trio()
    if name == "gen:4":
        from repro.core.model_zoo import resolve_suite

        return resolve_suite("gen:4"), P.resolve_suite("gen:4")
    return both_profiles(profile_dicts(4, seed=5))


def names(res, idx):
    return [res.machines.names[i] for i in idx]


def fronts(res):
    return names(res, res.pareto_front()), names(res, res.pareto_front_3d())


def assert_sharded_equal(a, b):
    np.testing.assert_array_equal(a.candidate_indices, b.candidate_indices)
    assert a.result.machines.names == b.result.machines.names
    np.testing.assert_array_equal(a.result.aggregate, b.result.aggregate)
    assert a.pareto_names() == b.pareto_names()
    assert a.best_fit_map == b.best_fit_map


# --------------------------------------------------------------------------- #
# Suites, profiles and populations
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("suite", ["gen:6", "gen:5:seed=3:mode=rng",
                                   "zoo-smoke", "zoo-smoke:serve-decode"])
def test_suites_resolve_like_the_reference(suite):
    from repro.core.model_zoo import resolve_suite

    ref = resolve_suite(suite)
    port = P.resolve_suite(suite)
    assert [p.to_json() for p in port] == [p.to_json() for p in ref]


def test_suite_grammar_errors(monkeypatch):
    from repro_torch.core import model_zoo as PZOO

    for bad in ("gen", "gen:0", "gen:4:mode=sobol", "zoo:bogus", "nope"):
        with pytest.raises(ValueError):
            P.validate_suite_name(bad)
    # the full zoo is cache-only: a missing entry names the extraction command
    monkeypatch.setattr(PZOO, "FULL_CACHE_DIR", os.path.join(ROOT, "no-such"))
    with pytest.raises(RuntimeError, match="python -m repro_torch.core.model_zoo"):
        P.resolve_suite("zoo:train")
    with pytest.raises(FileNotFoundError, match="checked-in cache"):
        PSUITES.resolve_suite("zoo-smoke", cache_dir=os.path.join(ROOT, "no-such"))


def test_reference_profile_json_loads_unchanged(tmp_path):
    ref_p, _ = both_profiles(profile_dicts(3, seed=9))
    for i, p in enumerate(ref_p):
        path = str(tmp_path / f"p{i}.json")
        p.save(path)
        loaded = P.WorkloadProfile.load(path)
        assert loaded.to_json() == p.to_json()


@pytest.mark.parametrize("dims", [2, 3])
def test_pareto_fronts_match_reference_with_nan_keys(dims):
    """Small integer-valued keys with ties and NaN in the aggregate, the
    area and the power: the port's fronts equal the reference's, in
    membership and in order (with a NaN key the port takes the
    reference's ``sorted`` order instead of ``np.lexsort``)."""
    rng = np.random.default_rng(dims)
    with_nan = 0
    for _ in range(400):
        n = int(rng.integers(1, 14))
        area, power, agg = (rng.integers(0, 4, n).astype(np.float64)
                            for _ in range(3))
        for key in (area, power, agg):
            key[rng.random(n) < 0.15] = np.nan
        with_nan += bool(np.isnan(np.stack([area, power, agg])).any())
        if dims == 2:
            got = PS.pareto_front_indices(area, agg)
            want = RS.pareto_front_indices(area, agg)
        else:
            got = PS.pareto_front_indices_3d(agg, area, power)
            want = RS.pareto_front_indices_3d(agg, area, power)
        assert got == want, (area, power, agg)
        assert all(type(i) is int for i in got)
    assert with_nan > 300


@pytest.mark.parametrize("mode", ["random", "grid"])
def test_population_stream_shards_byte_identical(mode):
    space_r, space_p = RS.ParamSpace.default(), P.ParamSpace.default()
    ref = RS.PopulationStream(space_r, 300, mode=mode, seed=4,
                              include_named=R.VARIANTS)
    port = P.PopulationStream(space_p, 300, mode=mode, seed=4,
                              include_named=P.VARIANTS)
    assert len(port) == len(ref)
    assert port.signature() == ref.signature()
    for lo, hi in ((0, 2), (1, 97), (150, len(ref))):
        a, b = ref.batch(lo, hi), port.batch(lo, hi)
        assert a.names == b.names
        for f in RS.SWEEP_PARAMS:
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
    idx = np.array([0, 5, 2, 211, 1])
    assert port.take(idx).names == ref.take(idx).names


def test_population_saved_by_reference_loads_in_port(tmp_path):
    ref_stream = RS.PopulationStream(RS.ParamSpace.default(), 120, seed=2,
                                     include_named=R.VARIANTS)
    RS.save_population(str(tmp_path / "pop"), ref_stream, shard_size=32)
    loaded = P.load_population(str(tmp_path / "pop"))
    port_full = P.PopulationStream(P.ParamSpace.default(), 120, seed=2,
                                   include_named=P.VARIANTS).materialize()
    got = loaded.materialize()
    assert got.names == port_full.names
    for f in PS.SWEEP_PARAMS:
        assert getattr(got, f).tobytes() == getattr(port_full, f).tobytes()
    P.save_population(str(tmp_path / "pop2"), port_full)
    again = P.load_population(str(tmp_path / "pop2")).materialize()
    assert again.names == port_full.names


def test_carried_batches_score_like_the_reference():
    """State carried across as NumPy (``carry``) scores identically."""
    ref_p, _ = both_profiles(profile_dicts(5, seed=31))
    ref_m, _ = both_machines(40, seed=8)
    ref_pb = RS.ProfileBatch.from_profiles(ref_p)
    pb, mb = port_batches(ref_pb, ref_m)
    for f in carry.PROFILE_FIELDS:
        assert getattr(pb, f).tobytes() == getattr(ref_pb, f).tobytes()
    assert P.ProfileBatch.from_profiles(pb.profiles).flops.tobytes() == \
        ref_pb.flops.tobytes()
    ref = RS.batched_congruence(ref_pb, ref_m, backend="numpy")
    port = P.batched_congruence(pb, mb, device="cpu")
    assert_result_close(port, ref, F64_TOL)
    assert port.machines.names == ref.machines.names


# --------------------------------------------------------------------------- #
# run_sweep / evaluate
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("suite", ["gen:4", "trio", "seeded"])
@pytest.mark.parametrize("timing_model", ["serial", "overlap"])
def test_run_sweep_matches_reference(suite, timing_model):
    ref_p, port_p = suites(suite)
    ref = RS.run_sweep(ref_p, n=300, include_named=R.VARIANTS,
                       timing_model=timing_model, backend="numpy")
    port = P.run_sweep(port_p, n=300, include_named=P.VARIANTS,
                       timing_model=timing_model, device="cpu")
    assert port.machines.names == ref.machines.names
    assert_result_close(port, ref, F64_TOL)
    assert fronts(port) == fronts(ref)
    for app in ref.apps:
        assert port.best_fit(app) == ref.best_fit(app)
    assert names(port, port.top_variants(8)) == names(ref, ref.top_variants(8))
    assert port.seed_codesign(k=6).names == ref.seed_codesign(k=6).names


def test_run_sweep_reports_match_reference():
    ref_p, port_p = suites("trio")
    ref = RS.run_sweep(ref_p, n=40, backend="numpy")
    port = P.run_sweep(port_p, n=40, device="cpu")
    blob_r, blob_p = ref.to_json(top_k=5), port.to_json(top_k=5)
    assert blob_p.keys() == blob_r.keys()
    assert blob_p["backend"] == "torch" and blob_r["backend"] == "numpy"
    for key in ("best_fit", "apps", "num_variants"):
        assert blob_p[key] == blob_r[key]
    assert [r["variant"] for r in blob_p["pareto_front_3d"]] == \
        [r["variant"] for r in blob_r["pareto_front_3d"]]
    assert port.markdown(top_k=5).replace("torch backend", "numpy backend") \
        == ref.markdown(top_k=5)


@pytest.mark.parametrize("method", ["batched", "scalar"])
def test_evaluate_matches_reference(method):
    ref_p, port_p = suites("seeded")
    ref = R.evaluate(ref_p, method=method, backend="numpy")
    port = P.evaluate(port_p, method=method, device="cpu")
    assert port.variants == ref.variants and port.apps == ref.apps
    for app in ref.apps:
        assert port.best_fit(app) == ref.best_fit(app)
        for v in ref.variants:
            assert port._aggregate(app, v) == pytest.approx(
                ref._aggregate(app, v), rel=F64_TOL, abs=F64_TOL)
    cell_r = ref.cell(ref.apps[1], "denser").report.as_dict()
    cell_p = port.cell(ref.apps[1], "denser").report.as_dict()
    assert cell_p.keys() == cell_r.keys()
    for k in ("extended", "scores", "alphas_s"):
        for name in cell_r[k]:
            assert cell_p[k][name] == pytest.approx(cell_r[k][name],
                                                    rel=F64_TOL, abs=F64_TOL)
    assert port.markdown() == ref.markdown()
    assert port.overall_best_fit() == ref.overall_best_fit()


def test_evaluate_through_cuda_backend_stacking_on_cpu():
    """The cuda backend's float32 path (plain version on CPU tensors)
    names the same best fits on the named trio."""
    ref_p, port_p = suites("trio")
    ref = R.evaluate(ref_p, backend="numpy")
    port = P.evaluate(port_p, backend="cuda", device="cpu")
    assert port.result.backend == "cuda"
    for app in ref.apps:
        assert port.best_fit(app) == ref.best_fit(app)


# --------------------------------------------------------------------------- #
# shard_sweep: plain, streamed, resumed
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("suite", ["gen:4", "trio", "seeded"])
@pytest.mark.parametrize("stream", [False, True])
def test_shard_sweep_matches_reference(suite, stream):
    ref_p, port_p = suites(suite)
    kw = dict(n=300, num_shards=5, stream=stream, keep_top=8)
    ref = RS.shard_sweep(ref_p, include_named=R.VARIANTS, backend="numpy",
                         **kw)
    port = P.shard_sweep(port_p, include_named=P.VARIANTS, device="cpu", **kw)
    assert port.mesh_axis == "cpu" and port.streamed == stream
    np.testing.assert_array_equal(port.candidate_indices,
                                  ref.candidate_indices)
    assert port.result.machines.names == ref.result.machines.names
    assert port.pareto_names() == ref.pareto_names()
    assert names(port.result, port.pareto_front_3d()) == \
        names(ref.result, ref.pareto_front_3d())
    assert port.best_fit_map == ref.best_fit_map
    np.testing.assert_allclose(port.result.aggregate, ref.result.aggregate,
                               rtol=F64_TOL, atol=F64_TOL)
    single = RS.run_sweep(ref_p, n=300, include_named=R.VARIANTS,
                          backend="numpy")
    assert port.pareto_names() == fronts(single)[0]


def test_streamed_shard_sweep_byte_identical_to_materialized():
    _, port_p = suites("seeded")
    kw = dict(n=200, include_named=P.VARIANTS, num_shards=4, device="cpu")
    assert_sharded_equal(P.shard_sweep(port_p, stream=True, **kw),
                         P.shard_sweep(port_p, **kw))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_resumed_shard_sweep_byte_identical(tmp_path, backend):
    _, port_p = suites("seeded")
    kw = dict(n=160, stream=True, num_shards=6, backend=backend,
              device="cpu", checkpoint_dir=str(tmp_path / "ck"))

    class Kill(Exception):
        pass

    def die_after_2(s, *_):
        if s >= 2:
            raise Kill

    with pytest.raises(Kill):
        P.shard_sweep(port_p, progress=die_after_2, **kw)
    events = []
    resumed = P.shard_sweep(port_p, resume=True,
                            progress=lambda s, *_: events.append(s), **kw)
    assert resumed.resumed_shards == 3 and events == [3, 4, 5]
    straight = P.shard_sweep(port_p, n=160, stream=True, num_shards=6,
                             backend=backend, device="cpu")
    assert_sharded_equal(resumed, straight)
    assert resumed.markdown(top_k=4) == straight.markdown(top_k=4)
    with pytest.raises(ValueError, match="different sweep configuration"):
        P.shard_sweep(port_p, **{**kw, "seed": 1}, resume=True)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        P.shard_sweep(port_p, n=16, resume=True, device="cpu")


def test_checkpoints_cross_between_packages(tmp_path):
    """The port's store keeps the reference layout: each reads the other's
    sweep checkpoints."""
    from repro.checkpoint import store as RSTORE

    state = {"app_idx": np.arange(3, dtype=np.int64),
             "app_min": np.array([0.5, 0.25, np.inf]),
             "survivors": np.array([4, 9], dtype=np.int64)}
    RSTORE.save(str(tmp_path / "r"), 2, state, extra={"config": "x"})
    got, extra = PSTORE.restore(str(tmp_path / "r"), state)
    assert extra == {"config": "x", "step": 2}
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    PSTORE.save(str(tmp_path / "p"), 1, state, extra={"config": "y"})
    PSTORE.save(str(tmp_path / "p"), 3, state)
    PSTORE.retain(str(tmp_path / "p"), keep=1)
    assert PSTORE.latest_step(str(tmp_path / "p")) == 3
    back, _ = RSTORE.restore(str(tmp_path / "p"), state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #


def _reference_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_sweep_cli", os.path.join(ROOT, "scripts", "sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--shards", "3"],
                                   ["--stream", "--gen", "4"]])
def test_cli_writes_the_reference_json(tmp_path, extra):
    from repro_torch.launch import sweep as cli

    args = ["--num", "60", "--top", "5", "--format", "both", *extra]
    assert _reference_cli().main(args + ["--out", str(tmp_path / "r")]) == 0
    assert cli.main(args + ["--device", "cpu",
                            "--out", str(tmp_path / "p")]) == 0
    ref = json.loads((tmp_path / "r.json").read_text())
    port = json.loads((tmp_path / "p.json").read_text())
    assert sorted(port) == sorted(ref)
    assert port["best_fit"] == ref["best_fit"]
    assert [r["variant"] for r in port["pareto_front"]] == \
        [r["variant"] for r in ref["pareto_front"]]
    assert "pareto front" in (tmp_path / "p.md").read_text()


def test_cli_rejects_bad_arguments(capsys):
    from repro_torch.launch import sweep as cli

    for args in (["--backend", "pallas"], ["--resume"], ["--num", "0"],
                 ["--gen", "3", "--suite", "gen:2"], ["--suite", "zoo:x"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(args + ["--device", "cpu"])
        assert exc.value.code == 2
    assert "unknown backend" in capsys.readouterr().err

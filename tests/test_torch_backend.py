"""Port kernel layer (``repro_torch.core.kernels_xp`` / ``kernels_cuda``)
held against the JAX package on the same NumPy-seeded inputs.

Pinned tolerances:
  * the plain version at float64 == the JAX package's NumPy backend to
    1e-9 (rtol and atol): the same math at the same precision;
  * the plain version at float32, and the ``cuda`` backend's stacking on
    CPU tensors (which runs the plain version), == the Pallas kernels (in
    interpret mode on the CPU, as the JAX package's own tests run them) to
    5e-4, the f32 pin of ``tests/test_backends.py``;
  * the plain sweep statistics (kernel K4's plain version) == NumPy
    mean/min/argmin of the NumPy backend's aggregate: means and minima to
    1e-9, argmin indices exactly (first occurrence on ties).

Kernel launches need a CUDA card: those tests carry the ``cuda`` marker
and skip here with the reason.
"""

import dataclasses
import re
import threading

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import kernels_xp as RK
from repro.core import sweep as RS

import repro_torch.core as P
from repro_torch import carry
from repro_torch.core import _build
from repro_torch.core import kernels_cuda as KC
from repro_torch.core import kernels_xp as PK

F64_TOL = 1e-9
F32_TOL = 5e-4
PROFILE_FIELDS = carry.PROFILE_FIELDS


# --------------------------------------------------------------------------- #
# Shared inputs (NumPy-seeded), imported by the other port test modules
# --------------------------------------------------------------------------- #


def profile_dicts(n, seed):
    """``n`` WorkloadProfile field dicts spanning the bottleneck space."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        coll = {"all-reduce": float(10 ** rng.uniform(6, 12)),
                "all-gather": float(10 ** rng.uniform(5, 11))}
        d = dict(name=f"app{i}",
                 flops=float(10 ** rng.uniform(9, 15)),
                 hbm_bytes=float(10 ** rng.uniform(6, 12)),
                 bytes_accessed=float(10 ** rng.uniform(6, 12)),
                 collective_bytes=coll,
                 num_devices=int(rng.choice([1, 8, 256])),
                 model_flops=(float(10 ** rng.uniform(12, 18))
                              if rng.random() < 0.8 else 0.0))
        if i % 3 == 0:
            d["pod_collective_bytes"] = 0.3 * sum(coll.values())
        if i % 5 == 0:
            d["hbm_bytes"] = 0.0  # the bytes_accessed fallback
        out.append(d)
    return out


def both_profiles(dicts):
    """(reference profiles, port profiles) from the same field dicts."""
    ref = [R.WorkloadProfile(**{**d, "collective_bytes": dict(d["collective_bytes"])})
           for d in dicts]
    port = [P.WorkloadProfile(**{**d, "collective_bytes": dict(d["collective_bytes"])})
            for d in dicts]
    return ref, port


def both_machines(n, seed):
    """(reference, port) MachineBatch: the named trio + ``n`` Halton rows."""
    ref = RS.MachineBatch.concat(RS.MachineBatch.from_models(R.VARIANTS),
                                 RS.ParamSpace.default().sample(n, seed=seed))
    port = P.MachineBatch.concat(P.MachineBatch.from_models(P.VARIANTS),
                                 P.ParamSpace.default().sample(n, seed=seed))
    return ref, port


def port_batches(ref_pb, ref_mb):
    """Carry the reference's packed batches across as NumPy."""
    pb = carry.profiles_from_numpy(
        ref_pb.names, {f: getattr(ref_pb, f) for f in PROFILE_FIELDS})
    mb = carry.machines_from_numpy(
        ref_mb.names, {f: getattr(ref_mb, f) for f in RS.SWEEP_PARAMS})
    return pb, mb


def torch32():
    return PK.TorchBackend("cpu", torch.float32)


def cuda_on_cpu():
    return P.get_backend("cuda", device="cpu")


def assert_result_close(port, ref, tol):
    np.testing.assert_allclose(port.beta, ref.beta, rtol=tol, atol=tol)
    np.testing.assert_allclose(port.gamma, ref.gamma, rtol=tol, atol=tol)
    for k in ref.alphas:
        np.testing.assert_allclose(port.alphas[k], ref.alphas[k],
                                   rtol=tol, atol=tol)
    for k in ref.scores:
        np.testing.assert_allclose(port.scores[k], ref.scores[k],
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(port.aggregate, ref.aggregate,
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# Registry and devices
# --------------------------------------------------------------------------- #


def test_registry_names_and_resolution():
    assert P.available_backends() == ("cuda", "torch")
    be = P.get_backend(device="cpu")
    assert isinstance(be, PK.TorchBackend) and be.dtype == torch.float64
    assert be is P.get_backend("torch", device="cpu")
    assert P.get_backend("cuda", device="cpu").name == "cuda"
    assert P.get_backend(be) is be
    with pytest.raises(ValueError, match="unknown backend"):
        P.get_backend("numpy", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        PK.validate_backend_name("pallas")


def test_default_device_is_cuda_and_never_falls_back():
    """Without ``device=`` the entry points ask for the card; on a host
    without one they raise instead of running on the CPU."""
    dicts = profile_dicts(2, seed=1)
    _, prof = both_profiles(dicts)
    if torch.cuda.is_available():
        assert P.get_backend().name == "cuda"
        return
    for call in (lambda: P.get_backend(),
                 lambda: P.run_sweep(prof, n=8),
                 lambda: P.evaluate(prof),
                 lambda: P.evaluate(prof, method="scalar"),
                 lambda: P.shard_sweep(prof, n=8),
                 lambda: P.batched_step_time(prof, P.VARIANTS),
                 lambda: P.TorchBackend()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------- #
# Plain float64 == the JAX package's NumPy backend (1e-9)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("timing_model", ["serial", "overlap"])
@pytest.mark.parametrize("clamp", [False, True])
def test_plain_f64_congruence_matches_numpy(timing_model, clamp):
    ref_p, port_p = both_profiles(profile_dicts(6, seed=3))
    ref_m, port_m = both_machines(24, seed=1)
    ref = RS.batched_congruence(ref_p, ref_m, timing_model=timing_model,
                                clamp=clamp, backend="numpy")
    port = P.batched_congruence(port_p, port_m, timing_model=timing_model,
                                clamp=clamp, device="cpu")
    assert port.backend == "torch"
    assert port.aggregate.dtype == np.float64
    assert_result_close(port, ref, F64_TOL)
    assert port.pareto_front() == ref.pareto_front()
    assert port.pareto_front_3d() == ref.pareto_front_3d()
    assert list(port.best_fit_indices()) == list(ref.best_fit_indices())


@pytest.mark.parametrize("timing_model", ["serial", "overlap"])
def test_plain_f64_step_time_and_beta_match_numpy(timing_model):
    ref_p, port_p = both_profiles(profile_dicts(5, seed=7))
    ref_m, port_m = both_machines(16, seed=2)
    np.testing.assert_allclose(
        P.batched_step_time(port_p, port_m, timing_model, device="cpu"),
        RS.batched_step_time(ref_p, ref_m, timing_model, backend="numpy"),
        rtol=F64_TOL, atol=0)
    for ref_col in (0, 5):
        np.testing.assert_allclose(
            P.default_beta_batched(port_p, port_m, beta_ref=ref_col,
                                   device="cpu"),
            RS.default_beta_batched(ref_p, ref_m, beta_ref=ref_col,
                                    backend="numpy"),
            rtol=F64_TOL, atol=0)


def _degenerate_dicts():
    def prof(name, flops, hbm, coll, nd=8, model_flops=None):
        return dict(name=name, flops=flops, hbm_bytes=hbm, bytes_accessed=hbm,
                    collective_bytes={"all-reduce": coll}, num_devices=nd,
                    model_flops=0.5 * flops * nd if model_flops is None
                    else model_flops)
    return [prof("zero-flop", 0.0, 1e9, 1e8, model_flops=0.0),
            prof("zero-coll", 1e12, 1e9, 0.0),
            prof("tiny", 1.0, 1.0, 0.0, model_flops=0.5),
            prof("hbm-bound", 1e9, 1e12, 1e10),
            prof("idle", 0.0, 0.0, 0.0)]


def _degenerate_machines(pkg):
    base = pkg.TPU_V5E
    return pkg.MachineBatch.from_models([
        base,
        dataclasses.replace(base, peak_flops=base.peak_flops * 1e-6),
        dataclasses.replace(base, hbm_bw=base.hbm_bw * 1e6),
        dataclasses.replace(base, ici_bw=base.ici_bw * 1e-6,
                            inter_pod_bw=base.inter_pod_bw * 1e-6),
    ])


@pytest.mark.parametrize("beta", [None, 1e-6, 1e3, 0.0])
def test_plain_f64_degenerate_cells_match_numpy(beta):
    """Zero-FLOP, zero-collective, idle (gamma == beta == 0) apps, rates
    scaled 1e-6..1e6 and extreme betas: finite, equal to NumPy."""
    ref_p, port_p = both_profiles(_degenerate_dicts())
    for clamp in (False, True):
        ref = RS.batched_congruence(ref_p, _degenerate_machines(R), beta=beta,
                                    clamp=clamp, backend="numpy")
        port = P.batched_congruence(port_p, _degenerate_machines(P), beta=beta,
                                    clamp=clamp, device="cpu")
        assert_result_close(port, ref, F64_TOL)
        if clamp:
            assert np.isfinite(port.aggregate).all()


def test_scalar_path_matches_reference():
    """The host-side scalar adapters are the same math, bit for bit."""
    for d in profile_dicts(4, seed=11) + _degenerate_dicts():
        (rp,), (pp,) = both_profiles([d])
        for rm, pm in zip(R.VARIANTS, P.VARIANTS):
            for tm in ("serial", "overlap"):
                r = R.profile_congruence(rp, rm, timing_model=tm, clamp=True)
                p = P.profile_congruence(pp, pm, timing_model=tm, clamp=True)
                assert p.as_dict() == r.as_dict()
            assert P.default_beta(pp, pm) == R.default_beta(rp, rm)
            assert (P.subsystem_times(pp, pm).as_dict()
                    == R.subsystem_times(rp, rm).as_dict())


# --------------------------------------------------------------------------- #
# Plain float32 and the cuda backend's stacking == the Pallas kernels (5e-4)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("make", [torch32, cuda_on_cpu],
                         ids=["torch-f32", "cuda-backend-on-cpu"])
@pytest.mark.parametrize("timing_model", ["serial", "overlap"])
@pytest.mark.parametrize("clamp", [False, True])
def test_f32_congruence_matches_pallas(make, timing_model, clamp):
    ref_p, port_p = both_profiles(profile_dicts(6, seed=3))
    ref_m, port_m = both_machines(24, seed=1)
    ref = RS.batched_congruence(ref_p, ref_m, timing_model=timing_model,
                                clamp=clamp, backend="pallas")
    port = P.batched_congruence(port_p, port_m, timing_model=timing_model,
                                clamp=clamp, backend=make())
    assert port.aggregate.dtype == np.float32
    assert port.aggregate.shape == ref.aggregate.shape
    assert_result_close(port, ref, F32_TOL)


@pytest.mark.parametrize("v", [1, 5, 127, 128, 129, 513])
def test_f32_variant_edges_match_pallas(v):
    """The Pallas backend pads the variant axis to a tile multiple; the
    port masks the ragged edge instead.  Both return exactly (A, V)."""
    ref_p, port_p = both_profiles(profile_dicts(2, seed=13))
    ref_m = RS.ParamSpace.default().sample(v, seed=2)
    port_m = P.ParamSpace.default().sample(v, seed=2)
    ref = RS.batched_congruence(ref_p, ref_m, backend="pallas")
    for be in (torch32(), cuda_on_cpu()):
        port = P.batched_congruence(port_p, port_m, backend=be)
        assert port.aggregate.shape == ref.aggregate.shape == (2, v)
        assert_result_close(port, ref, F32_TOL)
        assert np.isfinite(port.aggregate).all()


@pytest.mark.parametrize("timing_model", ["serial", "overlap"])
def test_f32_step_time_and_beta_match_pallas(timing_model):
    ref_p, port_p = both_profiles(profile_dicts(5, seed=7))
    ref_m, port_m = both_machines(126, seed=2)
    ref_t = RS.batched_step_time(ref_p, ref_m, timing_model, backend="pallas")
    ref_b = RS.default_beta_batched(ref_p, ref_m, backend="pallas")
    for be in (torch32(), cuda_on_cpu()):
        np.testing.assert_allclose(
            P.batched_step_time(port_p, port_m, timing_model, backend=be),
            ref_t, rtol=F32_TOL)
        np.testing.assert_allclose(
            P.default_beta_batched(port_p, port_m, backend=be), ref_b,
            rtol=F32_TOL)


def test_f32_degenerate_cells_match_pallas():
    ref_p, port_p = both_profiles(_degenerate_dicts())
    for beta in (None, 1e-6, 1e3):
        ref = RS.batched_congruence(ref_p, _degenerate_machines(R), beta=beta,
                                    clamp=True, backend="pallas")
        port = P.batched_congruence(port_p, _degenerate_machines(P),
                                    beta=beta, clamp=True,
                                    backend=cuda_on_cpu())
        np.testing.assert_allclose(port.aggregate, ref.aggregate,
                                   rtol=F32_TOL, atol=F32_TOL)


# --------------------------------------------------------------------------- #
# Sweep statistics (K4's plain version) == NumPy mean/min/argmin
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("clamp", [False, True])
def test_plain_sweep_stats_match_numpy_reduction(clamp):
    """The reference's K4 cannot run on the installed jax (its shard_map
    call passes a keyword jax no longer takes), so its oracle is what it
    computes: NumPy mean/min/argmin of the NumPy backend's aggregate.
    Clamped scores make exact ties common; argmin must pick the first."""
    ref_p, port_p = both_profiles(profile_dicts(6, seed=17)
                                  + _degenerate_dicts())
    ref_m, port_m = both_machines(200, seed=4)
    ref_pb = RS.ProfileBatch.from_profiles(ref_p)
    beta = RS.default_beta_batched(ref_pb, ref_m, backend="numpy")
    agg = RK.get_backend("numpy").congruence(
        ref_pb.arrays(), ref_m.arrays(), beta, clamp=clamp).aggregate
    port_pb = P.ProfileBatch.from_profiles(port_p)
    mean, mins, idx = P.get_backend(device="cpu").sharded_stats(
        port_pb.arrays(), port_m.arrays(), beta, clamp=clamp)
    np.testing.assert_allclose(mean, agg.mean(axis=0), rtol=F64_TOL, atol=0)
    np.testing.assert_allclose(mins, agg.min(axis=1), rtol=F64_TOL, atol=0)
    np.testing.assert_array_equal(idx, np.argmin(agg, axis=1))
    if clamp:  # the idle app scores 0 everywhere: a full row of ties
        assert (agg[-1] == agg[-1][0]).all() and idx[-1] == 0
    assert mean.dtype == mins.dtype == np.float64 and idx.dtype == np.int64


def test_cuda_backend_stats_on_cpu_match_its_own_aggregate():
    """The cuda backend's K4 path on CPU tensors reduces exactly the
    float32 aggregate its K1 path returns."""
    _, port_p = both_profiles(profile_dicts(5, seed=23))
    _, port_m = both_machines(300, seed=5)
    pb = P.ProfileBatch.from_profiles(port_p)
    be = cuda_on_cpu()
    beta = be.default_beta(pb.arrays(), port_m.select(0).arrays())
    for tm in ("serial", "overlap"):
        agg = be.congruence(pb.arrays(), port_m.arrays(), beta,
                            timing_model=tm, clamp=True).aggregate
        mean, mins, idx = be.sharded_stats(pb.arrays(), port_m.arrays(), beta,
                                           timing_model=tm, clamp=True)
        np.testing.assert_allclose(mean, agg.mean(axis=0), rtol=1e-6)
        np.testing.assert_array_equal(mins, agg.min(axis=1))
        np.testing.assert_array_equal(idx, np.argmin(agg, axis=1))


def test_sweep_stats_plain_follows_numpy_nan_and_tie_rules():
    rows = np.array([[3.0, 1.0, 1.0, 2.0],
                     [2.0, np.nan, 0.5, np.nan],
                     [np.inf, np.inf, np.inf, np.inf],
                     [-1.0, -np.inf, np.nan, -np.inf],
                     [0.0, 0.0, 0.0, 0.0]])
    mean, mins, idx = PK.sweep_stats_plain(torch.as_tensor(rows))
    np.testing.assert_array_equal(idx.numpy(), np.argmin(rows, axis=1))
    np.testing.assert_array_equal(mins.numpy(), np.min(rows, axis=1))
    np.testing.assert_array_equal(mean.numpy(), rows.mean(axis=0))


# --------------------------------------------------------------------------- #
# K4's reduction order on the card, emulated in float32
# --------------------------------------------------------------------------- #

# congruence.cu's K4 shape: variants a block, app groups, threads an app
# in a block's reduction, threads of the merge's block
STAT_VARIANTS, STAT_GROUPS, STAT_SPLIT, STAT_THREADS = 64, 4, 4, 256


def better(v, i, bv, bi):
    """congruence.cu's ``better()``: np.argmin's order on (value, index)
    pairs -- a NaN first, then the lower value, the lower index on ties."""
    vn, bn = v != v, bv != bv
    if vn or bn:
        return vn and (not bn or i < bi)
    return v < bv or (v == bv and i < bi)


def _tree(pairs, offsets):
    """Lane i takes pair i; at each offset every lane joins its xor partner
    by ``better`` (the kernels' ``__shfl_xor_sync`` trees)."""
    for off in offsets:
        pairs = [p if not better(*pairs[i ^ off], *p) else pairs[i ^ off]
                 for i, p in enumerate(pairs)]
    return pairs[0]


def k4_emulated(agg):
    """K4's statistics of a float32 ``(A, V)`` aggregate in the kernels'
    order: each app group's apps (a == g mod 4) summed in increasing order,
    the four group sums in group order, divided by A; per block of 64
    variants, four threads an app scan variants q, q + 4, ... in order and
    a 2-step tree joins them; then one block of 256 threads an app walks
    the blocks, thread i blocks i, i + 256, ..., a 5-step tree joins each
    warp's lanes and a 3-step tree the 8 warps."""
    agg = np.asarray(agg, dtype=np.float32)
    A, V = agg.shape
    groups = [np.zeros(V, np.float32) for _ in range(STAT_GROUPS)]
    for a in range(A):
        groups[a % STAT_GROUPS] = groups[a % STAT_GROUPS] + agg[a]
    total = groups[0]
    for g in groups[1:]:
        total = total + g
    mean = total / np.float32(A)
    nblocks = -(-V // STAT_VARIANTS)
    mins, idx = np.empty(A, np.float32), np.empty(A, np.int64)
    for a in range(A):
        parts = []
        for b in range(nblocks):
            v0 = b * STAT_VARIANTS
            row = [float(agg[a, v0 + k]) if v0 + k < V else np.inf
                   for k in range(STAT_VARIANTS)]
            scans = []
            for q in range(STAT_SPLIT):
                # the kernel's in-order scan: indices rise, so a NaN beats a
                # number, a lower value wins and a tie keeps the earlier one
                bv, bi = row[q], q
                for k in range(q + STAT_SPLIT, STAT_VARIANTS, STAT_SPLIT):
                    if not row[k] >= bv and bv == bv:
                        bv, bi = row[k], k
                scans.append((bv, bi))
            bv, bi = _tree(scans, (1, 2))
            parts.append((bv, v0 + bi))
        threads = []
        for i in range(STAT_THREADS):
            bv, bi = np.inf, 2 ** 31 - 1
            for b in range(i, nblocks, STAT_THREADS):
                if better(*parts[b], bv, bi):
                    bv, bi = parts[b]
            threads.append((bv, bi))
        warps = [_tree(threads[w:w + 32], (1, 2, 4, 8, 16))
                 for w in range(0, STAT_THREADS, 32)]
        mins[a], idx[a] = _tree(warps, (1, 2, 4))
    return mean, mins, idx


def _stat_rows(seed, A=9, V=2113):
    """A float32 aggregate over 34 blocks of 64 variants with exact ties,
    NaN cells, an all-NaN row, an all-tie row and a row of +inf."""
    rng = np.random.default_rng(seed)
    agg = rng.integers(0, 6, (A, V)).astype(np.float32) * np.float32(0.25)
    agg[1, rng.choice(V, 3, replace=False)] = np.nan
    agg[2] = np.nan
    agg[3] = np.float32(0.5)
    agg[4] = np.inf
    agg[5, -1] = -1.0                   # the minimum in the ragged block
    agg[6, 70] = agg[6, 2000] = -2.0    # a tie across blocks
    return agg


@pytest.mark.parametrize("seed,A,V", [(0, 9, 2113), (1, 9, 2113), (2, 7, 16_450)])
def test_k4_emulated_order_matches_numpy_on_nan_and_tie_rows(seed, A, V):
    """Over 34 blocks, and over 258, where the merge's threads walk two."""
    agg = _stat_rows(seed, A, V)
    mean, mins, idx = k4_emulated(agg)
    np.testing.assert_array_equal(idx, np.argmin(agg, axis=1))
    np.testing.assert_array_equal(mins, np.min(agg, axis=1))
    np.testing.assert_allclose(mean, agg.astype(np.float64).mean(axis=0),
                               rtol=1e-5, atol=0)
    assert idx[2] == 0 and idx[3] == 0 and idx[4] == 0
    assert idx[5] == agg.shape[1] - 1 and idx[6] == 70
    pmean, pmins, pidx = PK.sweep_stats_plain(torch.as_tensor(agg))
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(mins, pmins.numpy())
    np.testing.assert_allclose(mean, pmean.numpy(), rtol=1e-5, atol=0)


@pytest.mark.parametrize("clamp", [False, True])
def test_k4_emulated_order_matches_plain_and_numpy_aggregate(clamp):
    """The kernels' reduction order on the NumPy backend's aggregate of real
    profiles (rounded to float32, as the kernels compute it): argmins exact
    against the plain version and NumPy, means within 1e-5 of the float64
    NumPy mean."""
    ref_p, port_p = both_profiles(profile_dicts(6, seed=29)
                                  + _degenerate_dicts())
    ref_m, port_m = both_machines(2100, seed=6)
    ref_pb = RS.ProfileBatch.from_profiles(ref_p)
    beta = RS.default_beta_batched(ref_pb, ref_m, backend="numpy")
    agg64 = RK.get_backend("numpy").congruence(
        ref_pb.arrays(), ref_m.arrays(), beta, clamp=clamp).aggregate
    agg = agg64.astype(np.float32)
    mean, mins, idx = k4_emulated(agg)
    pmean, pmins, pidx = PK.sweep_stats_plain(torch.as_tensor(agg))
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(idx, np.argmin(agg, axis=1))
    np.testing.assert_array_equal(mins, pmins.numpy())
    np.testing.assert_allclose(mean, pmean.numpy(), rtol=1e-5, atol=0)
    np.testing.assert_allclose(mean, agg64.mean(axis=0), rtol=1e-5, atol=0)
    if clamp:   # the idle app scores 0 everywhere: a full row of ties
        assert idx[-1] == 0


@pytest.mark.parametrize("seed", range(4))
def test_any_merge_tree_of_better_gives_numpy_argmin(seed):
    """better() is a strict total order on (value, index), so merging the
    pairs in any order and any tree shape returns np.argmin's index (a NaN
    first, the first occurrence on ties) and its value."""
    rng = np.random.default_rng(seed)
    for _ in range(150):
        n = int(rng.integers(1, 40))
        x = rng.integers(-2, 3, n).astype(np.float64)
        x[rng.random(n) < 0.1] = np.nan
        x[rng.random(n) < 0.1] = rng.choice([np.inf, -np.inf])
        pairs = [(float(v), i) for i, v in enumerate(x)]
        rng.shuffle(pairs)
        while len(pairs) > 1:
            i, j = sorted(rng.choice(len(pairs), 2, replace=False))
            b = pairs.pop(j)
            a = pairs[i]
            pairs[i] = b if better(*b, *a) else a
        (v, i), = pairs
        assert i == int(np.argmin(x))
        assert (v != v and np.isnan(np.min(x))) or v == np.min(x)


# --------------------------------------------------------------------------- #
# Wrapper contract on the CPU
# --------------------------------------------------------------------------- #


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    _, port_p = both_profiles(profile_dicts(3, seed=2))
    _, port_m = both_machines(10, seed=3)
    pb = P.ProfileBatch.from_profiles(port_p)
    p = torch.as_tensor(np.stack(list(pb.arrays()) + [np.full(3, 1e-3)]))
    m = torch.as_tensor(np.stack(list(port_m.arrays())))
    KC.reset_launch_counts()
    out = KC.congruence(p, m, clamp=True)
    assert out.shape == (8, 3, 13) and out.dtype == torch.float64
    assert KC.step_time(p[:6], m).shape == (3, 13)
    assert KC.default_beta(p[:6], m).shape == (3,)
    mean, mins, idx = KC.sweep_stats(p, m, clamp=True)
    assert mean.shape == (13,) and mins.shape == idx.shape == (3,)
    torch.testing.assert_close(mins, out[7].min(dim=1).values)
    assert KC.launch_counts() == {"congruence": 0, "step_time": 0,
                                  "default_beta": 0, "sweep_stats": 0}


def test_wrappers_reject_bad_stacks():
    p = torch.ones(7, 3)
    m = torch.ones(8, 5)
    with pytest.raises(ValueError, match="machine stack"):
        KC.congruence(p, torch.ones(7, 5))
    with pytest.raises(ValueError, match="profile stack"):
        KC.congruence(torch.ones(6, 3), m)
    with pytest.raises(ValueError, match="timing model"):
        KC.step_time(p, m, "bogus")
    with pytest.raises(ValueError, match="no kernel for device"):
        KC.congruence(p.to("meta"), m.to("meta"))


def _wrapper_calls():
    """Each wrapper as a call on (profile stack, machine stack, timing
    model), with the profile rows it takes."""
    return {
        "congruence": (lambda p, m, tm: KC.congruence(p, m, tm), KC.P_ROWS),
        "step_time": (lambda p, m, tm: KC.step_time(p, m, tm), 6),
        "default_beta": (lambda p, m, tm: KC.default_beta(p, m), 6),
        "sweep_stats": (lambda p, m, tm: KC.sweep_stats(p, m, tm), KC.P_ROWS),
        "launch_floor": (lambda p, m, tm: KC.launch_floor(p, m), 6),
    }


#: (what is wrong, the error's words): each bad input every wrapper rejects
BAD_INPUTS = {
    "machine rows": "machine stack",
    "machine 3-d": "machine stack",
    "profile rows": "profile stack",
    "profile 1-d": "profile stack",
    "mixed devices": "different devices",
    "meta device": "no kernel for device",
}


def _bad(case, p_rows):
    p, m = torch.ones(p_rows, 3), torch.ones(8, 5)
    return {"machine rows": lambda: (p, torch.ones(7, 5)),
            "machine 3-d": lambda: (p, torch.ones(8, 5, 1)),
            "profile rows": lambda: (torch.ones(p_rows - 1, 3), m),
            "profile 1-d": lambda: (torch.ones(3), m),
            "mixed devices": lambda: (p, m.to("meta")),
            "meta device": lambda: (p.to("meta"), m.to("meta"))}[case]()


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
@pytest.mark.parametrize("wrapper", sorted(_wrapper_calls()))
def test_each_wrapper_rejects_each_bad_input(wrapper, case):
    call, p_rows = _wrapper_calls()[wrapper]
    p, m = _bad(case, p_rows)
    with pytest.raises(ValueError, match=BAD_INPUTS[case]):
        call(p, m, "serial")


@pytest.mark.parametrize("wrapper", ["congruence", "step_time", "sweep_stats"])
def test_wrappers_reject_an_unknown_timing_model(wrapper):
    call, p_rows = _wrapper_calls()[wrapper]
    with pytest.raises(ValueError, match="timing model"):
        call(torch.ones(p_rows, 3), torch.ones(8, 5), "bogus")


def test_default_beta_rejects_a_missing_reference_column():
    with pytest.raises(ValueError, match="reference machine column"):
        KC.default_beta(torch.ones(6, 3), torch.ones(8, 0))
    _, port_p = both_profiles(profile_dicts(3, seed=1))
    empty = PK.MachineArrays(*(np.zeros(0) for _ in range(8)))
    with pytest.raises(ValueError, match="reference machine column"):
        KC.pack_beta(P.ProfileBatch.from_profiles(port_p).arrays(), empty)


def test_library_is_returned_without_the_lock_once_loaded(monkeypatch):
    class Refuse:
        def __enter__(self):
            raise AssertionError("the lock was taken")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setattr(_build, "_lib", lib)
    monkeypatch.setattr(_build, "_lock", Refuse())
    assert _build.lib() is lib


def test_entry_points_are_looked_up_once(monkeypatch):
    loads = []

    class Lib:
        repro_step_time = object()

    def fake_lib():
        loads.append(1)
        return Lib

    monkeypatch.setattr(_build, "lib", fake_lib)
    monkeypatch.setattr(KC, "_entry_points", {})
    assert KC._fn("repro_step_time") is Lib.repro_step_time
    assert KC._fn("repro_step_time") is Lib.repro_step_time
    assert loads == [1]


# --------------------------------------------------------------------------- #
# K3 through the backend: one packed host buffer, one H2D copy
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("which", ["random", "degenerate"])
@pytest.mark.parametrize("ref_col", [0, 1, 2])
def test_packed_beta_equals_plain_f32_and_numpy(which, ref_col):
    """``CudaBackend.default_beta`` packs the six profile rows and the
    reference column into one buffer; on the CPU its views go to the plain
    version, which must give exactly the plain float32 beta of the same
    rows, and the NumPy reference's beta to float32 tolerance, degenerate
    apps (no model FLOPs, no pod traffic, all zeros) included."""
    dicts = (profile_dicts(9, seed=ref_col) if which == "random"
             else _degenerate_dicts())
    ref_p, port_p = both_profiles(dicts)
    ref_m, port_m = both_machines(20, seed=ref_col)
    pb = P.ProfileBatch.from_profiles(port_p)
    ref_col_arrays = port_m.select(ref_col).arrays()
    host = KC.pack_beta(pb.arrays(), ref_col_arrays)
    a = len(dicts)
    assert host.dtype == np.float32 and host.shape == (6 * a + 8,)
    p_view, m_view = KC.beta_views(torch.from_numpy(host))
    assert p_view.shape == (6, a) and m_view.shape == (8, 1)
    assert p_view.is_contiguous() and m_view.is_contiguous()

    got = cuda_on_cpu().default_beta(pb.arrays(), ref_col_arrays)
    p32 = torch.as_tensor(np.stack([np.asarray(r, np.float32) for r in pb.arrays()]))
    m32 = torch.as_tensor(np.stack([np.asarray(r, np.float32)
                                    for r in port_m.arrays()]))[:, ref_col:ref_col + 1]
    want = KC.plain_default_beta(p32, m32).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    numpy_ref = RS.default_beta_batched(ref_p, ref_m, beta_ref=ref_col,
                                        backend="numpy")
    np.testing.assert_allclose(got, numpy_ref, rtol=F32_TOL, atol=0)
    np.testing.assert_array_equal(
        P.default_beta_batched(port_p, port_m, beta_ref=ref_col,
                               backend=cuda_on_cpu()), got)
    if which == "degenerate":
        assert got[-1] == 0.0   # "idle": no work, no bytes, beta 0


# --------------------------------------------------------------------------- #
# The row partitions of K1 (whole lines) and K2 (NumPy models of the
# kernels' index arithmetic, with the constants read from the CUDA source)
# --------------------------------------------------------------------------- #


def _cu_constant(name):
    src = (_build.CSRC / "congruence.cu").read_text()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    assert m, name
    expr = m.group(1)
    for other in re.findall(r"\bk[A-Z]\w*", expr):
        expr = expr.replace(other, str(_cu_constant(other)))
    return int(eval(expr, {}))


def _tile_ranges(row_base, V):
    """Rows starting at float offsets ``row_base`` (shape (R,)) under K1's
    staged-tile partition: for each row and
    block, the variant range [lo, hi) it writes, the first and last tile
    slot it reads, and whether its 16-byte stores land on 16-byte offsets;
    the range starts on a line boundary of the row."""
    tile, threads, trow = (_cu_constant("kTile"), _cu_constant("kThreads"),
                           _cu_constant("kTileRow"))
    nblocks = -(-V // tile)
    shift = (row_base % 32)[:, None]
    first = (np.arange(nblocks) * tile)[None, :]
    last = (np.arange(nblocks) == nblocks - 1)[None, :]
    start = first - shift
    k0 = np.maximum(0, -start)
    k1 = np.where(last, V, np.minimum(V, start + tile)) - start
    lo, hi = start + k0, start + np.maximum(k1, k0)
    # slot of variant x: (shift & 3) + x - first + 32, which the block's
    # thread x - first + 32 in [0, threads) computed
    j_lo, j_hi = lo - first + 32, hi - 1 - first + 32
    live = hi > lo
    assert (j_lo[live] >= 0).all() and (j_hi[live] < threads).all()
    assert ((shift & 3) + j_hi)[live].max(initial=0) < trow
    # the range's element 0 (variant start) sits on a line boundary of the
    # output, so every 16-byte store (k a multiple of 4) is 16-byte aligned
    # and a warp's 128 consecutive floats fill whole lines
    assert ((row_base[:, None] + start) % 32 == 0).all()
    # the tile side of a 16-byte load: slot 32 - (shift & ~3) + k
    assert ((32 - (shift & ~3)) % 4 == 0).all()
    return lo, hi


def _thread_ranges(row_base, V):
    """K2's thread-per-variant kernel: block t's thread j writes variant
    256 t + j of every row of its app group, if below V."""
    threads = _cu_constant("kThreads")
    first = np.arange(-(-V // threads)) * threads
    lo = np.broadcast_to(first[None, :], (len(row_base), len(first)))
    return lo, np.minimum(lo + threads, V)


def _assert_partition(lo, hi, V):
    """Each row's ranges, in order, cover [0, V) once: every element of
    every row is written exactly once."""
    length = np.maximum(hi - lo, 0)
    assert (length.sum(axis=1) == V).all()
    for r in range(lo.shape[0]):
        live = length[r] > 0
        l, h = lo[r][live], hi[r][live]
        assert l[0] == 0 and h[-1] == V and (l[1:] == h[:-1]).all()


GEOMETRIES = {
    # (output rows per app, partition, the constant of its app group): K1
    # writes 8 rows per app
    "k1_tile": (8, _tile_ranges, "kAppGroup"),
    "k2_thread": (1, _thread_ranges, "kStepApps"),
}


@pytest.mark.parametrize("V", [1, 31, 33, 223, 224, 225, 100_003])
@pytest.mark.parametrize("A", [1, 7, 8, 9, 64, 65])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_row_partition_writes_each_element_once(geometry, A, V):
    rows_per_app, ranges, group_name = GEOMETRIES[geometry]
    # the kernel's own rows, then a row at every residue mod 32
    for base in (np.arange(rows_per_app * A, dtype=np.int64) * V,
                 np.arange(32, dtype=np.int64) + 32 * V):
        lo, hi = ranges(base, V)
        _assert_partition(lo, hi, V)
    # the 1-D grid's app groups (fastest) cover every app once
    group = _cu_constant(group_name)
    apps = np.arange(-(-A // group))[:, None] * group + np.arange(group)
    assert sorted(apps[apps < A].tolist()) == list(range(A))


# --------------------------------------------------------------------------- #
# Kernel launches (need the card)
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled with nvcc "
                    "for sm_90a and have no CPU mode")
    return torch.device("cuda")


def _kernel_inputs(a, v, seed, dev):
    _, port_p = both_profiles(profile_dicts(a, seed=seed))
    mb = P.ParamSpace.scale_space().sample(v, seed=seed)
    pb = P.ProfileBatch.from_profiles(port_p)
    beta = np.full(a, 1e-4)
    p = torch.as_tensor(np.stack(list(pb.arrays()) + [beta]),
                        dtype=torch.float32, device=dev)
    m = torch.as_tensor(np.stack(list(mb.arrays())), dtype=torch.float32,
                        device=dev)
    return p, m


def _conditioned(want, beta, limit=1e3):
    """Cells where Eq. 1 is well conditioned: (|gamma| + |beta| +
    max |alpha|) / |gamma - beta| at most ``limit``.  Beyond it float32
    rounding of the inputs alone (~1e-7 relative) moves a score by more
    than 5e-4 from float64, in the plain float32 version as in the kernel
    (ROADMAP.md, Queue 3, "Finding"; chip_smoke.py's COND_LIMIT)."""
    gamma, alphas = want[0], want[1:4]
    scale = gamma.abs() + beta.abs()[:, None] + alphas.abs().amax(dim=0)
    return ~(scale > limit * (gamma - beta[:, None]).abs())


#: (A, V) around the sweep kernels' tiles: K1 writes 4 apps x 224 variants
#: a block (256 computed), K4 takes 64 variants x 4 app groups, its apps
#: staged 64 at a time; K2 takes 16 apps x 256 variants a block
CARD_SHAPES = [(5, 1), (5, 127), (5, 129), (5, 4099), (3, 223), (4, 224),
               (5, 225), (9, 449), (3, 63), (4, 64), (7, 65), (8, 255),
               (63, 257), (65, 4099), (257, 2113), (15, 255), (16, 256),
               (17, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("a,v", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, a, v):
    p, m = _kernel_inputs(a, v, seed=v, dev=cuda_device)
    KC.reset_launch_counts()
    for tm in ("serial", "overlap"):
        for clamp in (False, True):
            out = KC.congruence(p, m, tm, clamp=clamp)
            # every cell equal to the plain float32 version (the kernel
            # rounds each operation as it does) ...
            torch.testing.assert_close(
                out, KC.plain_congruence(p, m, tm, clamp=clamp),
                rtol=0, atol=0, equal_nan=True)
            # ... and against float64 where float32 Eq. 1 is well conditioned
            want = KC.plain_congruence(p.double(), m.double(), tm, clamp=clamp)
            ok = _conditioned(want, p.double()[6])
            torch.testing.assert_close(out[:4], want[:4].float(),
                                       rtol=F32_TOL, atol=F32_TOL)
            torch.testing.assert_close(out[4:][:, ok], want[4:][:, ok].float(),
                                       rtol=F32_TOL, atol=F32_TOL)
            mean, mins, idx = KC.sweep_stats(p, m, tm, clamp)
            pmean, pmins, pidx = KC.plain_sweep_stats(p, m, tm, clamp)
            torch.testing.assert_close(mean, pmean, rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(mins, pmins, rtol=F32_TOL, atol=F32_TOL)
            # K4 reduces exactly the aggregate K1 computes on the same stacks
            kmean, kmins, kidx = PK.sweep_stats_plain(out[7])
            assert torch.equal(idx, kidx) and torch.equal(mins, kmins)
            torch.testing.assert_close(mean, kmean, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(
            KC.step_time(p[:6].contiguous(), m, tm),
            KC.plain_step_time(p, m, tm), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(KC.default_beta(p[:6].contiguous(), m),
                               KC.plain_default_beta(p, m),
                               rtol=0, atol=0, equal_nan=True)
    torch.cuda.synchronize()
    assert KC.launch_counts() == {"congruence": 4, "step_time": 2,
                                  "default_beta": 1, "sweep_stats": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["nan", "same"])
def test_sweep_stats_nan_and_tie_populations_on_card(cuda_device, fill):
    """NaN peak rates in two variant columns past the first block and NaN
    beta in one app; or every variant alike: the argmin is the first NaN,
    or index 0, across all 66 blocks."""
    p, m = _kernel_inputs(6, 4199, seed=3, dev=cuda_device)
    if fill == "nan":
        m[0, [3001, 4198]] = float("nan")
        p[6, 2] = float("nan")
        want = torch.tensor([3001, 3001, 0, 3001, 3001, 3001], device=cuda_device)
    else:
        m = m[:, :1].expand(-1, m.shape[1]).contiguous()
        want = torch.zeros(6, dtype=torch.int64, device=cuda_device)
    for tm in ("serial", "overlap"):
        for clamp in (False, True):
            mean, mins, idx = KC.sweep_stats(p, m, tm, clamp)
            assert torch.equal(idx, want)
            kmean, kmins, kidx = PK.sweep_stats_plain(
                KC.congruence(p, m, tm, clamp=clamp)[7])
            assert torch.equal(idx, kidx)
            assert torch.equal(torch.isnan(mins), torch.isnan(kmins))


@pytest.mark.cuda
def test_kernels_reject_float64_on_card(cuda_device):
    p, m = _kernel_inputs(2, 8, seed=1, dev=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        KC.congruence(p.double(), m.double())

#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's sweep path on one card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):

  1. print the card (``nvidia-smi``), build the kernels from
     ``src/repro_torch/csrc`` with nvcc for sm_90a;
  2. hold each kernel (K1 congruence, K2 step time, K3 default beta, K4 sweep
     statistics) against its plain PyTorch version on the card, at
     A in {1, 3, 64} x V in {1, 127, 128, 129, 513, 100003}, both timing
     models, clamp on and off, with degenerate cells;
  3. main path, ``run_sweep``: gen:64 x (100000 + 3 named) variants on the
     card (plus ``batched_step_time`` and ``evaluate`` on the same suite),
     checked against the plain float32 and float64 versions;
  4. main path, streamed ``shard_sweep``: gen:64 x 1000003 variants in 16
     shards through K4, checked against the plain float32 version, and a
     checkpoint kill/resume round trip;
  5. timings by CUDA events at the phase-3/4 shapes, beside each kernel's
     bound, and the end-to-end split;
  6. the result line.

It needs one CUDA card, the CUDA toolkit's nvcc and the repository's
``src/`` tree; without them it exits with an error and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
#: float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TOL = 5e-4           # kernels vs plain versions (the JAX package's f32 pin)
MEAN_RTOL = 1e-5     # K4 per-variant means
#: Eq. 1 cells whose condition number (|gamma| + |beta| + max|alpha|) /
#: |gamma - beta| exceeds this are left out of the float64 comparisons:
#: float32 rounding of the inputs alone (~1e-7 relative) moves such a score
#: by more than TOL.  The float32 comparisons keep every cell.
COND_LIMIT = 1e3
SHAPES_A = (1, 3, 64)
SHAPES_V = (1, 127, 128, 129, 513, 100_003)
SOURCE = "src/repro_torch/csrc/congruence.cu"
REPLACES = {
    "congruence": "src/repro/core/kernels_pallas.py:90",
    "step_time": "src/repro/core/kernels_pallas.py:104",
    "default_beta": "src/repro/core/kernels_pallas.py:109",
    "sweep_stats": "src/repro/core/kernels_pallas.py:332",
}


class Failure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# Operation and byte counts for the bounds (per the card's published peaks)
# --------------------------------------------------------------------------- #

# float32 operations per (app, variant) cell, counting each add, multiply,
# division, square root, comparison and max as one (a division or square
# root costs the card several instructions, so the operation bound is a
# floor): raw terms 7, scaling 3, gamma 2, three alphas 9, three Eq. 1
# scores 15, clamp 6, aggregate 6.
def _cell_ops(clamp: bool) -> int:
    return 42 + (6 if clamp else 0)


def bound(kind: str, a: int, v: int, clamp: bool = True):
    """(bound_ms, bound_by) for one call at (A, V)."""
    f32 = 4
    if kind == "congruence":
        nbytes = (7 * a + 8 * v + 8 * a * v) * f32
        ops = _cell_ops(clamp) * a * v
    elif kind == "step_time":
        nbytes = (6 * a + 8 * v + a * v) * f32
        ops = 12 * a * v
    elif kind == "default_beta":
        nbytes = (6 * a + 8 + a) * f32
        ops = 18 * a
    else:  # sweep_stats: + the running sum and the min comparison per cell
        nbytes = (7 * a + 8 * v + v + a) * f32 + 8 * a
        ops = (_cell_ops(clamp) + 2) * a * v
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------- #
# Inputs
# --------------------------------------------------------------------------- #


def stacks(torch, core, a: int, v: int, seed: int, dtype, dev):
    """(7, A) profile+beta and (8, V) machine stacks from the port's own
    generators, with degenerate cells: app 0 moves no bytes and does no
    work (gamma == beta == 0), app 1 has no pod traffic, app 2 has no
    model FLOPs (the invalid-beta branch)."""
    import numpy as np
    from repro_torch.core import kernels_xp as K

    pb = core.AppSpace.default().sample(a, seed=seed)
    if a >= 3:
        pb.flops[0] = pb.mem_bytes[0] = 0.0
        pb.collective_bytes[0] = pb.pod_collective_bytes[0] = 0.0
        pb.pod_collective_bytes[1] = 0.0
        pb.model_flops[2] = 0.0
    mb = core.ParamSpace.scale_space().sample(v, seed=seed)
    beta = K.default_beta_kernel(
        np, pb.arrays(), core.MachineBatch.from_models([core.TPU_V5E]).arrays())
    p = np.stack(list(pb.arrays()) + [beta])
    m = np.stack(list(mb.arrays()))
    as_t = lambda x: torch.as_tensor(x.astype(np.float32)).to(dev, dtype)
    return as_t(p), as_t(m)


# --------------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version on the card
# --------------------------------------------------------------------------- #


def conditioned(xp, gamma, beta, alphas):
    """Cells where Eq. 1 is well conditioned (see ``COND_LIMIT``)."""
    scale = abs(gamma) + abs(beta[:, None]) + xp.maximum(
        xp.maximum(abs(alphas[0]), abs(alphas[1])), abs(alphas[2]))
    return ~(scale > COND_LIMIT * abs(gamma - beta[:, None]))


def _close(torch, got, want, what, mask=None):
    want = want.to(torch.float32)
    err = (got - want).abs()
    lim = TOL + TOL * want.abs()
    bad = ~((err <= lim) | (torch.isnan(got) & torch.isnan(want)))
    if mask is not None:
        bad &= mask
    if bool(bad.any()):
        raise Failure(f"{what}: {int(bad.sum())} cells off by more than "
                      f"{TOL} (max abs err {float(err[bad].max()):.3e})")
    finite = torch.isfinite(err)
    return float(err[finite].max()) if bool(finite.any()) else 0.0


def check_stats(torch, got, want, what):
    """K4 against the plain statistics of the same float32 aggregate."""
    (mean, mins, idx), (pmean, pmins, pidx), agg = got, want[:3], want[3]
    merr = (mean - pmean).abs()
    check(bool((merr <= MEAN_RTOL * pmean.abs() + 1e-7).all()),
          f"{what}: means off by {float(merr.max()):.3e}")
    err = _close(torch, mins, pmins, f"{what} minima")
    for a in range(agg.shape[0]):
        row = agg[a]
        if int(idx[a]) == int(pidx[a]):
            continue
        top2 = torch.topk(row, min(2, row.numel()), largest=False).values
        gap = float(top2[1] - top2[0]) if top2.numel() > 1 else float("inf")
        check(gap <= TOL, f"{what}: app {a} argmin {int(idx[a])} != "
                          f"{int(pidx[a])} with a clear minimum (gap {gap:.3e})")
        check(float(row[int(idx[a])]) <= float(top2[0]) + TOL,
              f"{what}: app {a} argmin column is not within {TOL} of the min")
    return max(err, float(merr.max()))


def phase_kernels(torch, core, KC, dev):
    errs = {k: 0.0 for k in REPLACES}
    n = masked = 0
    for a in SHAPES_A:
        for v in SHAPES_V:
            p32, m32 = stacks(torch, core, a, v, seed=a + v, dtype=torch.float32, dev=dev)
            p64, m64 = p32.double(), m32.double()
            for tm in ("serial", "overlap"):
                tag = f"A={a} V={v} {tm}"
                got = KC.step_time(p32[:6].contiguous(), m32, tm)
                errs["step_time"] = max(errs["step_time"], _close(
                    torch, got, KC.plain_step_time(p32, m32, tm), f"K2 {tag} f32"))
                _close(torch, got, KC.plain_step_time(p64, m64, tm), f"K2 {tag} f64")
                for clamp in (False, True):
                    tag2 = f"{tag} clamp={clamp}"
                    got = KC.congruence(p32, m32, tm, clamp=clamp)
                    plain = KC.plain_congruence(p32, m32, tm, clamp=clamp)
                    errs["congruence"] = max(errs["congruence"], _close(
                        torch, got, plain, f"K1 {tag2} f32"))
                    want = KC.plain_congruence(p64, m64, tm, clamp=clamp)
                    ok = conditioned(torch, want[0], p64[6], want[1:4])
                    masked += int((~ok).sum())
                    _close(torch, got, want, f"K1 {tag2} f64",
                           torch.cat([torch.ones_like(want[:4], dtype=torch.bool),
                                      ok.expand(4, *ok.shape)]))
                    plain_agg = plain[7]
                    errs["sweep_stats"] = max(errs["sweep_stats"], check_stats(
                        torch, KC.sweep_stats(p32, m32, tm, clamp),
                        (*KC.plain_sweep_stats(p32, m32, tm, clamp), plain_agg),
                        f"K4 {tag2}"))
                    n += 1
            got = KC.default_beta(p32[:6].contiguous(), m32)
            errs["default_beta"] = max(errs["default_beta"], _close(
                torch, got, KC.plain_default_beta(p32, m32), f"K3 A={a} V={v} f32"))
            _close(torch, got, KC.plain_default_beta(p64, m64), f"K3 A={a} V={v} f64")
    torch.cuda.synchronize()
    log(f"phase 2: K1-K4 match their plain versions (f32 and f64) on {n} "
        f"configurations (max abs err vs f32: {json.dumps(errs)}); "
        f"{masked} ill-conditioned Eq. 1 cells left out of the f64 check")
    return errs


# --------------------------------------------------------------------------- #
# Phases 3 and 4: the main path
# --------------------------------------------------------------------------- #


def fronts_agree(names_a, names_b, area, agg, tol=TOL):
    """Two 2-D fronts name the same variants, up to near-ties: a variant
    on one front only must be within ``tol`` (in ``agg``) of a point of the
    other front at no larger area."""
    if names_a == names_b:
        return True
    for mine, other in ((names_a, names_b), (names_b, names_a)):
        for name in set(mine) - set(other):
            if not any(area[o] <= area[name] and agg[o] <= agg[name] + tol
                       for o in other):
                return False
    return True


def best_fits_agree(kernel_res, plain_res, tol=TOL):
    """Per-app best fits equal, or within ``tol`` under the plain scores."""
    kb, pb = kernel_res.best_fit_indices(), plain_res.best_fit_indices()
    for a in range(len(kb)):
        if kb[a] != pb[a]:
            row = plain_res.aggregate[a]
            if row[kb[a]] > row[pb[a]] + tol:
                return False
    return True


def _front_maps(res):
    area = dict(zip(res.machines.names, res.area()))
    agg = dict(zip(res.machines.names, res.aggregate_mean()))
    return [res.machines.names[i] for i in res.pareto_front()], area, agg


def phase_run_sweep(torch, core, KC, dev):
    import numpy as np

    profiles = core.resolve_suite("gen:64")
    KC.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                         device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    front, front3 = res.pareto_front(), res.pareto_front_3d()
    best = res.best_fit_indices()
    pareto_ms = (time.perf_counter() - t0) * 1e3
    steps = core.batched_step_time(profiles, res.machines, device=dev)
    table = core.evaluate(profiles, variants=core.VARIANTS, device=dev)
    cell = table.cell(profiles[0].name, "baseline")
    counts = KC.launch_counts()
    log(f"phase 3: run_sweep gen:64 x {len(res.machines)} on {dev}: "
        f"{sweep_s:.3f} s, {64 * len(res.machines) / sweep_s:.4g} cells/s; "
        f"host Pareto + best fits {pareto_ms:.1f} ms; launches {counts}")
    check(counts["congruence"] > 0 and counts["default_beta"] > 0
          and counts["step_time"] > 0, f"main path missed a kernel: {counts}")
    check(res.backend == "cuda", f"run_sweep ran on {res.backend}")
    check(res.aggregate.shape == (64, 100_003), f"shape {res.aggregate.shape}")
    check(bool(np.isfinite(res.aggregate).all() and np.isfinite(steps).all()
               and steps.shape == res.aggregate.shape), "bad sweep outputs")
    check(len(front) > 0 and len(front3) > 0 and len(best) == 64,
          "empty Pareto front")
    check(math.isfinite(cell.aggregate) and len(table.variants) == 3,
          "bad evaluate table")

    plain32 = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                             backend=core.TorchBackend(dev, torch.float32))
    plain64 = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                             backend=core.TorchBackend(dev, torch.float64))
    ok = conditioned(np, plain64.gamma, plain64.beta,
                     list(plain64.alphas.values()))
    diff = abs(res.aggregate - plain64.aggregate)[ok]
    err = float(diff.max())
    check(bool((diff <= TOL + TOL * abs(plain64.aggregate[ok])).all()),
          f"run_sweep aggregate off the float64 plain sweep by {err:.3e}")
    check(best_fits_agree(res, plain32), "best fits differ from plain f32")
    names_k, area, agg = _front_maps(res)
    names_p, _, agg_p = _front_maps(plain32)
    check(fronts_agree(names_k, names_p, area, agg_p),
          f"2-D fronts differ: {names_k} vs {names_p}")
    log(f"phase 3: best fits and 2-D front ({len(names_k)} variants) match "
        f"the plain f32 sweep; aggregate within {err:.3e} of plain f64 "
        f"({int((~ok).sum())} ill-conditioned cells left out)")
    return dict(profiles=profiles, result=res, counts=counts,
                seconds=sweep_s, pareto_ms=pareto_ms)


def phase_shard_sweep(torch, core, KC, dev, profiles):
    KC.reset_launch_counts()
    t0 = time.perf_counter()
    sh = core.shard_sweep(profiles, n=1_000_000, include_named=core.VARIANTS,
                          stream=True, device=dev)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    counts = KC.launch_counts()
    cells = 64 * sh.num_variants
    log(f"phase 4: streamed shard_sweep gen:64 x {sh.num_variants} in "
        f"{sh.num_shards} shards on {sh.mesh_axis}: {shard_s:.3f} s, "
        f"{cells / shard_s:.4g} cells/s; {len(sh.result.machines)} "
        f"candidates; launches {counts}")
    check(sh.num_shards == 16, f"expected 16 shards, got {sh.num_shards}")
    check(counts["sweep_stats"] == sh.num_shards,
          f"K4 launches {counts['sweep_stats']} != shards {sh.num_shards}")
    check(counts["congruence"] > 0 and counts["default_beta"] > 0,
          f"shard_sweep missed a kernel: {counts}")
    plain = core.shard_sweep(profiles, n=1_000_000,
                             include_named=core.VARIANTS, stream=True,
                             backend=core.TorchBackend(dev, torch.float32))
    names_k, area, agg = _front_maps(sh.result)
    area_p, agg_p = _front_maps(plain.result)[1:]
    area.update(area_p)
    check(fronts_agree(sh.pareto_names(), plain.pareto_names(), area,
                       {**agg, **agg_p}),
          f"2-D fronts differ: {sh.pareto_names()} vs {plain.pareto_names()}")
    for app in sh.apps:
        k, p = sh.best_fit(app), plain.best_fit(app)
        if k != p:
            row = dict(zip(plain.result.machines.names,
                           plain.result.aggregate[plain.apps.index(app)]))
            check(k in row and row[k] <= row[p] + TOL,
                  f"best fit of {app}: {k} vs {p}")
    log(f"phase 4: best fits and 2-D front ({len(names_k)} variants) match "
        f"the plain f32 shard_sweep")

    # checkpoint kill/resume round trip at a small population
    ck = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(n=4096, include_named=core.VARIANTS, stream=True, num_shards=8,
              device=dev, checkpoint_dir=ck)

    class Kill(Exception):
        pass

    def die_after_2(s, *_):
        if s >= 2:
            raise Kill

    try:
        core.shard_sweep(profiles, progress=die_after_2, **kw)
        raise Failure("the kill hook did not fire")
    except Kill:
        pass
    resumed = core.shard_sweep(profiles, resume=True, **kw)
    straight = core.shard_sweep(profiles, n=4096, include_named=core.VARIANTS,
                                stream=True, num_shards=8, device=dev)
    shutil.rmtree(ck, ignore_errors=True)
    check(resumed.resumed_shards == 3, f"resumed {resumed.resumed_shards}")
    check((resumed.candidate_indices == straight.candidate_indices).all()
          and (resumed.result.aggregate == straight.result.aggregate).all()
          and resumed.pareto_names() == straight.pareto_names()
          and resumed.best_fit_map == straight.best_fit_map,
          "resumed shard_sweep differs from an uninterrupted one")
    log("phase 4: kill after shard 3/8 + resume == uninterrupted run")
    return dict(result=sh, counts=counts, seconds=shard_s, cells=cells)


# --------------------------------------------------------------------------- #
# Phase 5: timings
# --------------------------------------------------------------------------- #


def cuda_ms(torch, fn, reps=10, rounds=5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_timings(torch, core, KC, dev, p3):
    import numpy as np

    res = p3["result"]
    pb = core.ProfileBatch.from_profiles(p3["profiles"])
    p_stack = torch.as_tensor(np.stack(
        [np.asarray(r, np.float32) for r in list(pb.arrays()) + [res.beta]])).to(dev)
    m_stack = torch.as_tensor(np.stack(
        [np.asarray(r, np.float32) for r in res.machines.arrays()])).to(dev)
    from repro_torch.core.sweep import _shard_bounds

    # the first shard of phase 4's streamed population
    stream = core.PopulationStream(core.ParamSpace.default(), 1_000_000,
                                   include_named=core.VARIANTS)
    lo, hi = _shard_bounds(len(stream), 16)[0]
    m_shard = torch.as_tensor(np.stack(
        [np.asarray(r, np.float32)
         for r in stream.batch(lo, hi).arrays()])).to(dev)
    a, v, vs = p_stack.shape[1], m_stack.shape[1], m_shard.shape[1]
    p6 = p_stack[:6].contiguous()
    runs = {
        "congruence": ((a, v), lambda: KC.congruence(p_stack, m_stack, clamp=True),
                       lambda: KC.plain_congruence(p_stack, m_stack, clamp=True)),
        "step_time": ((a, v), lambda: KC.step_time(p6, m_stack),
                      lambda: KC.plain_step_time(p6, m_stack)),
        "default_beta": ((a, 1), lambda: KC.default_beta(p6, m_stack[:, :1].contiguous()),
                         lambda: KC.plain_default_beta(p6, m_stack[:, :1])),
        "sweep_stats": ((a, vs), lambda: KC.sweep_stats(p_stack, m_shard, clamp=True),
                        lambda: KC.plain_sweep_stats(p_stack, m_shard, clamp=True)),
    }
    rows = {}
    for name, ((ra, rv), kern, plain) in runs.items():
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain)
        bound_ms, bound_by = bound(name, ra, rv)
        rows[name] = dict(shape=[ra, rv], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(json.dumps({"timing": name, "A": ra, "V": rv, "ms": ms,
                        "plain_ms": plain_ms, "bound_us": bound_ms * 1e3,
                        "bound_by": bound_by, "library_ms": None,
                        "library": "none: no single PyTorch call computes "
                                   "this function"}))
    out = KC.congruence(p_stack, m_stack, clamp=True)
    torch.cuda.synchronize()
    d2h = []
    for _ in range(5):
        t0 = time.perf_counter()
        out.cpu()
        d2h.append((time.perf_counter() - t0) * 1e3)
    log(json.dumps({"end_to_end": "run_sweep", "A": a, "V": v,
                    "seconds": p3["seconds"],
                    "cells_per_s": a * v / p3["seconds"],
                    "d2h_ms_8xAxV": statistics.median(d2h),
                    "host_pareto_ms": p3["pareto_ms"]}))
    return rows


# --------------------------------------------------------------------------- #


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    import repro_torch.core as core
    from repro_torch.core import _build
    from repro_torch.core import kernels_cuda as KC

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    card = nvidia_smi()
    log(f"card: {card}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 1: built {_build.build_info['path']} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    errs = phase_kernels(torch, core, KC, dev)
    p3 = phase_run_sweep(torch, core, KC, dev)
    p4 = phase_shard_sweep(torch, core, KC, dev, p3["profiles"])
    rows = phase_timings(torch, core, KC, dev, p3)
    log(json.dumps({"end_to_end": "shard_sweep_streamed", "A": 64,
                    "V": p4["result"].num_variants,
                    "shards": p4["result"].num_shards,
                    "seconds": p4["seconds"],
                    "cells_per_s": p4["cells"] / p4["seconds"]}))

    kernels = []
    for name in REPLACES:
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=p3["counts"][name] + p4["counts"][name],
            max_abs_err=errs[name], ms=rows[name]["ms"],
            plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
            bound_by=rows[name]["bound_by"], library_ms=None))
        check(kernels[-1]["launches"] > 0, f"{name} never launched")
    log(json.dumps({"kernels": kernels}))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)

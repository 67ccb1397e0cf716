"""Model-zoo profile suites: the registry's configs as measured workloads.

The extraction half of the JAX package's ``repro/core/model_zoo.py``.
Every config in ``repro_torch.configs`` x scenario in {train,
serve-prefill, serve-decode} x a batch/seq grid
(``configs/shapes.zoo_shapes``) runs through ``launch.extract.run_cell``
-- the cell's step under the op counter, ``core.costs.OpCounter`` -- and
becomes a ``WorkloadProfile`` that plugs into ``run_sweep`` /
``shard_sweep`` / ``frontier_codesign`` / ``CodesignService``.

Profiles are cached as canonical JSON keyed by ``cell_fingerprint``, which
gives the JAX package's digests (the same config ``repr``, shape, scenario
and extraction version).  Where the JAX package records ``jax_version``,
the port's ``meta`` records ``torch_version``, ``extractor`` and
``device``.  The port keeps its own caches:

  * smoke suite (tiny configs) -- checked in under
    ``src/repro_torch/core/zoo_cache_torch/``, extracted on ``meta``;
  * full suite (published configs) -- cache-only under
    ``build/repro_torch/zoo/``, written by ``python -m
    repro_torch.core.model_zoo``.

As in the JAX package, smoke cells are profiled as one device and full
cells per device on the production pod mesh (``pod16x16``, 16 x 16) under
``launch.extract.default_variant``, with their collectives.  A pod cell
runs on ``meta`` in a child process that owns the fake process group of
the dry run (``launch.mesh.fake_world``); ``extract_profile(...,
mesh="1x1")`` profiles a full cell as one device instead.  A one-device
cell runs on ``device``: the card by default, the CPU, or ``meta`` --
counts from shapes alone, which is what the caches hold (the card's
allocator peak is the card's, not the cell's, and most full cells do not
fit on one card) and what the CLI extracts with by default, as the dry
run does.  A real run's counts equal the ``meta`` ones.  The
``zoo-smoke`` suite that ``core.suites.resolve_suite`` reads is still the
JAX package's six profiles in ``zoo_cache/``: they are the inputs the
port's sweep tests and ``chip_smoke.py`` share with the JAX package.

The calibration layer (``calibration_report``) cross-checks the two
step-time code paths on every cell: the batched path
(``sweep.batched_step_time``: kernel K2 on the card) against the scalar
roofline path (``roofline.analyze``, NumPy float64).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import (
    ShapeSpec,
    ZOO_SCENARIOS,
    scenario_kind,
    zoo_shapes,
)
from repro_torch.core import kernels_xp as K
from repro_torch.core import roofline as R
from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.machine import TPU_V5E, MachineModel
from repro_torch.core.sweep import MachineBatch, ProfileBatch, batched_step_time

#: The JAX package's extraction version (part of every fingerprint).
ZOO_EXTRACTION_VERSION = 1

#: Smoke suite: one arch per major family branch (dense attention, SSM).
SMOKE_ARCHS: Tuple[str, ...] = ("chatglm3-6b", "falcon-mamba-7b")

#: The port's checked-in smoke cache.
SMOKE_CACHE_DIR = os.path.join(os.path.dirname(__file__), "zoo_cache_torch")

#: The full suite's cache, under the repository's (ignored) build tree.
FULL_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "build", "repro_torch", "zoo")

#: The labels of the two extraction meshes: one device, and the JAX
#: package's production pod (16 x 16) for full cells.
ONE_DEVICE, POD = "1x1", "pod16x16"

#: Volatile meta fields dropped by canonicalization (wall-clock only).
_VOLATILE_META = ("probe_seconds", "extract_seconds")


@dataclasses.dataclass(frozen=True)
class ZooCell:
    """One (config, scenario, shape) extraction unit."""

    arch: str
    scenario: str
    shape: ShapeSpec
    smoke: bool

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape.name}"

    @property
    def cache_key(self) -> str:
        return f"{self.arch}__{self.shape.name}"

    @property
    def config(self):
        return get_config(self.arch, smoke=self.smoke)


def zoo_cells(
    archs: Optional[Sequence[str]] = None,
    scenarios: Optional[Sequence[str]] = None,
    *,
    smoke: bool = False,
) -> List[ZooCell]:
    """The zoo grid: every (arch x scenario x shape) cell, in stable order."""
    if archs is None:
        archs = SMOKE_ARCHS if smoke else ARCH_IDS
    scenarios = tuple(scenarios) if scenarios is not None else ZOO_SCENARIOS
    for s in scenarios:
        scenario_kind(s)  # validates the name
    return [
        ZooCell(arch=a, scenario=s, shape=shape, smoke=smoke)
        for a in archs
        for s in scenarios
        for shape in zoo_shapes(s, smoke=smoke)
    ]


# --------------------------------------------------------------------------- #
# Fingerprints + canonical JSON (the golden-file contract)
# --------------------------------------------------------------------------- #


def cell_fingerprint(cell: ZooCell) -> str:
    """Digest of everything that determines a cell's extracted costs: the
    full config (``repr`` of the frozen dataclass), the shape, the scenario
    and the extraction version -- the JAX package's payload, so the digests
    are the same."""
    payload = json.dumps(
        {
            "version": ZOO_EXTRACTION_VERSION,
            "arch": cell.arch,
            "scenario": cell.scenario,
            "smoke": cell.smoke,
            "config": repr(cell.config),
            "shape": dataclasses.asdict(cell.shape),
        },
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def canonical_profile_dict(profile: WorkloadProfile) -> dict:
    """JSON form with the wall-clock fields zeroed or dropped; everything
    else is a function of (config, shape, torch version, device)."""
    d = profile.to_json()
    d["compile_seconds"] = 0.0
    d["meta"] = {k: v for k, v in d.get("meta", {}).items()
                 if k not in _VOLATILE_META}
    return d


def canonical_profile_bytes(profile: WorkloadProfile) -> bytes:
    return (json.dumps(canonical_profile_dict(profile), indent=1,
                       sort_keys=True) + "\n").encode()


def cache_path(cell: ZooCell, cache_dir: str) -> str:
    return os.path.join(cache_dir, cell.cache_key + ".json")


def default_cache_dir(smoke: bool) -> str:
    return SMOKE_CACHE_DIR if smoke else FULL_CACHE_DIR


# --------------------------------------------------------------------------- #
# Extraction
# --------------------------------------------------------------------------- #


def extract_profile(cell: ZooCell, *, device="cuda", verbose: bool = False,
                    model=None, mesh: Optional[str] = None) -> WorkloadProfile:
    """Run one zoo cell's step under the op counter and build its profile.
    No depth probes (``launch.extract``): every layer runs.  ``mesh`` is
    ``"1x1"`` (one device, on ``device``; the default for smoke cells) or
    ``"pod16x16"`` (per device on the pod mesh under ``default_variant``,
    on ``meta`` in a child process; the default for full cells).
    ``model`` reuses weights already on ``device`` (a one-device inference
    cell)."""
    from repro_torch.launch import extract as EX

    mesh = mesh or (ONE_DEVICE if cell.smoke else POD)
    if mesh == POD:
        if str(device) != "meta" or model is not None:
            raise ValueError(
                f"{cell.name}: the pod mesh's placeholder devices exist on "
                "meta only (device='meta', no model); mesh='1x1' profiles "
                "the cell as one device")
        profile = _extract_on_pod(cell, verbose)
    elif mesh == ONE_DEVICE:
        profile = EX.run_cell(cell.config, cell.shape, None, device=device,
                              verbose=verbose, model=model)
    else:
        raise ValueError(f"mesh {mesh!r}: give {ONE_DEVICE!r} or {POD!r}")
    profile.meta.update(
        scenario=cell.scenario,
        suite="zoo-smoke" if cell.smoke else "zoo",
        fingerprint=cell_fingerprint(cell),
        extraction_version=ZOO_EXTRACTION_VERSION,
        extract_seconds=profile.compile_seconds,
    )
    return profile


def _extract_on_pod(cell: ZooCell, verbose: bool) -> WorkloadProfile:
    """``cell``'s profile on the pod mesh, from a child process: a process
    has one default process group, and the fake world takes it."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    code = ("import sys\n"
            "from repro_torch.core import model_zoo as PZ\n"
            "PZ._pod_child(*sys.argv[1:])\n")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        res = subprocess.run(
            [sys.executable, "-c", code, cell.arch, cell.scenario,
             cell.shape.name, str(int(cell.smoke)), str(int(verbose)), path],
            env=env, stdout=None if verbose else subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cell.name} on {POD} failed in its child "
                               f"process: {(res.stdout or '')[-3000:]}")
        return WorkloadProfile.load(path)


def _pod_child(arch: str, scenario: str, shape_name: str, smoke: str,
               verbose: str, path: str) -> None:
    """The child of ``_extract_on_pod``: the fake world, the pod mesh, the
    cell's step under the op counter, its profile saved to ``path``."""
    from repro_torch.launch import extract as EX
    from repro_torch.launch import mesh as MESH

    cell = next(c for c in zoo_cells((arch,), (scenario,), smoke=smoke == "1")
                if c.shape.name == shape_name)
    MESH.fake_world(MESH.DEVICES_PER_POD)
    EX.run_cell(cell.config, cell.shape, None, device="meta",
                verbose=verbose == "1",
                mesh=MESH.make_production_mesh(multi_pod=False),
                mesh_label=POD).save(path)


def _regen_command(smoke: bool) -> str:
    return ("PYTHONPATH=src python -m repro_torch.core.model_zoo"
            + (" --smoke" if smoke else "") + " --extract-device meta --refresh")


def profiles_from_configs(
    archs: Optional[Sequence[str]] = None,
    scenarios: Optional[Sequence[str]] = None,
    *,
    smoke: bool = False,
    cache_dir: Optional[str] = None,
    refresh: bool = False,
    extract_missing: bool = True,
    max_cells: Optional[int] = None,
    device="cuda",
    verbose: bool = False,
) -> List[WorkloadProfile]:
    """Registry configs -> WorkloadProfile suite, cache-first.

    For every cell of ``zoo_cells(archs, scenarios, smoke=...)``: load the
    cached profile if its fingerprint matches the cell, otherwise extract
    it on ``device`` and re-cache.  ``extract_missing=False`` makes a
    missing or stale entry an error (the cache-only mode of the suites)."""
    cache_dir = cache_dir or default_cache_dir(smoke)
    cells = zoo_cells(archs, scenarios, smoke=smoke)
    if max_cells is not None:
        cells = cells[:max_cells]
    out: List[WorkloadProfile] = []
    for cell in cells:
        path = cache_path(cell, cache_dir)
        if not refresh and os.path.exists(path):
            profile = WorkloadProfile.load(path)
            if profile.meta.get("fingerprint") == cell_fingerprint(cell):
                out.append(profile)
                continue
            if not extract_missing:
                raise RuntimeError(
                    f"zoo cache entry {path} is stale (config/shape/"
                    f"extraction-version changed since it was written); "
                    f"regenerate with: {_regen_command(smoke)}")
        elif not refresh and not extract_missing:
            raise RuntimeError(
                f"zoo cache entry {path} is missing; extract the suite "
                f"first: {_regen_command(smoke)[:-len(' --refresh')]}")
        if not extract_missing:
            raise RuntimeError(
                f"zoo cache entry {path} needs re-extraction but "
                f"extract_missing=False")
        if verbose:
            print(f"== zoo extract {cell.name} [{cell.scenario}] on {device} ==",
                  flush=True)
        profile = extract_profile(cell, device=device, verbose=verbose)
        os.makedirs(cache_dir, exist_ok=True)
        with open(path, "wb") as f:
            f.write(canonical_profile_bytes(profile))
        out.append(WorkloadProfile.from_json(canonical_profile_dict(profile)))
    return out


def resolve_zoo(scenario: Optional[str] = None, *,
                cache_dir: Optional[str] = None) -> List[WorkloadProfile]:
    """The full zoo suite (``zoo[:scenario]``), cache-only: a missing entry
    raises with the command that extracts it."""
    return profiles_from_configs(
        scenarios=(scenario,) if scenario else None, smoke=False,
        cache_dir=cache_dir, extract_missing=False)


# --------------------------------------------------------------------------- #
# Calibration: Eq.1 batched kernels vs the scalar roofline path
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class CalibrationCell:
    name: str
    scenario: str
    eq1_s: float          # batched kernel path (sweep.batched_step_time)
    roofline_s: float     # scalar path (roofline.analyze)
    ratio: float          # eq1_s / roofline_s
    dominant_eq1: str
    dominant_roofline: str

    @property
    def agree(self) -> bool:
        return self.dominant_eq1 == self.dominant_roofline


@dataclasses.dataclass(frozen=True)
class CalibrationReport:
    """Per-cell agreement between the two step-time code paths: ratio ~= 1
    and matching dominant terms on every cell is the invariant."""

    machine: str
    backend: str
    timing_model: str
    cells: Tuple[CalibrationCell, ...]

    @property
    def dominant_agreement(self) -> float:
        if not self.cells:
            return math.nan
        return sum(c.agree for c in self.cells) / len(self.cells)

    def worst_offenders(self, top_k: int = 5) -> List[CalibrationCell]:
        """Cells ranked by |log ratio| (worst Eq.1-vs-roofline mismatch)."""
        def badness(c: CalibrationCell) -> float:
            if not (math.isfinite(c.ratio) and c.ratio > 0):
                return math.inf
            return abs(math.log(c.ratio))
        return sorted(self.cells, key=badness, reverse=True)[:top_k]

    def to_json(self, top_k: Optional[int] = None) -> dict:
        return {
            "machine": self.machine,
            "backend": self.backend,
            "timing_model": self.timing_model,
            "num_cells": len(self.cells),
            "dominant_agreement": self.dominant_agreement,
            "worst_offenders": [c.name for c in self.worst_offenders()],
            "cells": [dataclasses.asdict(c)
                      for c in self.cells[:top_k or len(self.cells)]],
        }

    def markdown(self, top_k: Optional[int] = None) -> str:
        lines = [
            f"### Zoo calibration -- Eq.1 kernels vs roofline "
            f"({self.machine}, {self.backend} backend, "
            f"{self.timing_model} timing)",
            "",
            f"{len(self.cells)} cells, dominant-term agreement "
            f"{100.0 * self.dominant_agreement:.1f}%",
            "",
            "| cell | scenario | Eq.1 (s) | roofline (s) | ratio "
            "| dominant (Eq.1 / roofline) |",
            "|---|---|---|---|---|---|",
        ]
        shown = self.cells[:top_k or len(self.cells)]
        for c in shown:
            mark = "" if c.agree else " **!=**"
            lines.append(
                f"| {c.name} | {c.scenario} | {c.eq1_s:.3e} "
                f"| {c.roofline_s:.3e} | {c.ratio:.4f} "
                f"| {c.dominant_eq1} / {c.dominant_roofline}{mark} |")
        if len(shown) < len(self.cells):
            lines.append(f"| ... {len(self.cells) - len(shown)} more |  "
                         f"|  |  |  |  |")
        worst = self.worst_offenders()
        if worst:
            lines += ["", "Worst offenders (by |log ratio|): "
                      + ", ".join(f"{c.name} ({c.ratio:.4f})"
                                  for c in worst)]
        return "\n".join(lines)


def calibration_report(
    profiles: Sequence[WorkloadProfile],
    machine: MachineModel = TPU_V5E,
    *,
    backend: Optional[str] = None,
    timing_model: str = "serial",
    device=K.DEFAULT_DEVICE,
) -> CalibrationReport:
    """Cross-check Eq.1 batched step times against scalar roofline times.

    Step times on the batched side come from ``backend`` on ``device`` (the
    code every sweep runs: K2 on the card); dominant terms on both sides
    come from the NumPy float64 math / ``timing`` module respectively."""
    profiles = list(profiles)
    pb = ProfileBatch.from_profiles(profiles)
    mb = MachineBatch.from_models([machine])
    eq1 = batched_step_time(pb, mb, timing_model=timing_model,
                            backend=backend, device=device)[:, 0]
    tc, tm, ti = K.scaled_times(np, pb.arrays(), mb.arrays())
    terms = np.stack([tc[:, 0], tm[:, 0], ti[:, 0]])
    term_names = ("compute", "memory", "interconnect")
    cells = []
    for i, p in enumerate(profiles):
        rep = R.analyze(p, machine)
        roofline_s = (rep.step_time_serial_s if timing_model == "serial"
                      else rep.step_time_overlap_s)
        ratio = (float(eq1[i]) / roofline_s if roofline_s > 0 else math.nan)
        cells.append(CalibrationCell(
            name=p.name,
            scenario=str(p.meta.get("scenario", p.step_kind)),
            eq1_s=float(eq1[i]),
            roofline_s=roofline_s,
            ratio=ratio,
            dominant_eq1=term_names[int(np.argmax(terms[:, i]))],
            dominant_roofline=rep.dominant,
        ))
    be = K.get_backend(backend, device)
    return CalibrationReport(
        machine=machine.name,
        backend=be.name,
        timing_model=timing_model,
        cells=tuple(cells),
    )


# --------------------------------------------------------------------------- #
# CLI: extract/refresh the caches and print the calibration table
# --------------------------------------------------------------------------- #


def main(argv=None) -> int:
    """Extract the model-zoo profile suite and report its calibration.

      PYTHONPATH=src python -m repro_torch.core.model_zoo --smoke --device cpu
      PYTHONPATH=src python -m repro_torch.core.model_zoo --arch chatglm3-6b

    Smoke cells are extracted as one device on ``--extract-device``
    (``meta`` by default: the dry run's counts; ``cuda`` or ``cpu`` run
    them for real), full cells per device on the pod mesh, on ``meta``;
    the calibration's batched side runs on ``--device`` (the card unless
    ``cpu`` is asked for)."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="smoke suite (tiny configs, checked-in cache) "
                         "instead of the full registry")
    ap.add_argument("--arch", action="append", help="arch id(s); default all")
    ap.add_argument("--scenario", action="append", choices=ZOO_SCENARIOS,
                    help="scenario(s); default all")
    ap.add_argument("--cache-dir", default=None,
                    help="profile cache directory (default: the suite's "
                         "canonical cache)")
    ap.add_argument("--refresh", action="store_true",
                    help="re-extract even when the cached fingerprint matches")
    ap.add_argument("--max-cells", type=int, default=None, metavar="N",
                    help="extract at most N cells")
    ap.add_argument("--extract-device", default="meta",
                    help="device the smoke cells run on: meta (the dry "
                         "run, default) | cuda | cpu; full cells run on "
                         "the pod mesh, on meta")
    ap.add_argument("--device", default="cuda",
                    help="device of the calibration's batched step times")
    ap.add_argument("--out", default=None,
                    help="write the calibration report to <out>.md/.json "
                         "(default: stdout)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    profiles = profiles_from_configs(
        archs=tuple(args.arch) if args.arch else None,
        scenarios=tuple(args.scenario) if args.scenario else None,
        smoke=args.smoke,
        cache_dir=args.cache_dir,
        refresh=args.refresh,
        max_cells=args.max_cells,
        device=args.extract_device,
        verbose=True,
    )
    report = calibration_report(profiles, device=args.device)
    md = report.markdown()
    if args.out:
        with open(args.out + ".md", "w") as f:
            f.write(md + "\n")
        with open(args.out + ".json", "w") as f:
            json.dump(report.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}.{{md,json}}")
    else:
        print(md)
    print(f"{len(profiles)} profiles in {time.perf_counter() - t0:.1f} s; "
          f"dominant-term agreement {100.0 * report.dominant_agreement:.1f}%")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

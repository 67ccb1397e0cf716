"""Design-space sweep CLI -- score machine populations against profiles.

Generates a machine-variant population (grid or low-discrepancy random) from
``repro_torch.core.sweep.ParamSpace``, scores every (app x variant) cell on
the card (the Hopper kernels; ``--device cpu`` runs the plain version on the
host), and dumps the best-fit variants + Pareto front (aggregate congruence
vs. area proxy) as JSON and/or markdown.  Flags and outputs are those of the
JAX package's ``scripts/sweep.py``, plus ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.sweep --suite gen:64 --num 100000
  PYTHONPATH=src python -m repro_torch.launch.sweep --num 2048 --out sweep
  PYTHONPATH=src python -m repro_torch.launch.sweep --num 1000000 --stream \\
      --checkpoint-dir build/megasweep --resume --format md

Profiles come from ``benchmarks/artifacts/*.json`` (the dry-run outputs)
when present, else the synthetic trio, unless ``--suite``/``--gen`` names a
suite.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Tuple

from repro_torch.core.costs import WorkloadProfile
from repro_torch.core.kernels_xp import validate_backend_arg
from repro_torch.core.machine import TPU_V5E, VARIANTS
from repro_torch.core.suites import resolve_suite, validate_suite_name
from repro_torch.core.sweep import ParamSpace, run_sweep, shard_sweep

ART_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "benchmarks", "artifacts")


def load_profiles(mesh: str = "pod16x16") -> List[WorkloadProfile]:
    """Dry-run artifacts under ``benchmarks/artifacts``; mesh="" loads every
    mesh's artifacts."""
    profiles = []
    for path in sorted(glob.glob(os.path.join(ART_DIR, "*.json"))):
        p = WorkloadProfile.load(path)
        if mesh and p.mesh != mesh:
            continue
        profiles.append(p)
    return profiles


def synthetic_profiles() -> List[WorkloadProfile]:
    """Three apps, one dominated by each subsystem."""
    out = []
    mixes = [
        ("synthetic-compute", 2e14, 5e10, 5e9),
        ("synthetic-memory", 5e12, 8e11, 5e9),
        ("synthetic-collective", 5e12, 5e10, 8e10),
    ]
    for name, flops, hbm, coll in mixes:
        out.append(WorkloadProfile(
            name=name, arch=name, shape="train_4k", mesh="pod16x16",
            flops=flops, bytes_accessed=hbm, hbm_bytes=hbm,
            collective_bytes={"all-reduce": coll}, num_devices=256,
            model_flops=flops * 0.7 * 256, tokens=1 << 20))
    return out


def profiles_or_synthetic(mesh: str = "pod16x16"
                          ) -> Tuple[List[WorkloadProfile], bool]:
    profs = load_profiles(mesh)
    if profs:
        return profs, False
    return synthetic_profiles(), True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="pod16x16",
                    help="artifact mesh filter ('' = all meshes)")
    ap.add_argument("--suite", default=None, metavar="SUITE",
                    help="score a named suite instead of the dry-run "
                         "artifacts: zoo-smoke with an optional :scenario "
                         "(train | serve-prefill | serve-decode), or a "
                         "generated suite gen:<count>[:seed=S]"
                         "[:mode=halton|rng]")
    ap.add_argument("--gen", type=int, default=None, metavar="N",
                    help="score N generated stress workloads "
                         "(shorthand for --suite gen:N)")
    ap.add_argument("--mode", choices=("random", "grid"), default="random")
    ap.add_argument("--num", type=int, default=1024,
                    help="population size (grid rounds up per-dim)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--span", type=float, default=4.0,
                    help="sweep each rate this many x below/above nominal")
    ap.add_argument("--max-links", type=int, default=8)
    ap.add_argument("--beta", type=float, default=None,
                    help="explicit target step time (s); default: per-app "
                         "ideal-compute beta against the baseline variant")
    ap.add_argument("--timing-model", choices=("serial", "overlap"),
                    default="serial")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "version on the host)")
    ap.add_argument("--backend", default=None,
                    help="kernel backend: 'cuda' (the Hopper kernels) or "
                         "'torch' (the plain version); default: cuda on a "
                         "CUDA device, torch on the CPU")
    ap.add_argument("--shards", type=int, default=0, metavar="S",
                    help="score the population in S shards (shard_sweep): "
                         "on-device statistics + per-shard Pareto "
                         "pre-filter (0 = single-pass run_sweep)")
    ap.add_argument("--stream", action="store_true",
                    help="regenerate each shard's variants on the fly "
                         "(PopulationStream): never materializes the full "
                         "population; implies sharding (default shard "
                         "count keeps chunks ~64k variants)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="write resumable per-shard checkpoints to DIR")
    ap.add_argument("--resume", action="store_true",
                    help="with --checkpoint-dir: skip shards already "
                         "completed by a previous (killed) run; results "
                         "are byte-identical to an uninterrupted sweep")
    ap.add_argument("--abort-after-shard", type=int, default=None,
                    metavar="S", help="exit(3) after shard S completes "
                         "(deterministic kill hook for resume round trips)")
    ap.add_argument("--no-named", action="store_true",
                    help="do not prepend baseline/denser/densest")
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--format", choices=("json", "md", "both"), default="both")
    ap.add_argument("--out", default=None,
                    help="output path stem (default: stdout); writes "
                         "<out>.json / <out>.md per --format")
    args = ap.parse_args(argv)
    if args.num < 1:
        ap.error("--num must be >= 1")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    validate_backend_arg(ap, args.backend)
    if args.gen is not None:
        if args.suite:
            ap.error("--gen and --suite are mutually exclusive")
        if args.gen < 1:
            ap.error("--gen must be >= 1")
        args.suite = f"gen:{args.gen}"

    if args.suite:
        try:
            validate_suite_name(args.suite)
        except ValueError as exc:
            ap.error(str(exc))
        profiles, synthetic = resolve_suite(args.suite), False
        print(f"suite {args.suite}: {len(profiles)} profiles",
              file=sys.stderr)
    else:
        profiles, synthetic = profiles_or_synthetic(args.mesh)
    space = ParamSpace.default(nominal=TPU_V5E, span=args.span,
                               max_links=args.max_links)
    sweep_kwargs = dict(
        space=space,
        n=args.num,
        mode=args.mode,
        seed=args.seed,
        include_named=() if args.no_named else VARIANTS,
        beta=args.beta,
        timing_model=args.timing_model,
        backend=args.backend,
        device=args.device,
    )
    if args.shards > 0 or args.stream or args.checkpoint_dir:
        progress = None
        if args.abort_after_shard is not None:
            class _Abort(Exception):
                pass

            def progress(s, num_shards, lo, hi):
                print(f"shard {s + 1}/{num_shards} done [{lo}, {hi})",
                      file=sys.stderr)
                if s >= args.abort_after_shard:
                    raise _Abort
        try:
            # keep_top must cover --top: each shard keeps its local top-k,
            # so a smaller keep would silently prune global ranks out of
            # the report.
            sharded = shard_sweep(
                profiles,
                num_shards=args.shards if args.shards > 0 else None,
                keep_top=max(16, args.top), stream=args.stream,
                checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                progress=progress, **sweep_kwargs)
        except _Abort if args.abort_after_shard is not None else ():
            print(f"aborted after shard {args.abort_after_shard} "
                  f"(checkpoint in {args.checkpoint_dir})", file=sys.stderr)
            return 3
        result = sharded.result
        resumed = (f", {sharded.resumed_shards} shards resumed"
                   if sharded.resumed_shards else "")
        print(f"shard-swept {len(result.profiles)} apps x "
              f"{sharded.num_variants} variants in {sharded.num_shards} "
              f"shards ({sharded.mesh_axis}, {result.backend} backend"
              f"{', streamed' if sharded.streamed else ''}{resumed}"
              f"{', SYNTHETIC profiles' if synthetic else ''}); "
              f"{len(result.machines)} Pareto candidates kept; front: "
              f"{len(sharded.pareto_front())} variants "
              f"(3-D: {len(sharded.pareto_front_3d())})",
              file=sys.stderr)
        blob_source = sharded
    else:
        result = run_sweep(profiles, **sweep_kwargs)
        print(f"swept {len(result.profiles)} apps x {len(result.machines)} "
              f"variants on the {result.backend} backend"
              f"{' (SYNTHETIC profiles)' if synthetic else ''}; "
              f"pareto front: {len(result.pareto_front())} variants "
              f"(3-D: {len(result.pareto_front_3d())})",
              file=sys.stderr)
        blob_source = result

    blob = json.dumps(blob_source.to_json(top_k=args.top), indent=1,
                      sort_keys=True)
    md = blob_source.markdown(top_k=args.top)
    if args.out is None:
        if args.format in ("json", "both"):
            print(blob)
        if args.format in ("md", "both"):
            print(md)
    else:
        if args.format in ("json", "both"):
            with open(args.out + ".json", "w") as f:
                f.write(blob + "\n")
        if args.format in ("md", "both"):
            with open(args.out + ".md", "w") as f:
                f.write(md + "\n")
        print(f"wrote {args.out}.{{json,md}}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

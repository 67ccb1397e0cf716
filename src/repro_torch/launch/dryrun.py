"""Dry run: extract every (architecture x input-shape) cell's profile.

The JAX package's ``repro/launch/dryrun.py`` lowers and compiles each cell
on 512 placeholder host devices; the port runs each cell's step on the
``meta`` device under the op counter (``launch.extract.run_cell``): shapes
and dtypes only, nothing allocated, so a published config at its full
batch and sequence runs on any host.  ``--device cuda`` (or ``cpu``) runs
the cells for real instead, where they fit.  There are no XLA flags, no
mesh and no sharding variants (``launch/mesh.py`` and ``xla_flags.py``
have no counterpart).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b --smoke
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Artifacts: one JSON WorkloadProfile per cell under --out (default
``build/repro_torch/dryrun``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import traceback

from repro_torch import configs as C
from repro_torch.launch.extract import run_cell

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "repro_torch", "dryrun")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", action="append", help="arch id(s); default all")
    ap.add_argument("--shape", action="append", help="shape id(s); default all")
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs")
    ap.add_argument("--device", default="meta",
                    help="meta (the dry run, default) | cuda | cpu")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--moe-impl", default=None,
                    help="override MoE impl (gmm|dense|capacity)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    archs = tuple(args.arch) if args.arch else None
    shapes = tuple(args.shape) if args.shape else None
    for name in shapes or ():
        if name not in C.SHAPES:
            ap.error(f"unknown shape {name!r}; have {sorted(C.SHAPES)}")
    if args.list:
        for cfg, shape, ok, reason in C.cells(archs, shapes):
            status = "RUN" if ok else f"SKIP ({reason})"
            print(f"{cfg.name:22s} {shape.name:12s} {status}")
        return 0

    failures = []
    n_ok = n_skip = 0
    for cfg, shape, ok, reason in C.cells(archs, shapes):
        if not ok:
            n_skip += 1
            print(f"SKIP {cfg.name}/{shape.name}: {reason}")
            continue
        if args.smoke:
            cfg = C.get_config(cfg.name, smoke=True)
        if args.moe_impl and cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=args.moe_impl))
        print(f"== {cfg.name}/{shape.name} on {args.device} ==", flush=True)
        try:
            run_cell(cfg, shape, args.out, device=args.device, verbose=True,
                     tag=args.tag)
            n_ok += 1
        except Exception as exc:  # noqa: BLE001
            failures.append((cfg.name, shape.name, repr(exc)))
            traceback.print_exc()
            if args.fail_fast:
                return 1

    print(f"\ndry-run complete: {n_ok} cells extracted, {n_skip} skipped, "
          f"{len(failures)} failed")
    for f in failures:
        print("FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

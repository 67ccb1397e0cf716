"""Dry run: extract every (architecture x input-shape) cell's profile.

The JAX package's ``repro/launch/dryrun.py`` lowers and compiles each cell
on 512 placeholder host devices; the port runs each cell's step on the
``meta`` device under the op counter (``launch.extract.run_cell``): shapes
and dtypes only, nothing allocated, so a published config at its full
batch and sequence runs on any host.  ``--device cuda`` (or ``cpu``) runs
the cells for real instead, where they fit.

``--mesh 1x1`` (the default) profiles each cell as one device.  ``--mesh
pod`` (16 x 16, ``("data", "model")``), ``multipod`` (2 x 16 x 16, with
``"pod"``) or ``both`` profile it per device on the JAX package's
production meshes under ``--variant`` (``tp | zero1 | fsdp``; default
``default_variant``: fsdp above 20e9 parameters, else zero1), with the
collectives DTensor issues counted by kind.  Their 512 placeholder devices
are a fake process group (``launch.mesh.fake_world``) that this process
owns, so mesh cells run on ``meta`` only.  ``--sp off`` drops the
sequence sharding of the activations between blocks.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
      --shape train_4k [--mesh pod|multipod|both] [--variant fsdp]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b --smoke
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Artifacts: one JSON WorkloadProfile per cell under --out (default
``build/repro_torch/dryrun``), named ``arch__shape__1x1`` for one device
and ``arch__shape__mesh__variant`` (as the JAX package names them) on a
mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import traceback

from repro_torch import configs as C
from repro_torch.distributed.sharding import SHARDING_VARIANTS
from repro_torch.launch import mesh as MESH
from repro_torch.launch.extract import MESH_LABEL, default_variant, run_cell

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
    ap.add_argument("--mesh", choices=(MESH_LABEL, "pod", "multipod", "both"),
                    default=MESH_LABEL)
    ap.add_argument("--variant", choices=SHARDING_VARIANTS, default=None,
                    help="sharding variant on a mesh; default per arch")
    ap.add_argument("--sp", choices=("on", "off"), default="on",
                    help="sequence-parallel activation sharding")
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

    meshes = [(MESH_LABEL, None, False)]
    if args.mesh != MESH_LABEL:
        if args.device != "meta":
            ap.error("a mesh's placeholder devices exist on meta only (--device meta)")
        MESH.fake_world(512 if args.mesh in ("multipod", "both") else 256)
        meshes = []
        if args.mesh in ("pod", "both"):
            meshes.append(("pod16x16", MESH.make_production_mesh(multi_pod=False), False))
        if args.mesh in ("multipod", "both"):
            meshes.append(("pods2x16x16", MESH.make_production_mesh(multi_pod=True), True))

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
        for label, mesh, multi_pod in meshes:
            variant = (args.variant or default_variant(cfg)) if mesh is not None else None
            where = f"@ {label} [{variant}]" if mesh is not None else f"on {args.device}"
            print(f"== {cfg.name}/{shape.name} {where} ==", flush=True)
            try:
                run_cell(cfg, shape, args.out, device=args.device, verbose=True,
                         tag=args.tag, mesh=mesh, mesh_label=label, variant=variant,
                         multi_pod=multi_pod, sp=args.sp == "on")
                n_ok += 1
            except Exception as exc:  # noqa: BLE001
                failures.append((cfg.name, shape.name, label, repr(exc)))
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

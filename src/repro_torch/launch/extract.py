"""Extract one cell's ``WorkloadProfile`` by running its step under the op
counter (the JAX package's ``repro/launch/extract.py``).

``run_cell(cfg, shape, out_dir, device=...)`` builds the cell's step and
arguments (``launch.specs.input_specs``), runs the step once inside
``core.costs.OpCounter`` and fills the profile (``profile_from_counts``),
``model_flops`` from ``roofline.model_flops_for``.  On ``meta`` nothing is
computed or allocated: the counts come from shapes alone, which is the dry
run; on the card or the CPU the step runs for real and its counts equal
the ``meta`` ones (the MoE's expert split aside, ``models.layers``).

With a ``mesh`` (a ``DeviceMesh``; ``launch.mesh``) the cell runs sharded
under a ``variant`` (``distributed.sharding``), as the JAX package's
``run_cell(cfg, shape, mesh, mesh_label, variant, ...)`` compiles it: the
arguments are DTensors (``launch.specs``), the activation rules are
installed (``sp`` off drops the sequence sharding, as there), and the
counter counts one device's operations and the collectives DTensor issues,
by kind, with the bytes of groups that span pods (``multi_pod``: 256
devices a pod) in ``pod_collective_bytes``.  The profile's ``num_devices``
is the mesh's size and its artifact is named
``arch__shape__mesh__variant``; without a mesh it is the one-device
``1x1`` cell, named ``arch__shape__1x1`` as before.  The dry run's mesh
lives in a fake process group (``launch.mesh.fake_world``).

There are no depth probes.  The JAX package calibrates its counts
(``calibrate_costs``, ``_probe_cfg``, ``_lincomb``) because XLA's cost
analysis counts a while loop's body once, so a scanned layer stack is
counted as one layer; the port's layer loop is Python and every layer's
operations are counted.  The eager SSM and RG-LRU step loops are counted
op by op too, so there is no ``_analytic_scan_flops`` either: the
difference from the JAX package's calibrated ``flops`` is reported by the
tests, not papered over.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from repro_torch.core import costs as CO
from repro_torch.core import machine as M
from repro_torch.core import roofline as R
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import place as PL
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.launch.specs import input_specs

#: The profile's ``mesh``: one device, whatever it is.
MESH_LABEL = "1x1"


def default_variant(cfg) -> str:
    """Big archs need FSDP-style sharding to fit 16 GB/chip (the JAX
    package's rule)."""
    total, _ = cfg.param_counts()
    return "fsdp" if total > 20e9 else "zero1"


def run_cell(cfg, shape, out_dir: Optional[str] = None, *, device="cuda",
             verbose: bool = False, tag: str = "", seed: int = 0,
             model=None, mesh=None, mesh_label: Optional[str] = None,
             variant: Optional[str] = None, multi_pod: bool = False,
             sp: bool = True, devices_per_pod: Optional[int] = None
             ) -> CO.WorkloadProfile:
    """One cell's profile, extracted on ``device`` (``"meta"`` for the dry
    run).  ``model`` reuses weights already on ``device`` for an inference
    cell.  ``mesh`` shards it (module docstring): ``variant`` defaults to
    ``default_variant(cfg)``, ``mesh_label`` to the mesh's shape and
    ``devices_per_pod`` to 256 with ``multi_pod`` (a small test mesh
    passes its own)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    sharded = mesh is not None
    sc = None
    if sharded:
        variant = variant or default_variant(cfg)
        mesh_label = mesh_label or MESH.mesh_name(mesh)
        sc = SH.ShardingConfig(variant=variant, multi_pod=multi_pod)
    label = mesh_label if sharded else MESH_LABEL
    dpp = 0
    if multi_pod:
        dpp = MESH.DEVICES_PER_POD if devices_per_pod is None else int(devices_per_pod)
    cell = input_specs(cfg, shape, device=dev, seed=seed, model=model,
                       mesh=mesh, sc=sc)
    on_card = dev.type == "cuda"
    counter = CO.OpCounter(cell.args, track_memory=not on_card,
                           devices_per_pod=dpp)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    if sharded:
        rules = SH.activation_rules(mesh, sc, kind=shape.kind if sp else "decode")
        with PL.sharded_step(), CTX.use_rules(rules), counter:
            result = cell.step_fn(*cell.args)
    else:
        with counter:
            result = cell.step_fn(*cell.args)
    peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        peak = (counter.stats.argument_bytes
                + torch.cuda.max_memory_allocated(dev) - before)
    stats = counter.finish(result, peak_memory_bytes=peak)
    seconds = time.perf_counter() - t0
    model_flops = R.model_flops_for(
        params_active=cell.meta["params_active"], tokens=cell.meta["tokens"],
        step_kind="train" if shape.kind == "train" else "infer")
    meta = dict(device=dev.type, extractor="OpCounter",
                torch_version=torch.__version__, aten_ops=stats.ops)
    if sharded:
        meta.update(variant=variant, sp=bool(sp),
                    param_bytes_per_device=cell.meta["param_bytes"])
    profile = CO.profile_from_counts(
        f"{cfg.name}/{shape.name}@{label}", stats,
        arch=cfg.name, shape=shape.name, mesh=label, step_kind=shape.kind,
        num_devices=mesh.size() if sharded else 1, devices_per_pod=dpp,
        model_flops=model_flops, tokens=cell.meta["tokens"],
        params=cell.meta["params"], params_active=cell.meta["params_active"],
        compile_seconds=seconds, meta=meta)
    del cell, result
    if verbose:
        rep = R.analyze(profile, M.TPU_V5E)
        print("  " + rep.one_liner())
        print(f"  dot_flops {profile.dot_flops:.6e} flops {profile.flops:.6e} "
              f"hbm {profile.hbm_bytes:.6e} B peak "
              f"{profile.peak_memory_bytes / 1e9:.3f} GB, {stats.ops} ATen "
              f"operations on {dev.type} in {seconds:.2f} s")
        if sharded:
            coll = {k: f"{v / 1e9:.3f}GB" for k, v in profile.collective_bytes.items() if v}
            print(f"  per device on {label} [{variant}]: collectives {coll} "
                  f"pod-crossing {profile.pod_collective_bytes / 1e9:.3f}GB, "
                  f"parameters {meta['param_bytes_per_device'] / 1e9:.3f} GB")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        stem = f"{cfg.name}__{shape.name}__{label}" + (f"__{variant}" if sharded else "")
        fname = f"{stem}{('__' + tag) if tag else ''}.json"
        profile.save(os.path.join(out_dir, fname))
    return profile

"""Extract one cell's ``WorkloadProfile`` by running its step under the op
counter (the JAX package's ``repro/launch/extract.py``).

``run_cell(cfg, shape, out_dir, device=...)`` builds the cell's step and
arguments (``launch.specs.input_specs``), runs the step once inside
``core.costs.OpCounter`` and fills the profile (``profile_from_counts``),
``model_flops`` from ``roofline.model_flops_for``.  On ``meta`` nothing is
computed or allocated: the counts come from shapes alone, which is the dry
run; on the card or the CPU the step runs for real and its counts equal
the ``meta`` ones (the MoE's expert split aside, ``models.layers``).

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
from repro_torch.launch.specs import input_specs

#: The profile's ``mesh``: one device, whatever it is.
MESH_LABEL = "1x1"


def run_cell(cfg, shape, out_dir: Optional[str] = None, *, device="cuda",
             verbose: bool = False, tag: str = "", seed: int = 0,
             model=None) -> CO.WorkloadProfile:
    """One cell's profile, extracted on ``device`` (``"meta"`` for the dry
    run).  ``model`` reuses weights already on ``device`` for an inference
    cell."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    cell = input_specs(cfg, shape, device=dev, seed=seed, model=model)
    on_card = dev.type == "cuda"
    counter = CO.OpCounter(cell.args, track_memory=not on_card)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
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
    profile = CO.profile_from_counts(
        f"{cfg.name}/{shape.name}@{MESH_LABEL}", stats,
        arch=cfg.name, shape=shape.name, mesh=MESH_LABEL, step_kind=shape.kind,
        model_flops=model_flops, tokens=cell.meta["tokens"],
        params=cell.meta["params"], params_active=cell.meta["params_active"],
        compile_seconds=seconds,
        meta=dict(device=dev.type, extractor="OpCounter",
                  torch_version=torch.__version__, aten_ops=stats.ops))
    del cell, result
    if verbose:
        rep = R.analyze(profile, M.TPU_V5E)
        print("  " + rep.one_liner())
        print(f"  dot_flops {profile.dot_flops:.6e} flops {profile.flops:.6e} "
              f"hbm {profile.hbm_bytes:.6e} B peak "
              f"{profile.peak_memory_bytes / 1e9:.3f} GB, {stats.ops} ATen "
              f"operations on {dev.type} in {seconds:.2f} s")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{cfg.name}__{shape.name}__{MESH_LABEL}{('__' + tag) if tag else ''}.json"
        profile.save(os.path.join(out_dir, fname))
    return profile

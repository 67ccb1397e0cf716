"""Host and device time of the PyTorch port's K1-K4 calls, in one checkout
or in two side by side on one card.

  python3 scripts/torch_host_path.py                 # this checkout
  python3 scripts/torch_host_path.py --root DIR      # the checkout at DIR
  python3 scripts/torch_host_path.py --against DIR   # DIR, this, this, DIR

A measuring process imports ``repro_torch`` from ``<root>/src`` (its
kernels build into ``<root>/build``), makes chip_smoke.py's phase-5 inputs
(``run_sweep`` on gen:64 x 100 003, the first shard of the streamed
1 000 003-variant population) and prints one JSON line:

- ``backend_beta_ms``: ``CudaBackend.default_beta`` on the suite and its
  reference column, the median of 200 calls by a host clock that ends in
  the result's D2H, and its steps in host microseconds a call: the rows
  stacked and copied to the card, the wrapper, the D2H;
- ``k3_wrapper_us``: one ``default_beta`` wrapper call and its steps
  (checks, device check, column, output allocation, library lookup,
  stream, launch), each as that checkout's wrapper makes it;
- ``host_us``: host microseconds a call of each of the K1-K4 wrappers;
- ``device_us``: device time by ``torch.profiler`` of K1, K2 (back to back
  and after a 256 MB fill), K3 and, where the checkout has it, the launch
  floor; ``event_ms``: K2 and K3 by CUDA events.

``--against DIR`` runs four such processes, DIR, this checkout, this
checkout, DIR, so that a drift of the card or of its host over the window
weighs on both alike, and prints each line and then the ratio of this
checkout's mean to DIR's for every number.  The timers are chip_smoke.py's.
It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wrapper_steps(torch, KC, p6, col):
    """One ``default_beta`` wrapper call split into its steps, each as
    this checkout's wrapper makes it."""
    a = p6.shape[1]
    if hasattr(KC, "_fn"):  # entry points looked up once, raw stream
        lookup = lambda: KC._fn("repro_default_beta")
        stream = lambda: KC._stream(p6)
        empty = lambda: p6.new_empty((a,))
        column = lambda: col if col.shape[1] == 1 else col[:, :1].contiguous()
    else:  # the library through its lock, a Stream object, a column copy
        lookup = lambda: KC._lib().repro_default_beta
        stream = lambda: KC._stream()
        empty = lambda: torch.empty((a,), dtype=torch.float32, device=p6.device)
        column = lambda: col[:, :1].contiguous()
    fn, out = lookup(), empty()
    args = (p6.data_ptr(), a, col.data_ptr(), out.data_ptr(), stream())
    return {"checks": lambda: KC._check_stacks(p6, col, 6),
            "on_kernel": lambda: KC._on_kernel(p6, col),
            "column": column, "empty": empty, "library_lookup": lookup,
            "stream": stream, "launch": lambda: KC._launch(fn, *args),
            "whole_call": lambda: KC.default_beta(p6, col)}


def backend_steps(torch, KC, be, p_rows, ref):
    """``CudaBackend.default_beta`` split into its steps, each as this
    checkout's backend makes it: the rows to the card, the wrapper, the
    D2H of the result."""
    if hasattr(KC, "pack_beta"):  # one packed buffer, one H2D copy
        to_card = lambda: KC.beta_views(torch.from_numpy(KC.pack_beta(p_rows, ref))
                                        .to(be.device))
    else:  # two stacks, two H2D copies
        to_card = lambda: (be._stack(p_rows), be._stack(ref))
    p6, col = to_card()
    out = KC.default_beta(p6, col)
    return {"stack_and_h2d": to_card,
            "wrapper": lambda: KC.default_beta(p6, col),
            "d2h": lambda: be.to_numpy(out)}


def measure(root: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as CS

    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch.core as core
    from repro_torch.core import kernels_cuda as KC
    from repro_torch.core.sweep import _shard_bounds

    if not torch.cuda.is_available():
        raise SystemExit("torch_host_path: no CUDA device")
    dev = "cuda"
    card = CS.nvidia_smi()
    profiles = core.resolve_suite("gen:64")
    res = core.run_sweep(profiles, n=100_000, include_named=core.VARIANTS,
                         device=dev)
    pb = core.ProfileBatch.from_profiles(profiles)
    f32 = lambda rows: torch.as_tensor(np.stack(
        [np.asarray(r, np.float32) for r in rows])).to(dev)
    p_stack = f32(list(pb.arrays()) + [res.beta])
    m_stack = f32(res.machines.arrays())
    stream = core.PopulationStream(core.ParamSpace.default(), 1_000_000,
                                   include_named=core.VARIANTS)
    lo, hi = _shard_bounds(len(stream), 16)[0]
    m_shard = f32(stream.batch(lo, hi).arrays())
    p6 = p_stack[:6].contiguous()
    col = m_stack[:, :1].contiguous()

    be = KC.CudaBackend(dev)
    p_rows, ref = pb.arrays(), res.machines.select(0).arrays()
    out = {"root": os.path.abspath(root), "card": card}
    out["backend_beta_ms"] = CS.host_ms_median(
        torch, lambda: be.default_beta(p_rows, ref))
    split = lambda steps: {k: CS.host_us(torch, f) for k, f in steps.items()}
    out["backend_beta_steps_us"] = split(backend_steps(torch, KC, be, p_rows, ref))
    out["k3_wrapper_us"] = split(wrapper_steps(torch, KC, p6, col))
    calls = {"congruence": lambda: KC.congruence(p_stack, m_stack, clamp=True),
             "step_time": lambda: KC.step_time(p6, m_stack),
             "default_beta": lambda: KC.default_beta(p6, col),
             "sweep_stats": lambda: KC.sweep_stats(p_stack, m_shard, clamp=True)}
    out["host_us"] = {k: CS.host_us(torch, f) for k, f in calls.items()}
    flush_buf = torch.empty(CS.FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    flush = lambda: flush_buf.fill_(1)
    out["device_us"] = {
        "congruence": CS.device_us(torch, calls["congruence"], "congruence_k"),
        "step_time_warm": CS.device_us(torch, calls["step_time"], "step_time_k"),
        "step_time_cold": CS.device_us(torch, calls["step_time"], "step_time_k",
                                       between=flush),
        "default_beta": CS.device_us(torch, calls["default_beta"], "default_beta_k")}
    out["event_ms"] = {
        "step_time_warm": CS.cuda_ms(torch, calls["step_time"]),
        "step_time_cold": CS.cold_ms(torch, calls["step_time"], flush),
        "default_beta": CS.cuda_ms(torch, calls["default_beta"])}
    if hasattr(KC, "launch_floor"):
        floor = lambda: KC.launch_floor(p6, col)
        out["device_us"]["launch_floor"] = CS.device_us(torch, floor, "launch_floor_k")
        out["event_ms"]["launch_floor"] = CS.cuda_ms(torch, floor)
        out["host_us"]["launch_floor"] = CS.host_us(torch, floor)
    torch.cuda.synchronize()
    return out


def _numbers(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _numbers(v, f"{prefix}{k}.")
        elif isinstance(v, (int, float)):
            yield f"{prefix}{k}", float(v)


def against(other: str, script: str = __file__) -> int:
    """``other``, this checkout, this checkout, ``other``: one process
    each of ``script --root``; every line, then this checkout's mean over
    ``other``'s."""
    runs = []
    for root in (other, HERE, HERE, other):
        got = subprocess.run([sys.executable, os.path.abspath(script),
                              "--root", root], capture_output=True, text=True,
                             timeout=900)
        if got.returncode != 0:
            sys.stderr.write(got.stderr)
            return got.returncode
        line = got.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(dict(_numbers(json.loads(line))))
    # keys of both runs of a checkout (a cached build of an older
    # checkout may report less)
    before = {k: (runs[0][k] + runs[3][k]) / 2 for k in runs[0] if k in runs[3]}
    after = {k: (runs[1][k] + runs[2][k]) / 2 for k in runs[1] if k in runs[2]}
    print(json.dumps({"order": "before, after, after, before",
                      "before": os.path.abspath(other), "after": HERE,
                      "before_mean": before, "after_mean": after,
                      "after_over_before": {k: after[k] / before[k]
                                            for k in after
                                            if k in before and before[k]}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose repro_torch is measured")
    ap.add_argument("--against", metavar="DIR",
                    help="compare DIR with this checkout, in turns")
    args = ap.parse_args()
    if args.against:
        return against(args.against)
    print(json.dumps(measure(args.root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the span recorder (``repro_torch.tracing``) costs a prefill request
on the card: recorder on against off, in turns, in one process.

    python3 scripts/recorder_cost.py [--workload qwen1.5-4b.prefill_chat]
        [--seed N] [--rounds 10] [--block 12] [--profile 0|1]

Sets up a cell of the benchmark as ``perfbench/run.py`` does (the weights,
caches and traffic from the seed, then one warm-up request a shape), then
serves ``rounds`` pairs of blocks of ``block`` requests back to back, the
recorder off and on in turns (off / on, then on / off, ...), a fresh
recording each block.  Each request is timed from its submission to its
next-token ids on the host, as the benchmark's window counts it.  With
``--profile 1`` every block runs under the benchmark's traced-slice
profiler (``torch.profiler``, CUDA activity only).  Prints one JSON line:
ms a request each way (median, mean), on over off, and the spans a
request the recorder kept.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="qwen1.5-4b.prefill_chat")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 29)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--block", type=int, default=12)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("recorder_cost: needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench import spec
    from perfbench.run import Program
    from perfbench.traffic import Traffic, stream_seed
    from repro_torch import tracing

    cell, prog, dev = spec.load_cell(args.workload), Program(), "cuda:0"
    ref, config = cell.reference, cell.config
    cfg = prog.config(config["port"])
    model = prog.model(cfg, ref.make_weights(config, stream_seed(args.seed, 3), dev))
    traffic = Traffic(cell.traffic, args.seed, ref.sizes(config)["vocab"])
    caches = {shape: prog.cache(cfg, *shape, dev) for shape in traffic.shapes()}

    def serve(i, warm=False):
        tokens = traffic.tokens(i, dev, warm)
        cache = caches[tuple(tokens.shape)]
        t0 = time.perf_counter()
        for entry in ref.STATE_ENTRIES:
            cache[entry].zero_()
        _, logits = prog.prefill(model, cfg, {"tokens": tokens}, cache)
        logits[:, -1].argmax(dim=-1).tolist()
        return (time.perf_counter() - t0) * 1e3

    for i in range(len(traffic.shapes())):
        serve(i, warm=True)
    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()

    from torch.profiler import ProfilerActivity, profile

    ms = {False: [], True: []}
    spans_a_request = []
    n = 0
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            prof = profile(activities=[ProfilerActivity.CUDA]) if args.profile else None
            if prof is not None:
                prof.__enter__()
            rec = tracing.enable() if on else None
            for _ in range(args.block):
                ms[on].append(serve(n))
                n += 1
            tracing.disable()
            if prof is not None:
                prof.__exit__(None, None, None)
            if rec is not None:
                spans_a_request.append(len(rec.records) / args.block)
    off, on = ms[False], ms[True]
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "profile": bool(args.profile), "requests_each": len(off),
           "off_ms": {"median": statistics.median(off), "mean": statistics.fmean(off)},
           "on_ms": {"median": statistics.median(on), "mean": statistics.fmean(on)},
           "on_over_off_median": statistics.median(on) / statistics.median(off),
           "on_over_off_mean": statistics.fmean(on) / statistics.fmean(off),
           "spans_a_request": statistics.fmean(spans_a_request)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The control of a cell's check: the plain reference computed in float8
e4m3 (every matmul's operands rounded, one scale a tensor), the nearest
precision below the configuration's bf16 compute, put in the program's
place and held to the float32 reference by the cell's own comparison.  A
limit sits below what it reads.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

runs one request of each of the cell's shapes a seed, at the cell's sizes,
on the card, and prints one JSON line a request.  The benchmark's runs do
not run it; ``perfbench/tests`` runs the same at the smoke sizes."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(cell, seed: int, device) -> list:
    """The control's numbers for one request of each shape of ``cell``."""
    import torch

    from perfbench import check
    from perfbench.traffic import Traffic, stream_seed

    ref, config = cell.reference, cell.config
    weights = ref.make_weights(config, stream_seed(seed, 3), device)
    traffic = Traffic(cell.traffic, seed, ref.sizes(config)["vocab"])
    out = []
    for i in range(len(traffic.shapes())):
        tokens = traffic.tokens(i, device)
        cache = {}

        def keep(layer, entries):
            for name, t in entries.items():
                if name not in cache:
                    cache[name] = torch.empty((ref.sizes(config)["layers"], *t.shape),
                                              dtype=torch.float32, device=device)
                cache[name][layer].copy_(t)

        logits = ref.prefill(weights, config, tokens, precision="float8", on_layer=keep)
        control = {"tokens": tokens, "logits": logits, "cache": cache}
        out.append({"shape": list(tokens.shape),
                    **check.compare(ref, weights, config, control)})
        del cache, logits, control
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    # the script's own folder would shadow standard modules (trace, ...)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
    sys.path[:0] = [str(ROOT)]
    import torch

    from perfbench import spec

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for r in control_readings(cell, seed, "cuda:0"):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "seconds": time.perf_counter() - t0, **r}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

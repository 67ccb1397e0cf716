"""The port's benchmark: run one cell of ``BENCHMARK.json`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell is a configuration
(``perfbench/configs/``) under a traffic mix (``perfbench/traffic/``):
one client sends prefill requests back to back through the port's
``models.transformer.prefill`` (what ``serving.engine.make_prefill_step``
wraps), each request a batch of prompts with a cache exactly as long as
them, complete when its last-token logits are reduced to next-token ids
on the host.  The window opens at the first request after set-up (the
port imported, the weights drawn on the card from the seed, one warm-up
request a shape; timed from a live CUDA context, so importing torch and
starting CUDA are left out) and closes when the first request to complete
after ``--seconds`` completes.  Then one request of each shape, drawn from
the seed, is held to the family's plain reference
(``perfbench/check.py``).

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` puts
``torch.profiler`` around a slice of whole requests and reports its
per-layer metrics, read by ``perfbench/metrics/<metric>.py``.  The last
line of standard output is one JSON object; a run with no CUDA card, with
fewer cards than the cell asks for, without the port beside it, or that
loaded JAX or the JAX package prints none and exits with a code other
than 0.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: top-level module names the run must never hold (the JAX package is
#: ``repro``; the port, ``repro_torch``, only begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Program:
    """The system under test, the port: its config registry, model,
    caches and prefill."""

    def config(self, port: dict):
        """The registry's config with ``port.replace`` applied (a dict for a
        nested group replaces fields of that group)."""
        import dataclasses

        from repro_torch.configs import get_config

        cfg = get_config(port["registry"])
        repl = {k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict) else v
                for k, v in port.get("replace", {}).items()}
        return cfg.replace(**repl)

    def model(self, cfg, weights):
        from repro_torch.models import transformer as T

        return T.Model(cfg, weights)

    def cache(self, cfg, B, S, device):
        from repro_torch.models import transformer as T

        return T.init_cache(cfg, B, S, device=device)

    def prefill(self, model, cfg, batch, cache):
        from repro_torch.models import transformer as T

        return T.prefill(model, cfg, batch, cache)


def _same_sizes(cfg, config: dict) -> None:
    """The port's config has the configuration file's sizes: each entry of
    its ``port.sizes`` maps a field of the port's config (dotted into a
    nested group) to the file's key."""
    for field, key in config["port"]["sizes"].items():
        got = cfg
        for part in field.split("."):
            got = getattr(got, part)
        if got != config[key]:
            raise ValueError(f"the port's {field} is {got!r}, the configuration "
                             f"file's {key} {config[key]!r}")


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        program: Program = None, t_setup: float = None) -> dict:
    """One run of ``cell`` (``spec.Cell``) on ``device``, its set-up timed
    from ``t_setup`` (``time.perf_counter()``; the call when None): -> the
    result object, ending with ``checks``, each number compared beside its
    limit."""
    import torch

    from perfbench import check, trace as tr
    from perfbench.traffic import Traffic, stream_seed

    t_setup = time.perf_counter() if t_setup is None else t_setup
    program = program or Program()
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mark(what):
        print(f"perfbench setup {what} {time.perf_counter() - t_setup:.3f} s",
              file=sys.stderr)

    mark("imports")
    ref, config, mix = cell.reference, cell.config, cell.traffic
    cfg = program.config(config["port"])
    _same_sizes(cfg, config)
    weights = ref.make_weights(config, stream_seed(seed, 3), device)
    model = program.model(cfg, weights)
    traffic = Traffic(mix, seed, ref.sizes(config)["vocab"])
    # a live cache and a kept one a shape: the request drawn for the check
    # swaps its cache out of service (no copy)
    bufs = {shape: [program.cache(cfg, *shape, device) for _ in range(2)]
            for shape in traffic.shapes()}

    def serve(i, warm=False):
        tokens = traffic.tokens(i, device, warm)
        shape = tuple(tokens.shape)
        live = bufs[shape][0]
        t_sub = time.perf_counter()
        for entry in ref.STATE_ENTRIES:
            live[entry].zero_()
        t0 = time.perf_counter()
        _, logits = program.prefill(model, cfg, {"tokens": tokens}, live)
        t1 = time.perf_counter()
        logits[:, -1].argmax(dim=-1).tolist()    # the next-token ids, on the host
        t_done = time.perf_counter()
        return shape, logits, t_sub, t_done, (t1 - t0) * 1e3

    sync()
    mark("weights and caches")
    for i in range(len(traffic.shapes())):
        serve(i, warm=True)
    sync()
    mark("warm-up")
    gc.collect()
    gc.freeze()

    rng = traffic.check_rng()
    seen = {shape: 0 for shape in bufs}
    samples = {}
    enq_ms, tokens_done = [], 0
    sl = mix["trace_slice"]
    lo, hi = (sl["skip"], sl["skip"] + sl["requests"]) if trace else (-1, -1)
    prof, slice_t0, slice_t1 = None, None, None
    t_open = t_last = None
    n = 0
    while True:
        if n == lo:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
            prof.__enter__()
            slice_t0 = time.perf_counter()
        shape, logits, t_sub, t_done, e_ms = serve(n)
        if n == hi - 1:
            prof.__exit__(None, None, None)
            slice_t1 = t_done
        t_open = t_sub if t_open is None else t_open
        t_last = t_done
        if not lo <= n < hi:
            enq_ms.append(e_ms)
        tokens_done += shape[0] * shape[1]
        seen[shape] += 1
        if rng.integers(seen[shape]) == 0:     # each request of a shape alike
            b = bufs[shape]
            b[0], b[1] = b[1], b[0]
            samples[shape] = (n, logits, b[1])
        n += 1
        if t_done - t_open >= seconds and (not trace or n >= hi):
            break
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_s = t_last - t_open

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else torch.device(device).type,
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        slc = tr.Slice(ops=tr.from_profiler(prof, cell.kernels), wall_s=slice_t1 - slice_t0,
                       requests=[traffic.shape(i) for i in range(lo, hi)],
                       enqueue_ms_outside=enq_ms, config=config, reference=ref,
                       kernels=cell.kernels)
        result["metrics"] = tr.read_metrics(slc, cell.per_layer, cell.readers)
        result["device"].update(busy_s=slc.busy_s(), window_s=slc.wall_s)
        result["breakdown"] = slc.breakdown()
        del prof, slc
    else:
        values = {"prefill_tokens_per_s": tokens_done / window_s,
                  "setup_s": t_open - t_setup}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}

    # the reference runs on what is left: the weights and the kept requests
    for shape in bufs:
        bufs[shape][0] = None
    del logits
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = []
    for i, logits_i, cache_i in sorted(samples.values(), key=lambda v: v[0]):
        served = {"tokens": traffic.tokens(i, device), "logits": logits_i[:, -1],
                  "cache": cache_i}
        readings.append(check.compare(ref, weights, config, served))
    limits = cell.limits["limits"]
    numbers = check.worst_of(readings)
    result["failed"] = sum(not check.judge(r, limits) for r in readings)
    result["correct"] = bool(readings) and check.judge(numbers, limits)
    result["checks"] = {k: {"value": numbers.get(k), "limit": lim}
                        for k, lim in limits.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the script's own folder would shadow standard modules (trace, ...)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "perfbench" / "out" / "cache" / sub))

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the port (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from perfbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.ones(1, device="cuda:0")         # the CUDA context, before set-up is timed
    torch.cuda.synchronize()
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                 t_setup=time.perf_counter())
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"perfbench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

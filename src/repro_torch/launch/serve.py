"""Serving launcher: the continuous-batching engine on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3-6b \\
      --smoke --requests 6 --slots 2 --new-tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The JAX package's ``repro.launch.serve`` flags, plus ``--device`` (the card
unless ``cpu`` is asked for) and ``--seed`` (the ``torch.Generator`` the
random weights are drawn from).  Every ``--arch`` of the registry is
served: dense (``chatglm3-6b``, the default, ``qwen3-32b``, ``qwen1.5-4b``,
``deepseek-67b``), SSM (``falcon-mamba-7b``), MoE (``qwen2-moe-a2.7b``,
``grok-1-314b``), hybrid (``recurrentgemma-9b``), audio
(``whisper-medium``) and VLM (``paligemma-3b``).  As in the JAX package
the engine admits prompts token by token through ``decode_step``, so
whisper's cross cache and paligemma's vision prefix stay empty.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import configs as C
from repro_torch.core.kernels_xp import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.engine import BatchedEngine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="chatglm3-6b", choices=C.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = C.get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    model = T.init_model(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    engine = BatchedEngine(model, cfg, slots=args.slots, max_len=args.max_len,
                           device=dev)
    for i in range(args.requests):
        engine.submit(Request(
            rid=i, prompt=[(13 * i + j) % cfg.vocab_size for j in range(4)],
            max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    engine.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"served {args.requests} requests in {dt:.1f}s "
          f"({args.requests * args.new_tokens / dt:.1f} tok/s) on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

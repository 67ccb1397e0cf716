"""Time the FMA K5 kernel (``repro_flash_attention``, float32 FMAs) of this
checkout, or of two checkouts side by side on one card.

  python3 scripts/fa_fma_against.py                 # this checkout
  python3 scripts/fa_fma_against.py --root DIR      # the checkout at DIR
  python3 scripts/fa_fma_against.py --against DIR   # DIR, this, this, DIR

A measuring process imports ``repro_torch`` from ``<root>/src`` (its
kernels build into ``<root>/build``), draws seeded inputs on the card in
the model's layout ((B, S, H, D) projections handed over as transposed
views) and calls the library's ``repro_flash_attention`` through
chip_smoke.py's ``_fma_kernel_causal``, causal with the default scale, at:

- ``chatglm3-6b``: B 4, H 32, K 2, S = T 2048, D 128, in f32 (the f32
  forward's shape) and in bf16 (the tensors phase 6 of chip_smoke.py times
  the FMA kernel on, for the record);
- ``paligemma-3b``: B 4, H 8, K 1, S = T 2048, D 256, in f32 and bf16.

It prints one JSON line: per shape and dtype the kernel's time by CUDA
events (chip_smoke.py's ``cuda_ms``: median of 5 rounds of 10 launches),
its max abs error against the checkout's plain version, TFLOP/s and the
share of the f32 FMA peak; and ptxas's registers and spills of the
checkout's FMA kernel instantiations.  ``--against DIR`` runs four such
processes, DIR, this checkout, this checkout, DIR, so that a drift of the
card over the window weighs on both alike, and prints each line and then
this checkout's mean over DIR's.  It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name: (B, H, K, S, D)
SHAPES = {"chatglm3-6b": (4, 32, 2, 2048, 128), "paligemma-3b": (4, 8, 1, 2048, 256)}


def measure(root: str) -> dict:
    import torch

    sys.path.insert(0, HERE)
    import chip_smoke as CS

    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core import _build
    from repro_torch.kernels.ref import flash_attention_ref

    if not torch.cuda.is_available():
        raise SystemExit("fa_fma_against: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {"root": os.path.abspath(root), "card": CS.nvidia_smi(), "ms": {},
           "max_abs_err": {}, "tflops": {}, "share_of_f32_fma_peak": {}}

    def call(q, k, v):
        return CS._fma_kernel_causal(torch, q, k, v)

    for name, (B, H, K, S, D) in SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}.{str(dtype).split('.')[-1]}"
            q, k, v = (torch.randn((B, S, n, D), generator=gen, device="cuda")
                       .to(dtype).transpose(1, 2) for n in (H, K, K))
            got, want = call(q, k, v), flash_attention_ref(q, k, v, causal=True)
            out["max_abs_err"][key] = float((got.float() - want.float()).abs().max())
            del got, want
            ms = CS.cuda_ms(torch, lambda: call(q, k, v))
            _, ops = CS.attention_work(B, H, K, S, S, D, True, None, q.element_size())
            out["ms"][key] = ms
            out["tflops"][key] = ops / ms / 1e9
            out["share_of_f32_fma_peak"][key] = ops / CS.F32_OPS_PER_S * 1e3 / ms
    fma = CS.fma_instantiations(CS.ptxas_report(_build.build_info.get("log", "")))
    out["ptxas"] = {f"{dname}.{dp}": props for (dname, dp), props in sorted(fma.items())}
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose FMA K5 kernel is measured")
    ap.add_argument("--against", metavar="DIR",
                    help="compare DIR with this checkout, in turns")
    args = ap.parse_args()
    if args.against:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from torch_host_path import against

        return against(args.against, __file__)
    print(json.dumps(measure(args.root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Check and time K5 at head dim 256 in bf16, where the route gives it the
tensor-core kernel (``flash_attention_sm90.cu``, 80-key tiles).

  python3 scripts/fa_d256.py

It builds the kernels, reports ptxas's registers, spills and the dynamic
shared memory of each instantiation of the tensor-core kernel, holds the
wrapper (``kernels.flash_attention.flash_attention``) at head dim 256
against the plain version at 2e-2 on ragged shapes around the 80-key
tiles, the 64-row halves and the 128-row tiles (MQA and GQA; causal,
causal with a window of 64, and window 0, where no row has a live key),
and checks that each call took the tensor-core kernel.  Then, at recurrentgemma-9b's local attention (B 4,
H 16, K 1, S = T 2048, window 2048) and paligemma-3b's (B 4, H 8, K 1,
S = T 2048, causal), both in the model's layout ((B, S, H, D) projections
handed over as transposed views), it times the wrapper by CUDA events and
by the profiler's device time, the FMA kernel on the same tensors
(chip_smoke.py's ``_fma_kernel_causal``) and
``scaled_dot_product_attention`` (SDPA), beside the card's bound.  It
prints one JSON line with the card's name and power limit.  It needs one
CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name: (B, H, K, S, D, window)
SHAPES = {"recurrentgemma-9b": (4, 16, 1, 2048, 256, 2048),
          "paligemma-3b": (4, 8, 1, 2048, 256, None)}
#: (B, H, K, S) held at head dim 256
HELD = [(1, 4, 1, n)
        for n in (1, 63, 64, 65, 79, 80, 81, 127, 128, 129, 159, 160, 161, 257)]
HELD += [(2, 8, 2, 255), (2, 16, 1, 2048)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fa_d256: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as CS
    from repro_torch.core import _build
    from repro_torch.kernels import flash_attention as FA

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _build.lib()
    sm90 = CS.sm90_instantiations(CS.ptxas_report(_build.build_info.get("log", "")))
    out = {"card": CS.nvidia_smi(),
           "ptxas": {d: dict(props, smem_bytes=lib.repro_flash_attention_sm90_smem_bytes(d))
                     for d, props in sorted(sm90.items())},
           "held": 0, "max_abs_err": 0.0, "timings": {}}
    gen = torch.Generator(device="cuda").manual_seed(21)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    for B, H, K, S in HELD:
        q = rand(B, S, H, 256).transpose(1, 2)
        k, v = (rand(B, S, K, 256).transpose(1, 2) for _ in range(2))
        for window in (None, 64, 0):
            before = FA.flash_attention.launches_wgmma
            err = CS._fa_check(torch, FA, q, k, v, True, window,
                               f"D 256 B={B} H={H} K={K} S={S} window={window}")
            CS.check(FA.flash_attention.launches_wgmma == before + 1,
                     f"D 256 S={S}: the call did not take the tensor-core kernel")
            out["held"] += 1
            out["max_abs_err"] = max(out["max_abs_err"], err)
    torch.cuda.synchronize()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (B, H, K, S, D, window) in SHAPES.items():
        q, k, v = (rand(B, S, n, D).transpose(1, 2) for n in (H, K, K))
        call = lambda: FA.flash_attention(q, k, v, causal=True, window=window)
        ms = CS.cuda_ms(torch, call)
        device_ms = CS.device_us(torch, call, "flash_attention_sm90") / 1e3
        fma_ms = CS.cuda_ms(torch, lambda: CS._fma_kernel_causal(torch, q, k, v))
        sdpa_ms = CS.cuda_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = CS.attention_bound(B, H, K, S, S, D, True, window, "bfloat16")
        _, ops = CS.attention_work(B, H, K, S, S, D, True, window, 2)
        out["timings"][name] = dict(
            B=B, H=H, K=K, S=S, D=D, window=window, ms=ms, device_ms=device_ms,
            fma_kernel_ms=fma_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, tflops=ops / ms / 1e9)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

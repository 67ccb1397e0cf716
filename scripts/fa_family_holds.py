"""Phase 14's loss and hidden-state holds (recurrentgemma-9b at full width,
B 4, S 2048, bf16) for candidate sources of the tensor-core K5 kernel,
beside the plain bf16 path's own distance from float32.

  python3 scripts/fa_family_holds.py [A.cu B.cu ...]

Each argument is a variant of ``src/repro_torch/csrc/flash_attention_sm90.cu``,
built as ``scripts/fa_sm90_variants.py`` builds it and swapped in for the
checkout's tensor-core kernel (the FMA kernel and the rest stay the
checkout's); the checkout's own kernel is measured last as ``main``.  On
chip_smoke.py's weights (seed 0) and batch (seed 1) it prints one JSON
object: the plain bf16 and float32 losses and their difference, the plain
bf16 hidden states' distance from float32 (max |a - b| over max |b|), and
per kernel its loss, its differences from the plain bf16 and float32
losses, its hidden states' distance from both, and its tensor-core
launches.  It needs one CUDA card with ~40 GB free.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fa_family_holds: no CUDA device", file=sys.stderr)
        return 1
    for path in (HERE, os.path.join(HERE, "src"), os.path.join(HERE, "scripts")):
        sys.path.insert(0, path)
    import chip_smoke as CS
    import fa_sm90_variants as V
    from repro_torch import configs as C
    from repro_torch.core import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    checkout = _build.lib()

    class Swapped:
        """The checkout's library with another tensor-core entry point."""

        def __init__(self, fn):
            self.repro_flash_attention_sm90 = fn

        def __getattr__(self, name):
            return getattr(checkout, name)

    libs = {}
    for path in sys.argv[1:]:
        lib, _ = V.build(path, _build._nvcc(), _build.NVCC_FLAGS)
        fn = lib.repro_flash_attention_sm90
        fn.argtypes = _build._SIGNATURES["repro_flash_attention_sm90"]
        fn.restype = ctypes.c_int
        libs[os.path.basename(path)] = Swapped(fn)
    libs["main"] = checkout

    cfg = C.get_config("recurrentgemma-9b")
    model = T.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = CS.family_batch(torch, cfg, "cuda", CS.FAMILY_B, 2048, seed=1)
    kc, cfg32 = cfg.replace(attn_impl="pallas"), cfg.replace(compute_dtype="float32")
    build_lib = _build.lib
    with torch.no_grad():
        loss_plain = float(T.loss_fn(model, cfg, batch)[0])
        loss32 = float(T.loss_fn(model, cfg32, batch)[0])
        h_plain, h32 = T.forward(model, cfg, batch)[0], T.forward(model, cfg32, batch)[0]
        out = {"card": CS.nvidia_smi(), "plain_bf16_loss": loss_plain, "f32_loss": loss32,
               "plain_minus_f32": loss_plain - loss32,
               "plain_hidden_vs_f32": CS.rel(h_plain, h32), "kernels": {}}
        try:
            for name, lib in libs.items():
                _build.lib = lambda lib=lib: lib
                FA.reset_launch_counts()
                loss = float(T.loss_fn(model, kc, batch)[0])
                hidden = T.forward(model, kc, batch)[0]
                out["kernels"][name] = {
                    "loss": loss, "minus_plain": loss - loss_plain, "minus_f32": loss - loss32,
                    "hidden_vs_plain": CS.rel(hidden, h_plain),
                    "hidden_vs_f32": CS.rel(hidden, h32),
                    "wgmma_launches": FA.flash_attention.launches_wgmma}
        finally:
            _build.lib = build_lib
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

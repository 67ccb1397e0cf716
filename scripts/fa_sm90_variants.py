"""Time candidate sources of the tensor-core K5 kernel side by side on one
card, at the bf16 head-dim-256 shapes.

  python3 scripts/fa_sm90_variants.py A.cu B.cu ...

Each argument is a variant of ``src/repro_torch/csrc/flash_attention_sm90.cu``
with the same entry point (``repro_flash_attention_sm90``).  Each is built
alone with the repository's nvcc flags (ptxas's ``-v`` report kept) into
``build/variants/``, loaded beside the others, probed for the head dims it
takes (128, 256), held against the plain version at 2e-2 (causal with
windows None, 64 and 0; S = T 129 and 2048, MQA, at D 256; S = T 257, GQA,
at D 128), and then timed in turns by CUDA events (chip_smoke.py's
``cuda_ms``, 5 rounds of the variants, each round in the order given and
then reversed) at recurrentgemma-9b's local attention (B 4, H 16, K 1,
S = T 2048, D 256, window 2048) and paligemma-3b's (B 4, H 8, K 1, S = T
2048, causal), in the model's layout, at recurrentgemma-9b's with K 16 (a
KV head per query head, the same work) as a control, and at chatglm3-6b's
(B 4, H 32, K 2, S = T 2048, D 128, causal) for the head-dim-128
instantiation.  It prints one JSON line: per variant the head dims it
takes, its ptxas registers, spills and performance warnings at D 256 and
the median and range of its times, with the card's name and power limit.
It needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name: (B, H, K, S, D, window)
SHAPES = {"recurrentgemma-9b": (4, 16, 1, 2048, 256, 2048),
          "paligemma-3b": (4, 8, 1, 2048, 256, None),
          # recurrentgemma-9b's work with a KV head per query head: how much
          # of the time MQA's shared K / V tiles cost
          "recurrentgemma-9b-mha": (4, 16, 16, 2048, 256, 2048),
          # the head dim 128 instantiation, at the shape chip_smoke.py times
          "chatglm3-6b": (4, 32, 2, 2048, 128, None)}
ROUNDS = 5


def build(path: str, nvcc: str, flags) -> tuple:
    """(loaded library, ptxas report) of one variant."""
    text = open(path, "rb").read()
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    out_dir = os.path.join(HERE, "build", "variants")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"fa_sm90_{tag}.so")
    got = subprocess.run([nvcc, *flags, "-shared", "-o", lib, path],
                         capture_output=True, text=True, timeout=600)
    if got.returncode != 0:
        raise SystemExit(f"nvcc failed on {path}:\n{got.stdout}{got.stderr}")
    return ctypes.CDLL(lib), got.stdout + got.stderr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fa_sm90_variants: no CUDA device", file=sys.stderr)
        return 1
    sources = sys.argv[1:] or [os.path.join(HERE, "src", "repro_torch", "csrc",
                                            "flash_attention_sm90.cu")]
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as CS
    from repro_torch.core import _build
    from repro_torch.kernels.ref import flash_attention_ref

    entries = {}
    out = {"card": CS.nvidia_smi(), "variants": {}}
    for path in sources:
        lib, log = build(path, _build._nvcc(), _build.NVCC_FLAGS)
        fn = lib.repro_flash_attention_sm90
        fn.argtypes = _build._SIGNATURES["repro_flash_attention_sm90"]
        fn.restype = ctypes.c_int
        name = os.path.basename(path)
        entries[name] = fn
        out["variants"][name] = {"ptxas_d256": CS.sm90_instantiations(
            CS.ptxas_report(log)).get(256), "ms": {},
            "ptxas_warnings": [line.strip() for line in log.splitlines()
                               if "Performance Loss" in line]}

    def launch(fn, q, k, v, window):
        B, H, S, D = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
                 k.shape[1], S, k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *o.stride()[:3], 1, int(window is not None),
                 window or 0, D ** -0.5, torch.cuda.current_stream().cuda_stream)
        return o, err

    def call(fn, q, k, v, window):
        o, err = launch(fn, q, k, v, window)
        CS.check(err == 0, f"launch failed: cudaError {err}")
        return o

    # head dims each variant takes (an older source may refuse 256)
    takes = {}
    for name, fn in entries.items():
        for D in (128, 256):
            q = torch.zeros((1, 1, 1, D), device="cuda", dtype=torch.bfloat16)
            takes.setdefault(name, set())
            if launch(fn, q, q, q, None)[1] == 0:
                takes[name].add(D)
        out["variants"][name]["head_dims"] = sorted(takes[name])

    gen = torch.Generator(device="cuda").manual_seed(21)

    def inputs(B, H, K, S, D):
        return (torch.randn((B, S, n, D), generator=gen, device="cuda")
                .bfloat16().transpose(1, 2) for n in (H, K, K))

    for B, H, K, S, D in ((1, 4, 1, 129, 256), (2, 16, 1, 2048, 256), (1, 8, 2, 257, 128)):
        q, k, v = inputs(B, H, K, S, D)
        for window in (None, 64, 0):
            want = flash_attention_ref(q, k, v, causal=True, window=window).float()
            for name, fn in entries.items():
                if D not in takes[name]:
                    continue
                got = call(fn, q, k, v, window).float()
                err = float((got - want).abs().max())
                CS.check(bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()),
                         f"{name}: S {S} window {window}: max abs err {err}")
    for shape, (B, H, K, S, D, window) in SHAPES.items():
        q, k, v = inputs(B, H, K, S, D)
        order = [name for name in entries if D in takes[name]]
        times = {name: [] for name in order}
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                times[name].append(CS.cuda_ms(torch, lambda: call(entries[name], q, k, v,
                                                                   window)))
        for name, ts in times.items():
            out["variants"][name]["ms"][shape] = {
                "median": statistics.median(ts), "min": min(ts), "max": max(ts)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

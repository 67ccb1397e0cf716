"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles each source under ``src/repro_torch/csrc`` (the sweep
kernels K1-K4 in ``congruence.cu``, flash attention K5 in
``flash_attention.cu`` (float32 FMA) and ``flash_attention_sm90.cu``
(bf16 wgmma + TMA), RMSNorm K6 and fused residual RMSNorm K7 in
``rmsnorm.cu``, the selective scan K8 in ``selective_scan.cu``, the Mamba
mixer's fused causal conv and SiLU in ``causal_conv.cu``) into an object,
all sources at once in parallel,
and links them into one shared library with a plain C interface, loaded
with ``ctypes``.  The library is keyed by a hash of the sources and the
flags, under ``build/repro_torch/`` at the root of the checkout, so a fresh
checkout builds on its own and an edited source rebuilds.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "congruence.cu", CSRC / "flash_attention.cu",
           CSRC / "flash_attention_sm90.cu", CSRC / "rmsnorm.cu",
           CSRC / "selective_scan.cu", CSRC / "causal_conv.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: No --use_fast_math: Eq. 1 needs IEEE division and exact comparisons, the
#: FMA attention kernel uses exp2f and IEEE division, the scan's softplus
#: expf/log1pf, the conv's SiLU expf and IEEE division, as ATen's.  (The
#: wgmma attention kernel and the scan write their 2^x as ex2.approx.ftz
#: themselves.)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_stats_blocks": [_I],
    "repro_congruence": [_P, _I, _P, _I, _P, _I, _F, _I, _P],
    "repro_step_time": [_P, _I, _P, _I, _P, _I, _P],
    "repro_default_beta": [_P, _I, _P, _P, _P],
    "repro_launch_floor": [_P, _P],
    "repro_sweep_stats": [_P, _I, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P],
    # q, k, v, o; B, H, K, S, T, D; (batch, head, position) strides of
    # q, k, v, o; causal, has_window, window, scale, dtype, stream
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                              _I, _I, _I, _F, _I, _P],
    # the same, bf16 only, without the dtype code
    "repro_flash_attention_sm90": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                   _L, _I, _I, _I, _F, _P],
    # head dim -> the FMA kernel's dynamic shared memory in bytes
    "repro_flash_attention_smem_bytes": [_I],
    # ... and the tensor-core kernel's
    "repro_flash_attention_sm90_smem_bytes": [_I],
    # x, scale, out; rows, d, eps, x dtype, scale dtype, vec, stream
    "repro_rmsnorm": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # x, residual, scale, out, h; rows, d, eps, x dtype, scale dtype, vec, stream
    "repro_rmsnorm_residual": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # xi, dt, B, C, A, h0, y, hT; B, S, Din, N; (batch, time) strides of
    # xi, dt, B, C, y; dtypes of xi, dt, B, C, y; stream
    "repro_selective_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                             _I, _I, _I, _I, _I, _P],
    # x, state, w, bias, y; B, S, C; (batch, time) strides of x and state;
    # dtypes of x (and state), w, bias; stream
    "repro_causal_conv_silu": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L,
                               _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the last build did: library path, seconds, nvcc's ptxas report (kept
#: beside the library, so a cached build reports it too).
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the commands at once; raise with the output of any that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        log = report.read_text() if report.exists() else ""
        build_info.update(path=str(out), seconds=0.0, cached=True, log=log)
        return out
    nvcc = _nvcc()
    tmp_dir = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp_dir / f"{src.stem}.o" for src in SOURCES]
        t0 = time.perf_counter()
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(SOURCES, objs)])
        lib_tmp = tmp_dir / out.name
        log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib_tmp),
                      *map(str, objs)]])
        seconds = time.perf_counter() - t0
        (tmp_dir / report.name).write_text(log)
        os.replace(tmp_dir / report.name, report)
        os.replace(lib_tmp, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    build_info.update(path=str(out), seconds=seconds, cached=False, log=log)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call (under a lock;
    once it is loaded, every call returns it without the lock).  The first
    call is a ``kernels.build`` span of ``repro_torch.tracing``: whether the
    library came from the cache, and nvcc's seconds."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            with tracing.span("kernels.build") as sp:
                handle = ctypes.CDLL(str(build()))
                sp.set(cached=build_info["cached"], build_s=build_info["seconds"])
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib

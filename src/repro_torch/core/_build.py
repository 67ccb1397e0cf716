"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles ``src/repro_torch/csrc/congruence.cu`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The library is
keyed by a hash of the source and the flags, under ``build/repro_torch/``
at the root of the checkout, so a fresh checkout builds on its own and an
edited source rebuilds.  Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "congruence.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: No --use_fast_math: Eq. 1 needs IEEE division and exact comparisons.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "repro_threads_per_block": [],
    "repro_congruence": [_P, _I, _P, _I, _P, _I, _F, _I, _P],
    "repro_step_time": [_P, _I, _P, _I, _P, _I, _P],
    "repro_default_beta": [_P, _I, _P, _P, _P],
    "repro_sweep_stats": [_P, _I, _P, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the last build did: library path, seconds, nvcc's ptxas report.
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
    return BUILD_DIR / f"libcongruence_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=seconds, cached=False,
                      log=proc.stdout + proc.stderr)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib

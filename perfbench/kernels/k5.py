"""K5, flash attention (``kernels.flash_attention`` ->
``csrc/flash_attention_sm90.cu`` in bf16, ``csrc/flash_attention.cu`` in
float32): the device-trace group and the work one call needs.

``attention_work`` and ``attention_bound`` are frozen copies of the
functions of the same names in ``chip_smoke.py`` at commit 144e21b."""

import numpy as np

from perfbench import peaks

GROUP = "K5"
#: parts of a kernel name that put it in this group (both K5 kernels)
PATTERNS = ("flash_attention",)


def attention_work(B, H, K, S, T, D, causal, window, itemsize):
    """(bytes, operations) one attention call needs: q, k, v read once and
    the output written once; 4 D operations (two multiply-adds) for each
    live (query, key) pair of this mask."""
    i = np.arange(S)
    hi = np.minimum(T, i + 1) if causal else np.full(S, T)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(S, int)
    pairs = int(np.maximum(hi - lo, 0).sum())
    nbytes = (2 * B * H * S * D + 2 * B * K * T * D) * itemsize
    return nbytes, 4 * D * pairs * B * H


def attention_bound(B, H, K, S, T, D, causal, window, dtype_name):
    """(ms, "bytes" or "operations"): the least time of one call."""
    nbytes, ops = attention_work(B, H, K, S, T, D, causal, window,
                                 2 if dtype_name == "bfloat16" else 4)
    peak = peaks.BF16_OPS_PER_S if dtype_name == "bfloat16" else peaks.F32_OPS_PER_S
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

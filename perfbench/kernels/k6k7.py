"""K6 / K7, RMSNorm and fused residual RMSNorm (``kernels.rmsnorm`` ->
``csrc/rmsnorm.cu``): the device-trace group and the work one call needs.

``rms_bound`` is a frozen copy of ``chip_smoke.py``'s at commit 144e21b."""

from perfbench import peaks

GROUP = "K6/K7"
PATTERNS = ("rmsnorm_k",)


def rms_bound(rows, d, x_bytes, scale_bytes, residual):
    """K6: x read, out written; K7: x and r read, out and h written.  About
    5 f32 operations an element (K7 one more, the add).  -> ((ms, "bytes"
    or "operations"), bytes)."""
    n = rows * d
    nbytes = n * x_bytes * (4 if residual else 2) + d * scale_bytes
    ops = n * (6 if residual else 5)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    t_ops = ops / peaks.F32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), nbytes

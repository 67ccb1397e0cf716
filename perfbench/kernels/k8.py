"""K8, the Mamba-1 selective scan (``kernels.selective_scan`` ->
``csrc/selective_scan.cu``): the device-trace group and the work one call
needs.

``scan_work`` and ``scan_bound`` are frozen copies of ``chip_smoke.py``'s
at commit 144e21b."""

from perfbench import peaks

GROUP = "K8"
PATTERNS = ("selective_scan_k",)


def scan_work(B, S, Din, N, in_bytes, dt_bytes, y_bytes, with_h0):
    """(bytes, f32 operations, special-function operations) of one scan:
    xi, dt_raw, B, C, A (and h0) read once, y and hT written once; per
    (b, t, d, n) 7 f32 operations (dt*A, exp, the two multiply-adds of the
    update, dt*x*B, h*C and its sum) and one exp; per (b, t, d) softplus
    (6 operations, an exp and a log1p) and dt*x."""
    nbytes = (B * S * Din * (in_bytes + dt_bytes + y_bytes)
              + 2 * B * S * N * in_bytes + Din * N * 4
              + B * Din * N * 4 * (2 if with_h0 else 1))
    ops = B * S * Din * (7 * N + 7)
    sfu = B * S * Din * (N + 2)
    return nbytes, ops, sfu


def scan_bound(B, S, Din, N, in_bytes, dt_bytes, y_bytes, with_h0):
    """(ms, "bytes" or "operations"): the least time of one scan."""
    nbytes, ops, sfu = scan_work(B, S, Din, N, in_bytes, dt_bytes, y_bytes, with_h0)
    t_bytes = nbytes / peaks.HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / peaks.F32_OPS_PER_S, sfu / peaks.SFU_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), the yardstick of
every roofline and utilisation share the benchmark reports.

Frozen copies of ``chip_smoke.py``'s constants at commit 144e21b."""

#: HBM3 bandwidth, bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores, operations a second.
F32_OPS_PER_S = 67e12
#: dense bf16 on the tensor cores, operations a second.
BF16_OPS_PER_S = 989e12
#: exp / log on the special-function units: 16 per SM per clock on sm_90
#: (CUDA C++ Programming Guide, arithmetic instruction throughput), 132 SMs,
#: 1.98 GHz boost clock.  An assumption, stated beside the data sheet's.
SFU_OPS_PER_S = 132 * 16 * 1.98e9

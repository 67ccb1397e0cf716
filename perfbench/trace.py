"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (device
activity only: recording every host operation too slowed the host's
enqueue by up to a fifth) around whole requests, reduced to device
intervals by group and the idle gaps between them.

The grouping is ``chip_smoke.py``'s ``device_split`` rule (commit
144e21b): the port's kernels first, by the patterns of
``perfbench/kernels/*.py``, then the matmuls, then memcpy / memset
("copy"), and everything else "other".  One stream, so device intervals
do not overlap; they are merged all the same before busy time is summed."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

MATMUL_PATTERNS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
COPY_PATTERNS = ("memcpy", "memset")
#: what the host was doing in an idle gap, named by the device operation
#: that ends it: a request's token draw (the host was between requests),
#: the copy of its next-token ids to the host (the sync), or else the
#: prefill's own launches
GAP_BEFORE = (("random", "between requests"), ("memcpy dtoh", "sync"))


def group_of(name: str, kernels: Sequence) -> str:
    low = name.lower()
    for k in kernels:
        if any(p in low for p in k.PATTERNS):
            return k.GROUP
    if any(p in low for p in MATMUL_PATTERNS):
        return "matmul"
    if any(p in low for p in COPY_PATTERNS):
        return "copy"
    return "other"


@dataclasses.dataclass
class DeviceOp:
    name: str
    group: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Slice:
    """What the readers read: the traced requests, their device operations,
    the wall seconds of the slice on the host's clock, and the run's other
    facts (``enqueue_ms_outside``: host enqueue ms of the window's requests
    outside the slice)."""
    ops: List[DeviceOp]
    wall_s: float
    requests: List[Tuple[int, int]]
    enqueue_ms_outside: List[float]
    config: dict
    reference: object
    kernels: Sequence

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for op in sorted(self.ops, key=lambda o: o.start_us):
            if merged and op.start_us <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], op.end_us)
            else:
                merged.append([op.start_us, op.end_us])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def ms_by_group(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for op in self.ops:
            out[op.group] = out.get(op.group, 0.0) + op.us / 1e3
        return out

    def kernel(self, group: str):
        return next((k for k in self.kernels if k.GROUP == group), None)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each gap between device operations, in seconds, named by
        ``GAP_BEFORE`` from the operation that ends it."""
        gaps, end = [], None
        for op in sorted(self.ops, key=lambda o: o.start_us):
            if end is not None and op.start_us > end:
                low = op.name.lower()
                name = next((n for p, n in GAP_BEFORE if p in low), "prefill")
                gaps.append((name, (op.start_us - end) / 1e6))
            end = op.end_us if end is None else max(end, op.end_us)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            key = f"{op.group}: {op.name[:96]}"
            by_name[key] = by_name.get(key, 0.0) + op.us / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def from_profiler(prof, kernels) -> List[DeviceOp]:
    """The device operations of a finished ``torch.profiler.profile``, on
    the profiler's clock in us."""
    from torch.autograd import DeviceType

    return [DeviceOp(e.name, group_of(e.name, kernels), float(e.time_range.start),
                     float(e.time_range.end))
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def read_metrics(slc: Slice, per_layer: List[dict], readers: dict) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something for, by name; a
    reader that returns None leaves its metric out."""
    out = {}
    for m in per_layer:
        value: Optional[float] = readers[m["name"]].read(slc)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

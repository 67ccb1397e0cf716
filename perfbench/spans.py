"""The port's own spans (``repro_torch.tracing``) against the device trace,
on one clock: device time by program span, and idle time by what the host
was doing.

Three inputs, all in Unix-epoch nanoseconds:

- the host spans the recorder kept (``host_spans``: its
  ``time.perf_counter_ns()`` times moved by its ``clock_offset_ns``);
- the device operations of a CUDA-only ``torch.profiler`` trace, each with
  its CUPTI correlation id (``from_kineto``);
- the CUDA runtime and driver calls of the same trace (``cudaLaunchKernel``,
  ``cuLaunchKernelEx``, ``cudaMemcpyAsync``, ``cudaStreamSynchronize``,
  ...): a call and the device operation it launched share a correlation id.

``attribute`` puts each device operation down to the innermost span open
when its launch call started, or to "outside the program" (the harness's
token draw, cache reset and argmax), or leaves it unmatched when the trace
holds no call with its id.  Each idle interval of the device, from the
slice's start to its end, is split by the innermost host span open during
it, up to the launch of the operation that ends it; the rest of the
interval, the launch's own latency, goes to the span that launched it.

``SpanSlice`` is ``trace.Slice`` with these inputs beside it, which the
readers ``metrics/attn_device_ms.py`` etc. read; a slice without them
(every run of ``run.py`` today) reads None.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> [--recorder 0|1]

runs ``run.py``'s traced run of a cell with the recorder on (from the
start of set-up) or off, and prints, as the last line, the run's result
object with a ``spans`` entry: device and idle ms a request by span, the
partition's sums, the counters of each traced request, the set-up's spans
and the slice's wall seconds.  On the card only, as ``run.py``."""

from __future__ import annotations

import bisect
import dataclasses
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __package__ in (None, ""):
    # run as a script: the script's own folder would shadow standard
    # modules (trace, ...), and the checkout's root holds ``perfbench``
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _ROOT / "perfbench"]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from perfbench import trace as tr  # noqa: E402

#: the name under which device and idle time outside every span is kept
OUTSIDE = "outside the program"


@dataclasses.dataclass
class Event:
    """A device operation or a host runtime / driver call, epoch ns."""
    name: str
    start_ns: int
    end_ns: int
    corr: int


@dataclasses.dataclass
class HostSpan:
    """One span of the recorder, epoch ns."""
    id: int
    parent: Optional[int]
    request: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict
    counts: Optional[Dict[str, int]] = None


def host_spans(records, clock_offset_ns: int) -> List[HostSpan]:
    """``repro_torch.tracing.SpanRecord`` s on the profiler's clock."""
    return [HostSpan(r.id, r.parent, r.request, r.name, r.start_ns + clock_offset_ns,
                     r.end_ns + clock_offset_ns, dict(r.attrs),
                     dict(r.counts) if r.counts is not None else None)
            for r in records]


def from_kineto(prof) -> Tuple[List[Event], List[Event]]:
    """-> (device operations, runtime and driver calls) of a finished
    ``torch.profiler.profile``.  Host events whose names do not begin with
    ``cu`` (the profiler's own "Activity Buffer Request", which shares
    its launch's id) are left out."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        ev = Event(e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            ops.append(ev)
        elif ev.name.startswith("cu"):
            calls.append(ev)
    return ops, calls


@dataclasses.dataclass
class SpanSlice(tr.Slice):
    """``trace.Slice`` and what the span readers read: the host spans, the
    device operations with their correlation ids, the runtime calls, and
    the slice's window (epoch ns)."""
    spans: List[HostSpan] = dataclasses.field(default_factory=list)
    device: List[Event] = dataclasses.field(default_factory=list)
    calls: List[Event] = dataclasses.field(default_factory=list)
    window_ns: Optional[Tuple[int, int]] = None


def slice_window(ops: Sequence[Event], calls: Sequence[Event],
                 wall_s: float) -> Tuple[int, int]:
    """The slice's window on the profiler's clock: it ends when the call
    that waited for the last device operation returned (the request's
    sync), and is ``wall_s`` long."""
    last = max(o.end_ns for o in ops)
    end = max([c.end_ns for c in calls if c.start_ns <= last] + [last])
    return end - round(wall_s * 1e9), end


class Timeline:
    """The innermost open span at each instant: segments ``(start, end,
    span or None)`` covering ``[t0, t1)``."""

    def __init__(self, spans: Sequence[HostSpan], t0: int, t1: int):
        depth: Dict[int, int] = {}
        by_id = {s.id: s for s in spans}

        def depth_of(s):
            if s.id not in depth:
                p = by_id.get(s.parent)
                depth[s.id] = 0 if p is None else depth_of(p) + 1
            return depth[s.id]

        events = []
        for s in spans:
            d = depth_of(s)
            events.append((s.start_ns, 1, d, s))
            events.append((s.end_ns, 0, -d, s))
        events.sort(key=lambda e: e[:3])
        self.starts: List[int] = []
        self.segs: List[Tuple[int, int, Optional[HostSpan]]] = []
        stack: List[HostSpan] = []
        t = t0
        for when, kind, _, s in events:
            when = min(max(when, t0), t1)
            if when > t:
                self._add(t, when, stack[-1] if stack else None)
                t = when
            if kind:
                stack.append(s)
            else:
                stack.remove(s)
        if t1 > t:
            self._add(t, t1, stack[-1] if stack else None)

    def _add(self, a, b, s):
        if self.segs and self.segs[-1][2] is s and self.segs[-1][1] == a:
            self.segs[-1] = (self.segs[-1][0], b, s)
            self.starts[-1] = self.segs[-1][0]
        else:
            self.segs.append((a, b, s))
            self.starts.append(a)

    def at(self, t: int) -> Optional[HostSpan]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t >= self.segs[i][1]:
            return None
        return self.segs[i][2]

    def split(self, a: int, b: int):
        """-> [(span or None, ns)] of the interval ``[a, b)``."""
        out = []
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        while i < len(self.segs) and self.segs[i][0] < b:
            lo, hi = max(a, self.segs[i][0]), min(b, self.segs[i][1])
            if hi > lo:
                out.append((self.segs[i][2], hi - lo))
            i += 1
        covered = sum(ns for _, ns in out)
        if covered < b - a:          # outside the timeline's own range
            out.append((None, b - a - covered))
        return out


def _union_ns(intervals: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


@dataclasses.dataclass
class Attribution:
    """A slice's time by span, in ns.  ``*_self`` by the innermost span's
    name, ``*_inside`` by every name on the span's chain (an ``attn`` span
    inside a ``block`` inside ``prefill`` counts under all three);
    ``OUTSIDE`` holds what no span covers.  ``host_self_ns`` is each
    ``prefill`` span's wall less its runtime and driver calls,
    ``host_self`` the same by innermost span, and ``host_longest`` the
    longest stretches of it (ns, span, the calls before and after);
    ``host_calls`` counts each ``prefill`` span's runtime and driver calls."""
    requests: int
    busy_ns: int
    idle_ns: int
    unmatched_ns: int
    device_self: Dict[str, int]
    device_inside: Dict[str, int]
    idle_self: Dict[str, int]
    idle_inside: Dict[str, int]
    host_self_ns: List[int]
    host_self: Dict[str, int]
    host_longest: List[tuple]
    host_calls: List[int]
    counts: List[Dict[str, int]]
    names: frozenset

    def per_request_ms(self, table: Dict[str, int], name: str) -> Optional[float]:
        """``table[name]`` in ms a request; None when no span of that name
        was traced."""
        if not self.requests or name not in self.names:
            return None
        return table.get(name, 0) / 1e6 / self.requests


def attribute(spans: Sequence[HostSpan], ops: Sequence[Event], calls: Sequence[Event],
              window: Tuple[int, int]) -> Attribution:
    """The attribution (module docstring) of the requests whose ``prefill``
    span lies inside ``window``, and of the device's time in it."""
    t0, t1 = window
    roots = [s for s in spans if s.parent is None and s.name == "prefill"
             and t0 <= s.start_ns and s.end_ns <= t1]
    keep = {s.request for s in roots}
    inside = [s for s in spans if s.request in keep]
    by_id = {s.id: s for s in inside}
    chains: Dict[int, Tuple[str, ...]] = {}

    def chain(s):
        if s.id not in chains:
            p = by_id.get(s.parent)
            names = (s.name,) + (chain(p) if p is not None else ())
            chains[s.id] = tuple(dict.fromkeys(names))
        return chains[s.id]

    timeline = Timeline(inside, t0, t1)
    launch: Dict[int, Event] = {}
    for c in calls:
        if c.corr and (c.corr not in launch or c.start_ns < launch[c.corr].start_ns):
            launch[c.corr] = c

    dev_self: Dict[str, int] = {}
    dev_in: Dict[str, int] = {}
    idle_self: Dict[str, int] = {}
    idle_in: Dict[str, int] = {}

    def put(self_t, in_t, s, ns):
        if s is None:
            self_t[OUTSIDE] = self_t.get(OUTSIDE, 0) + ns
            in_t[OUTSIDE] = in_t.get(OUTSIDE, 0) + ns
            return
        self_t[s.name] = self_t.get(s.name, 0) + ns
        for name in chain(s):
            in_t[name] = in_t.get(name, 0) + ns

    unmatched = 0
    ops = sorted((o for o in ops if o.end_ns > t0 and o.start_ns < t1),
                 key=lambda o: o.start_ns)
    for o in ops:
        c = launch.get(o.corr)
        if c is None:
            unmatched += o.end_ns - o.start_ns
        else:
            put(dev_self, dev_in, timeline.at(c.start_ns), o.end_ns - o.start_ns)

    busy, end = [], t0
    idle_total = 0
    for o in ops + [None]:
        g1 = t1 if o is None else max(o.start_ns, t0)
        if g1 > end:
            c = launch.get(o.corr) if o is not None else None
            cut = min(max(c.start_ns, end), g1) if c is not None else g1
            for s, ns in timeline.split(end, cut):
                put(idle_self, idle_in, s, ns)
            if g1 > cut:
                put(idle_self, idle_in, timeline.at(c.start_ns), g1 - cut)
            idle_total += g1 - end
        if o is not None:
            busy.append((max(o.start_ns, t0), min(o.end_ns, t1)))
            end = max(end, min(o.end_ns, t1))

    # the host's own work: each prefill span's stretches between runtime calls
    host_self, host_by, stretches, n_calls = [], {}, [], []
    sorted_calls = sorted(calls, key=lambda c: c.start_ns)
    call_starts = [c.start_ns for c in sorted_calls]
    for r in roots:
        # from the call before the span, in case it runs across the span's start
        lo = max(bisect.bisect_left(call_starts, r.start_ns) - 1, 0)
        hi = bisect.bisect_left(call_starts, r.end_ns)
        t, before, own = r.start_ns, None, 0
        within = [c for c in sorted_calls[lo:hi] if c.end_ns > r.start_ns]
        n_calls.append(len(within))
        for c in within + [None]:
            b = r.end_ns if c is None else min(max(c.start_ns, t), r.end_ns)
            if b > t:
                for sp, ns in timeline.split(t, b):
                    name = sp.name if sp is not None else OUTSIDE
                    host_by[name] = host_by.get(name, 0) + ns
                stretches.append((b - t, timeline.at(t), before, c))
                own += b - t
            if c is not None:
                t, before = max(t, min(c.end_ns, r.end_ns)), c
        host_self.append(own)
    stretches.sort(key=lambda g: -g[0])
    longest = [(ns, sp.name if sp is not None else OUTSIDE, b.name if b else None,
                c.name if c else None) for ns, sp, b, c in stretches[:8]]

    return Attribution(len(roots), _union_ns(busy), idle_total, unmatched, dev_self, dev_in,
                       idle_self, idle_in, host_self, host_by, longest, n_calls,
                       [r.counts for r in roots if r.counts is not None],
                       frozenset(s.name for s in inside))


def attribution(slc) -> Optional[Attribution]:
    """The slice's attribution (computed once a slice), or None for a
    slice without spans, device events or a window."""
    if not getattr(slc, "spans", None) or not getattr(slc, "device", None) \
            or getattr(slc, "window_ns", None) is None:
        return None
    got = slc.__dict__.get("_attribution")
    if got is None:
        got = slc.__dict__["_attribution"] = attribute(slc.spans, slc.device, slc.calls,
                                                       slc.window_ns)
    return got if got.requests else None


# --------------------------------------------------------------------------- #
# the traced run with the recorder
# --------------------------------------------------------------------------- #


#: the readers of this file's metrics, under ``perfbench/metrics/``
READERS = ("attn_device_ms", "mlp_device_ms", "mixer_device_ms", "prefill_idle_ms",
           "prefill_host_self_ms", "attn_k5_share")


def report(slc: SpanSlice, att: Attribution) -> dict:
    """The ``spans`` entry of the tool's result: ms a request by span, the
    partition's sums against the slice, the counters and the readers."""
    from perfbench import spec

    n = att.requests

    def ms(table):
        return {k: v / 1e6 / n for k, v in sorted(table.items(), key=lambda kv: -kv[1])}

    dev_sum = sum(att.device_self.values())
    idle_sum = sum(att.idle_self.values())
    readers = {}
    for name in READERS:
        mod = spec.load_module(Path(__file__).parent / "metrics" / f"{name}.py",
                               f"perfbench_metric_{name}")
        readers[name] = mod.read(slc)
    return {
        "requests": n, "slice_requests": len(slc.requests),
        "busy_ms": att.busy_ns / 1e6 / n, "idle_ms": att.idle_ns / 1e6 / n,
        "wall_ms": slc.wall_s * 1e3 / n,
        "matched_busy_share": dev_sum / max(dev_sum + att.unmatched_ns, 1),
        "device_sum_over_busy": (dev_sum + att.unmatched_ns) / max(att.busy_ns, 1),
        "idle_sum_over_idle": idle_sum / max(att.idle_ns, 1),
        "device_ms_self": ms(att.device_self), "device_ms_inside": ms(att.device_inside),
        "idle_ms_self": ms(att.idle_self), "idle_ms_inside": ms(att.idle_inside),
        "host_self_ms": [v / 1e6 for v in att.host_self_ns],
        "host_self_ms_by_span": ms(att.host_self),
        "host_longest_ms": [[ns / 1e6, *rest] for ns, *rest in att.host_longest],
        "host_calls": att.host_calls,
        "counts": att.counts, "readers": readers,
    }


def traced_run(cell, seed: int, seconds: float, recorder: bool, device: str = "cuda:0",
               t_setup: float = None) -> dict:
    """``run.run`` with ``trace`` on, the recorder on from set-up when
    ``recorder``, and the profiler's events kept: -> its result with a
    ``spans`` entry (None with the recorder off)."""
    from perfbench import run as run_mod
    from repro_torch import tracing

    kept = {}
    from_profiler = tr.from_profiler

    def keep(prof, kernels):
        kept["events"] = from_kineto(prof)
        return from_profiler(prof, kernels)

    tr.from_profiler = keep
    rec = tracing.enable() if recorder else None
    try:
        result = run_mod.run(cell, seed, seconds, True, device, t_setup=t_setup)
    finally:
        tracing.disable()
        tr.from_profiler = from_profiler
    result["spans"] = None
    if rec is None:
        return result
    ops, calls = kept["events"]
    spans = host_spans(rec.records, rec.clock_offset_ns)
    mix = cell.traffic["trace_slice"]
    from perfbench.traffic import Traffic

    traffic = Traffic(cell.traffic, seed, cell.reference.sizes(cell.config)["vocab"])
    lo, hi = mix["skip"], mix["skip"] + mix["requests"]
    wall_s = result["device"]["window_s"]
    slc = SpanSlice(ops=[], wall_s=wall_s, requests=[traffic.shape(i) for i in range(lo, hi)],
                    enqueue_ms_outside=[], config=cell.config, reference=cell.reference,
                    kernels=cell.kernels, spans=spans, device=ops, calls=calls,
                    window_ns=slice_window(ops, calls, wall_s) if ops else None)
    att = attribution(slc)
    out = report(slc, att) if att is not None else {"requests": 0}
    warm = [s for s in spans if s.parent is None and s.name == "prefill"][:len(traffic.shapes())]
    out["setup"] = {
        "build": [dict(s.attrs, ms=(s.end_ns - s.start_ns) / 1e6)
                  for s in spans if s.name == "kernels.build"],
        "warm_up_prefill_ms": [(s.end_ns - s.start_ns) / 1e6 for s in warm]}
    result["spans"] = out
    return result


def main(argv=None) -> int:
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from perfbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.ones(1, device="cuda:0")
    torch.cuda.synchronize()
    result = traced_run(cell, args.seed, args.seconds, bool(args.recorder),
                        t_setup=time.perf_counter())
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

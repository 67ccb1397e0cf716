"""CPU tests of ``perfbench/spans.py`` and the readers of the port's spans,
on synthetic slices: host spans, device operations and runtime calls with
correlation ids, every time in ns as the profiler gives them.

    PYTHONPATH=src python -m pytest -q perfbench/tests"""

from __future__ import annotations

import pytest

from perfbench import spans, spec, trace as tr
from perfbench.spans import OUTSIDE, Event, HostSpan, SpanSlice
from perfbench.tests.smoke_tree import cells, smoke_tree

CELLS = cells()
US = 1000     # the synthetic slice's unit, 1 us in ns


def _span(id, parent, name, a, b, counts=None):
    return HostSpan(id, parent, 1, name, a * US, b * US, {}, counts)


#: one request: a prefill span [100, 1000] with embed, block 0 (attn, mlp)
#: and unembed inside; the harness's token draw before it and its argmax
#: and sync after it
SPANS = [_span(1, None, "prefill", 100, 1000, {"attn.k5": 0, "attn.plain": 1}),
         _span(2, 1, "embed", 110, 150), _span(3, 1, "block", 200, 600),
         _span(4, 3, "attn", 210, 400), _span(5, 3, "mlp", 420, 580),
         _span(6, 1, "unembed", 900, 950)]
CALLS = [Event("cudaLaunchKernel", 50 * US, 55 * US, 1),       # token draw, outside
         Event("cudaLaunchKernel", 120 * US, 125 * US, 2),     # embed
         Event("cuLaunchKernelEx", 220 * US, 230 * US, 3),     # attn
         Event("cudaLaunchKernel", 300 * US, 310 * US, 4),     # attn
         Event("cudaLaunchKernel", 430 * US, 440 * US, 5),     # mlp
         Event("cudaLaunchKernel", 910 * US, 915 * US, 6),     # unembed
         Event("cudaMemcpyAsync", 1010 * US, 1100 * US, 7)]    # the argmax's copy, outside
OPS = [Event("distribution_random", 60 * US, 80 * US, 1),
       Event("embedding", 130 * US, 160 * US, 2), Event("nvjet_qkv", 240 * US, 380 * US, 3),
       Event("softmax", 380 * US, 500 * US, 4), Event("nvjet_mlp", 500 * US, 700 * US, 5),
       Event("nvjet_unembed", 920 * US, 940 * US, 6),
       Event("Memcpy DtoH (Device -> Pageable)", 1050 * US, 1060 * US, 7),
       Event("no launch in the trace", 1070 * US, 1075 * US, 99)]
WINDOW = (40 * US, 1100 * US)


def _slice(cell="qwen1.5-4b.prefill_chat", spans_=SPANS, ops=OPS, calls=CALLS, window=WINDOW):
    c = spec.load_cell(cell)
    return SpanSlice(ops=[], wall_s=(window[1] - window[0]) / 1e9, requests=[(8, 512)],
                     enqueue_ms_outside=[], config=c.config, reference=c.reference,
                     kernels=c.kernels, spans=list(spans_), device=list(ops),
                     calls=list(calls), window_ns=window)


def _ms(us):
    return pytest.approx(us * US / 1e6)


def test_each_operation_goes_to_the_innermost_span_of_its_launch():
    att = spans.attribution(_slice())
    assert att.requests == 1
    assert att.device_self == {OUTSIDE: 30 * US, "embed": 30 * US, "attn": 260 * US,
                               "mlp": 200 * US, "unembed": 20 * US}
    assert att.device_inside["block"] == 460 * US and att.device_inside["prefill"] == 510 * US
    assert att.unmatched_ns == 5 * US and att.busy_ns == 545 * US
    assert sum(att.device_self.values()) + att.unmatched_ns == att.busy_ns


def test_an_idle_gap_is_split_between_host_spans_and_outside_the_program():
    """Up to the launch of the operation that ends a gap, by the span the
    host was in; from the launch on, to the launching span."""
    att = spans.attribution(_slice())
    assert att.idle_self == {OUTSIDE: 125 * US, "prefill": 300 * US, "embed": 20 * US,
                             "block": 10 * US, "attn": 30 * US, "unembed": 30 * US}
    assert att.idle_inside["prefill"] == 390 * US
    assert att.idle_ns == 1060 * US - att.busy_ns == sum(att.idle_self.values())


def test_host_self_time_leaves_out_the_runtime_calls():
    att = spans.attribution(_slice())
    assert att.host_self_ns == [(900 - 40) * US]


def test_each_new_metric_equals_a_count_by_hand():
    slc = _slice()
    readers = {n: spec.load_module(spec.ROOT / "perfbench" / "metrics" / f"{n}.py", n)
               for n in spans.READERS}
    got = {n: r.read(slc) for n, r in readers.items()}
    assert got == {"attn_device_ms": _ms(260), "mlp_device_ms": _ms(200),
                   "mixer_device_ms": None, "prefill_idle_ms": _ms(390),
                   "prefill_host_self_ms": _ms(860), "attn_k5_share": 0.0}


@pytest.mark.parametrize("name", CELLS)
def test_the_readers_read_none_without_spans(name):
    readers = [spec.load_module(spec.ROOT / "perfbench" / "metrics" / f"{n}.py", n)
               for n in spans.READERS]
    c = spec.load_cell(name)
    plain = tr.Slice(ops=[tr.DeviceOp("k", "other", 0, 5)], wall_s=1e-5, requests=[(1, 8)],
                     enqueue_ms_outside=[], config=c.config, reference=c.reference,
                     kernels=c.kernels)
    no_spans = _slice(name, spans_=[])
    outside_window = _slice(name, window=(2000 * US, 3000 * US))
    for slc in (plain, no_spans, outside_window):
        assert [r.read(slc) for r in readers] == [None] * len(readers)


def test_a_mixer_slice_reads_the_mixer_and_no_attention():
    mixer = [_span(1, None, "prefill", 100, 1000, {"selective_scan": 1}),
             _span(3, 1, "block", 200, 600), _span(4, 3, "mixer", 210, 580),
             _span(5, 4, "scan", 290, 320)]
    att = spans.attribution(_slice("falcon-mamba-7b.prefill_8k", spans_=mixer))
    assert att.device_self["mixer"] == 460 * US - 120 * US
    assert att.device_self["scan"] == att.device_inside["scan"] == 120 * US
    assert att.device_inside["mixer"] == 460 * US
    for name, want in (("mixer_device_ms", _ms(460)), ("attn_device_ms", None),
                       ("mlp_device_ms", None), ("attn_k5_share", None)):
        mod = spec.load_module(spec.ROOT / "perfbench" / "metrics" / f"{name}.py", name)
        assert mod.read(_slice("falcon-mamba-7b.prefill_8k", spans_=mixer)) == want


def test_the_window_ends_with_the_last_requests_sync():
    assert spans.slice_window(OPS, CALLS, 1.06e-3) == (40 * US, 1100 * US)
    late = CALLS + [Event("cudaDeviceSynchronize", 1200 * US, 1210 * US, 8)]
    assert spans.slice_window(OPS, late, 1.06e-3) == (40 * US, 1100 * US)


def test_host_spans_move_onto_the_profilers_clock():
    from repro_torch import tracing

    rec = tracing.enable()
    try:
        with tracing.span("prefill", B=1, S=8):
            pass
    finally:
        tracing.disable()
    s, = spans.host_spans(rec.records, rec.clock_offset_ns)
    r, = rec.records
    assert (s.name, s.parent, s.attrs) == ("prefill", None, {"B": 1, "S": 8})
    assert s.start_ns == r.start_ns + rec.clock_offset_ns


def test_the_traced_run_with_the_recorder_on_the_cpu(tmp_path):
    """The tool's run of a cell on the CPU: the recorder is on through
    set-up and the window, off after; the CPU trace has no device
    operations, so nothing is attributed."""
    from repro_torch import tracing

    cell = spec.load_cell("falcon-mamba-7b.prefill_8k", smoke_tree(tmp_path))
    result = spans.traced_run(cell, 2 ** 31 + 5, 0.1, True, "cpu")
    assert result["correct"] and tracing.disable() is None
    assert result["spans"]["requests"] == 0
    assert len(result["spans"]["setup"]["warm_up_prefill_ms"]) == 1
    assert spans.traced_run(cell, 2 ** 31 + 5, 0.1, False, "cpu")["spans"] is None
    assert tr.from_profiler.__name__ == "from_profiler"


def test_the_hosts_own_work_by_span():
    att = spans.attribution(_slice())
    assert att.host_self == {"prefill": (10 + 50 + 300 + 50) * US, "embed": 35 * US,
                             "block": 50 * US, "attn": 170 * US, "mlp": 150 * US,
                             "unembed": 45 * US}
    assert sum(att.host_self.values()) == att.host_self_ns[0] and att.host_calls == [5]
    assert att.host_longest[0] == (470 * US, "mlp", "cudaLaunchKernel", "cudaLaunchKernel")

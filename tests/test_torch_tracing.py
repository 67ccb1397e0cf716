"""The port's span and counter recorder (``repro_torch.tracing``) on the
CPU, at the smoke configs: off records nothing; on, a ``prefill`` is one
tree of spans (embedding, a block a layer with its layers inside, final
norm, unembedding) with the counters' deltas on its root; and the spans'
clock lines up with ``torch.profiler``'s."""

from __future__ import annotations

import ctypes
import time
from types import SimpleNamespace

import pytest
import torch

from repro_torch import kernels, tracing
from repro_torch.configs import get_config
from repro_torch.models import transformer as T


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    yield
    tracing.disable()


def _prefill(arch, attn_impl=None, B=2, S=8):
    cfg = get_config(arch, smoke=True)
    if attn_impl is not None:
        cfg = cfg.replace(attn_impl=attn_impl)
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    cache = T.init_cache(cfg, B, S, device="cpu")
    return cfg, lambda: T.prefill(model, cfg, {"tokens": tokens}, cache)


def test_off_records_nothing_and_costs_one_shared_object():
    _, run = _prefill("qwen1.5-4b")
    assert tracing.disable() is None
    assert tracing.span("attn") is tracing.span("block", index=3)
    rec = tracing.enable()
    tracing.disable()
    run()
    assert rec.records == [] and tracing.records() == []
    with tracing.span("x", counts=True) as sp:
        sp.set(a=1)
    assert tracing.records() == []


def _tree(records):
    roots = [r for r in records if r.parent is None]
    assert len(roots) == 1 and roots[0].name == "prefill"
    root = roots[0]
    by_id = {r.id: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        assert r.request == root.request
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    children = {}
    for r in records:
        children.setdefault(r.parent, []).append(r)
    return root, by_id, children


@pytest.mark.parametrize("arch,attn_impl,inner", [
    ("qwen1.5-4b", None, ["attn", "mlp"]),
    ("qwen1.5-4b", "pallas", ["attn", "mlp"]),
    ("chatglm3-6b", "pallas", ["attn", "mlp"]),
    ("falcon-mamba-7b", None, ["mixer"]),
    ("falcon-mamba-7b", "pallas", ["mixer"]),
])
def test_a_prefill_is_one_tree_with_a_block_a_layer(arch, attn_impl, inner):
    cfg, run = _prefill(arch, attn_impl)
    rec = tracing.enable()
    run()
    tracing.disable()
    root, by_id, children = _tree(rec.records)
    assert root.attrs == {"B": 2, "S": 8}
    top = sorted(children[root.id], key=lambda r: r.start_ns)
    blocks = [r for r in top if r.name == "block"]
    assert [b.attrs["index"] for b in blocks] == list(range(cfg.n_layers))
    assert top[0].name == "embed" and top[-1].name == "unembed"
    # the SSM's kernel path applies the final norm in the last block's K7
    kernel_norms = cfg.family.name == "SSM" and cfg.attn_impl == "pallas"
    assert ("final_norm" in [r.name for r in top]) != kernel_norms
    for b in blocks:
        assert sorted(r.name for r in children[b.id]) == sorted(inner)
    # the rotation of q and k nests in its attention call as the conv and
    # the scan in their mixer
    nested = {"mixer": ["conv", "scan"], "attn": ["rope"]}
    for r in rec.records:
        if r.name in nested:
            assert [c.name for c in children[r.id]] == nested[r.name]
    assert len(rec.records) == len(top) + 1 + len(blocks) * len(inner) \
        + sum(len(nested.get(r.name, ())) for r in rec.records)


def test_the_route_counter_counts_one_attention_call_a_layer():
    cfg, run = _prefill("qwen1.5-4b")
    before = tracing.counters()
    rec = tracing.enable()
    run()
    tracing.disable()
    root = next(r for r in rec.records if r.parent is None)
    assert root.counts["attn.plain"] == cfg.n_layers
    assert root.counts.get("attn.k5", 0) == 0
    assert tracing.counters()["attn.plain"] - before.get("attn.plain", 0) == cfg.n_layers
    # the CPU takes the kernels' plain versions: nothing launched
    assert all(root.counts[k] == 0 for k in kernels.launch_counts())


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_the_conv_counter_counts_one_plain_conv_a_mixer_on_the_cpu(attn_impl):
    """On the CPU every mixer's conv is plain, on either route: ``"pallas"``
    hands it to the fused kernel's wrapper, which takes the plain version
    there and launches nothing."""
    cfg, run = _prefill("falcon-mamba-7b", attn_impl)
    rec = tracing.enable()
    run()
    tracing.disable()
    root = next(r for r in rec.records if r.parent is None)
    assert root.counts["conv.plain"] == cfg.n_layers
    assert root.counts.get("conv.fused", 0) == 0 and root.counts["causal_conv"] == 0
    assert sum(r.name == "conv" for r in rec.records) == cfg.n_layers


@pytest.mark.parametrize("arch,style", [("qwen1.5-4b", "full"), ("chatglm3-6b", "half")])
def test_the_rope_counter_counts_one_rotation_a_layer_by_style(arch, style):
    cfg, run = _prefill(arch, "pallas")
    assert cfg.rope_style == style
    rec = tracing.enable()
    run()
    tracing.disable()
    root = next(r for r in rec.records if r.parent is None)
    assert {k: v for k, v in root.counts.items() if k.startswith("rope.") and v} == \
        {f"rope.{style}": cfg.n_layers}
    assert sum(r.name == "rope" for r in rec.records) == cfg.n_layers


def test_a_cacheless_forward_takes_the_k5_route():
    cfg = get_config("qwen1.5-4b", smoke=True).replace(attn_impl="pallas")
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = tracing.counters()
    T.forward(model, cfg, {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    after = tracing.counters()
    assert after["attn.k5"] - before.get("attn.k5", 0) == cfg.n_layers
    assert after.get("attn.plain", 0) == before.get("attn.plain", 0)


#: (arch, config changes, what runs, S) -> the route of each attention call
#: under ``attn_impl="pallas"``: ``k5`` and ``plain`` calls a run, as
#: functions of the config.  A cached prefill writing its S > 1 rows from
#: index 0 takes K5, in place of the JAX package's plain path; a decode
#: step, a softcap, the VLM's prefix and cross-attention stay plain.
ROUTES = {
    "dense-prefill": ("qwen1.5-4b", {}, "prefill", 8,
                      lambda c: c.n_layers, lambda c: 0),
    "dense-prefill-xla": ("qwen1.5-4b", {"attn_impl": "xla"}, "prefill", 8,
                          lambda c: 0, lambda c: c.n_layers),
    "dense-prefill-cache-longer": ("qwen1.5-4b", {}, "prefill-longer-cache", 8,
                                   lambda c: c.n_layers, lambda c: 0),
    "sliding-window-prefill": ("qwen1.5-4b", {"attn_window": 8}, "prefill", 8,
                               lambda c: c.n_layers, lambda c: 0),
    "gqa-prefill": ("chatglm3-6b", {}, "prefill", 8, lambda c: c.n_layers, lambda c: 0),
    "moe-prefill": ("qwen2-moe-a2.7b", {}, "prefill", 8,
                    lambda c: c.n_layers, lambda c: 0),
    "audio-prefill": ("whisper-medium", {}, "prefill", 8,   # encoder, cross: plain
                      lambda c: c.n_layers, lambda c: c.n_encoder_layers + c.n_layers),
    "one-token-prefill": ("qwen1.5-4b", {}, "prefill", 1, lambda c: 0, lambda c: c.n_layers),
    "softcap-prefill": ("qwen1.5-4b", {"attn_logit_softcap": 30.0}, "prefill", 8,
                        lambda c: 0, lambda c: c.n_layers),
    "moe-softcap-prefill": ("grok-1-314b", {}, "prefill", 8,
                            lambda c: 0, lambda c: c.n_layers),
    "vlm-prefill": ("paligemma-3b", {}, "prefill", 8, lambda c: 0, lambda c: c.n_layers),
    "decode-scalar-index": ("qwen1.5-4b", {}, "decode", 8,
                            lambda c: 0, lambda c: c.n_layers),
    "decode-row-index": ("qwen1.5-4b", {}, "decode-rows", 8,
                         lambda c: 0, lambda c: c.n_layers),
    "audio-decode": ("whisper-medium", {}, "decode", 8, lambda c: 0, lambda c: 2 * c.n_layers),
}


def _family_batch(cfg, B, S):
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.family.value == "audio":
        batch["frames"] = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=g)
    if cfg.family.value == "vlm":
        batch["patches"] = torch.randn((B, cfg.n_vision_tokens, cfg.d_model), generator=g)
    return batch


@pytest.mark.parametrize("case", list(ROUTES))
def test_the_route_of_a_cached_call_under_pallas(case, monkeypatch):
    """The route counter and K5's calls for each kind of cached call; K5
    in a cached prefill reads the cache it has just written, in place, over
    this call's S rows, with the config's window."""
    from repro_torch.kernels import ops

    arch, changes, what, S, k5, plain = ROUTES[case]
    cfg = get_config(arch, smoke=True).replace(**dict({"attn_impl": "pallas"}, **changes))
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    B = 2
    batch = _family_batch(cfg, B, S)
    cache = T.init_cache(cfg, B, S + (4 if what != "prefill" else 0), device="cpu")
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: calls.append((k, kw)) or real(q, k, v, **kw))
    before = tracing.counters()
    if what.startswith("prefill"):
        T.prefill(model, cfg, batch, cache)
    else:
        index = torch.full((B,), 3) if what == "decode-rows" else 3
        T.decode_step(model, cfg, cache, batch["tokens"][:, :1], index)
    after = tracing.counters()
    counts = {k: after.get(k, 0) - before.get(k, 0) for k in ("attn.k5", "attn.plain")}
    assert counts == {"attn.k5": k5(cfg), "attn.plain": plain(cfg)}
    assert len(calls) == k5(cfg)
    self_cache = cache["self"] if cfg.family.value == "audio" else cache
    for k, kw in calls:
        assert kw == {"causal": True, "window": cfg.attn_window}
        assert k.shape[2] == S
        assert k.untyped_storage().data_ptr() == self_cache["k"].untyped_storage().data_ptr()


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_a_prefill_longer_than_the_windows_cache_still_raises(attn_impl, monkeypatch):
    """A dense config's cache holds at most ``attn_window`` rows; a longer
    prompt fails in the cache write, before any attention, as the JAX
    package's prefill fails (ROADMAP R6), on either route."""
    from repro_torch.kernels import ops

    cfg = get_config("qwen1.5-4b", smoke=True).replace(attn_impl=attn_impl, attn_window=6)
    model = T.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(cfg, 2, 9, device="cpu")
    assert cache["k"].shape[2] == 6
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **k: pytest.fail("K5 ran"))
    before = tracing.counters()
    with pytest.raises(RuntimeError):
        T.prefill(model, cfg, _family_batch(cfg, 2, 9), cache)
    # the first layer's rotation, which comes before the write, and nothing else
    assert tracing.counters() == dict(before, **{"rope.full": before.get("rope.full", 0) + 1})


def test_launch_counts_read_and_reset_every_model_kernel(monkeypatch):
    from repro_torch.kernels import causal_conv as CC, flash_attention as FA, rmsnorm as RN
    from repro_torch.kernels import selective_scan as SS

    monkeypatch.setattr(FA.flash_attention, "launches", 3)
    monkeypatch.setattr(FA.flash_attention, "launches_wgmma", 2)
    monkeypatch.setattr(FA.flash_attention, "launches_fma", 1)
    monkeypatch.setattr(RN.rmsnorm, "launches", 4)
    monkeypatch.setattr(RN.rmsnorm_residual, "launches", 5)
    monkeypatch.setattr(SS.selective_scan, "launches", 6)
    monkeypatch.setattr(CC.causal_conv_silu, "launches", 7)
    assert kernels.launch_counts() == {
        "flash_attention": 3, "flash_attention_wgmma": 2, "flash_attention_fma": 1,
        "rmsnorm": 4, "rmsnorm_residual": 5, "selective_scan": 6, "causal_conv": 7}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert FA.flash_attention.launches == RN.rmsnorm.launches == SS.selective_scan.launches \
        == CC.causal_conv_silu.launches == 0


def test_a_counted_span_records_the_launch_deltas(monkeypatch):
    from repro_torch.kernels import causal_conv as CC, selective_scan as SS

    monkeypatch.setattr(SS.selective_scan, "launches", 10)
    monkeypatch.setattr(CC.causal_conv_silu, "launches", 3)
    tracing.enable()
    with tracing.span("prefill", counts=True):
        SS.selective_scan.launches += 64
        CC.causal_conv_silu.launches += 64
        tracing.count("attn.plain")
        tracing.count("attn.plain")
        tracing.count("conv.fused")
    root, = tracing.records()
    assert root.counts["selective_scan"] == 64 and root.counts["attn.plain"] == 2
    assert root.counts["causal_conv"] == 64 and root.counts["conv.fused"] == 1
    assert root.counts["rmsnorm"] == 0


def test_the_first_library_load_is_a_build_span(monkeypatch, tmp_path):
    from repro_torch.core import _build

    def fake_build():
        _build.build_info.update(path=str(tmp_path / "lib.so"), seconds=7.5, cached=False,
                                 log="")
        return tmp_path / "lib.so"

    handle = SimpleNamespace(**{name: SimpleNamespace() for name in _build._SIGNATURES})
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build_info", {})
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: handle)
    tracing.enable()
    assert _build.lib() is handle and _build.lib() is handle
    span, = tracing.records()
    assert span.name == "kernels.build" and span.attrs == {"cached": False, "build_s": 7.5}


def test_nested_spans_share_a_request_and_roots_start_new_ones():
    tracing.enable()
    with tracing.span("prefill"):
        with tracing.span("block", index=0):
            pass
    with tracing.span("prefill"):
        pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["block", "prefill", "prefill"]
    assert recs[0].request == recs[1].request != recs[2].request
    assert recs[0].parent == recs[1].id and recs[1].parent is None


def test_spans_line_up_with_the_profilers_clock():
    """A kineto event of an op run inside a span falls inside that span once
    the span is moved by ``clock_offset_ns`` (CPU activity here, a test-only
    use: the benchmark's trace records device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    rec = tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with tracing.span("mm"):
            time.sleep(0.001)
            torch.mm(x, x)
            time.sleep(0.001)
        time.sleep(0.002)
    tracing.disable()
    span, = rec.records
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(ev) == 1
    lo, hi = span.start_ns + rec.clock_offset_ns, span.end_ns + rec.clock_offset_ns
    assert lo <= ev[0].start_ns() <= ev[0].end_ns() <= hi
    assert ev[0].start_ns() - lo >= 0.5e6     # the sleep before the op, not slack

"""CPU tests of the GLM family (``perfbench/reference/glm.py``, the
``chatglm3-6b`` configuration) and of the readers ``k5_roofline`` and
``rope_device_ms``.  The harness's own tests run the cell at smoke size
(float32 parity, bf16 within the limits, the float8 control failing,
faults); these add the rotary, the FLOP count, the readers' arithmetic and
prefill then decode through the port's cache.

    PYTHONPATH=src python -m pytest -q perfbench/tests/test_perfbench_glm.py

The test marked ``cuda`` runs the serving check at published size on the
card and skips elsewhere."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import spans, spec, trace as tr
from perfbench.run import Program
from perfbench.spans import Event, HostSpan, SpanSlice
from perfbench.tests.smoke_tree import smoke_tree
from perfbench.traffic import Traffic
from repro_torch.models import transformer as T

CELL = "chatglm3-6b.prefill_8k"
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return smoke_tree(tmp_path_factory.mktemp("checkout"))


def _chatglm_apply_rotary_pos_emb(x, rope_cache):
    """``modeling_chatglm.py``'s ``apply_rotary_pos_emb``, line for line:
    x (sq, b, np, hn), rope_cache (sq, b, rot_dim // 2, 2)."""
    sq, np_ = x.size(0), x.size(2)
    rot_dim = rope_cache.shape[-2] * 2
    x, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    rope_cache = rope_cache[:sq]
    xshaped = x.reshape(sq, -1, np_, rot_dim // 2, 2)
    rope_cache = rope_cache.view(sq, -1, 1, xshaped.size(3), 2)
    x_out2 = torch.stack(
        [
            xshaped[..., 0] * rope_cache[..., 0] - xshaped[..., 1] * rope_cache[..., 1],
            xshaped[..., 1] * rope_cache[..., 0] + xshaped[..., 0] * rope_cache[..., 1],
        ],
        -1,
    )
    x_out2 = x_out2.flatten(3)
    return torch.cat((x_out2, x_pass), dim=-1)


def _chatglm_rope_cache(seq_len, n_elem, base=10000):
    """``RotaryEmbedding.forward_impl`` of ``modeling_chatglm.py`` in float32."""
    theta = 1.0 / (base ** (torch.arange(0, n_elem, 2, dtype=torch.float) / n_elem))
    seq_idx = torch.arange(seq_len, dtype=torch.float)
    idx_theta = torch.outer(seq_idx, theta).float()
    return torch.stack([torch.cos(idx_theta), torch.sin(idx_theta)], dim=-1)


def test_the_glm_rotary_is_chatglms_and_the_ports():
    """On the first kv_channels // 2 = 64 dims of each head, in interleaved
    pairs, against a transcription of ChatGLM's code and against the port's
    ``apply_rope(..., "half")``; dims 64-127 come back untouched."""
    from repro_torch.models.layers import apply_rope, rope_tables

    glm = spec.load_cell(CELL).reference
    B, S, H, D = 2, 300, 4, 128
    x = torch.randn((B, S, H, D), generator=torch.Generator().manual_seed(5))
    got = glm.glm_rotary(x, 10000.0)
    cache = _chatglm_rope_cache(S, D // 2)[:, None].expand(S, B, D // 4, 2)
    want = _chatglm_apply_rotary_pos_emb(x.transpose(0, 1), cache).transpose(0, 1)
    assert torch.allclose(got, want, atol=1e-6, rtol=0)
    # the port's frequencies (1e4 ** -(j / 32)) and ChatGLM's (1 / 1e4 ** (2j / 64))
    # differ in their last float32 bit, which the angle multiplies by the
    # position: 2e-5 at 300, 5e-4 at 8 192
    pos = torch.arange(S).expand(B, S)
    port = apply_rope(x, *rope_tables(pos, D // 2, 1e4), "half")
    assert torch.allclose(got, port, atol=4e-5, rtol=0)
    assert torch.equal(got[..., D // 2:], x[..., D // 2:])
    assert not torch.allclose(got[:, 1:, :, :D // 2], x[:, 1:, :, :D // 2], atol=1e-3)


def test_model_flops_of_the_8k_request():
    cell = spec.load_cell(CELL)
    assert cell.reference.model_flops(cell.config, 1, 8192) == pytest.approx(1.0896e14, rel=5e-3)
    z = cell.reference.sizes(cell.config)
    assert (z["heads"], z["kv_heads"], z["head_dim"], z["d_ff"]) == (32, 2, 128, 13696)


@pytest.mark.parametrize("flag,value", [
    ("rmsnorm", False), ("original_rope", False), ("post_layer_norm", False),
    ("add_qkv_bias", False), ("add_bias_linear", True),
    ("apply_residual_connection_post_layernorm", True), ("multi_query_attention", False),
    ("tie_word_embeddings", True)])
def test_the_reference_refuses_what_it_does_not_implement(flag, value):
    cell = spec.load_cell(CELL)
    with pytest.raises(ValueError, match=flag):
        cell.reference.sizes(dict(cell.config, **{flag: value}))


def test_the_neox_rotary_of_the_dense_reference_reads_the_ports_cache_as_wrong(tree):
    """The port's correct k cache, held to the dense family's NeoX rotary
    over whole heads, is far outside the limits: the rotary is what the
    GLM reference adds."""
    cell = spec.load_cell(CELL, tree)
    cfg, weights, tokens, model = _port(cell, "float32")
    cache = T.init_cache(cfg, *tokens.shape, device="cpu")
    T.prefill(model, cfg, {"tokens": tokens}, cache)
    dense = spec.load_cell("qwen1.5-4b.prefill_chat", tree).reference
    worst = []
    dense.prefill(weights, dict(cell.reference._as_dense(cell.config),
                                rms_norm_eps=cell.config["layernorm_epsilon"],
                                rope_theta=10000.0),
                  tokens, on_layer=lambda i, e: worst.append(
                      float((cache["k"][i] - e["k"]).norm() / e["k"].norm())))
    assert min(worst) > 0.3


# --------------------------------------------------------------------------- #
# prefill, then decode through the port's cache
# --------------------------------------------------------------------------- #


def _port(cell, compute_dtype, device="cpu"):
    """The port's config in ``compute_dtype``, the benchmark's weights, a
    request's token ids and the model."""
    port = json.loads(json.dumps(cell.config["port"]))
    port["replace"]["compute_dtype"] = compute_dtype
    prog = Program()
    cfg = prog.config(port)
    weights = cell.reference.make_weights(cell.config, 11, device)
    traffic = Traffic(cell.traffic, SEED, cell.reference.sizes(cell.config)["vocab"])
    tokens = traffic.tokens(0, device)
    return cfg, weights, tokens, prog.model(cfg, weights)


def _logits_err(got, want):
    return float(((got.float() - want).abs().amax(dim=-1) / want.std(dim=-1)).max())


def serve_and_check(cell, compute_dtype, steps, device):
    """The port's prefill of a request and then ``steps`` greedy
    ``decode_step`` s through its cache: -> the ``logits_err`` of the
    prefill and of each step against the reference's prefill over the
    prompt as it has grown."""
    cfg, weights, tokens, model = _port(cell, compute_dtype, device)
    B, S = tokens.shape
    cache = T.init_cache(cfg, B, S + steps, device=device)
    cache, logits = T.prefill(model, cfg, {"tokens": tokens}, cache)
    errs = []
    for step in range(steps + 1):
        errs.append(_logits_err(logits[:, -1], cell.reference.prefill(weights, cell.config,
                                                                       tokens)))
        if step == steps:
            return errs
        nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
        tokens = torch.cat([tokens, nxt], dim=1)
        cache, logits = T.decode_step(model, cfg, cache, nxt, S + step)


def test_prefill_then_decode_through_the_cache_is_the_references_forward(tree):
    errs = serve_and_check(spec.load_cell(CELL, tree), "float32", 4, "cpu")
    assert len(errs) == 5 and max(errs) < 1e-4, errs


def test_prefill_then_decode_in_bf16_stays_within_the_smoke_limits(tree):
    cell = spec.load_cell(CELL, tree)
    errs = serve_and_check(cell, "bfloat16", 4, "cpu")
    assert max(errs) <= cell.limits["limits"]["logits_err"], errs


@pytest.mark.cuda
def test_prefill_then_decode_at_published_size_on_the_card():
    """Prefill at 8 192 and 8 decode steps, each step's logits against the
    reference's forward over the grown prompt, within the cell's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(CELL)
    errs = serve_and_check(cell, "bfloat16", 8, "cuda:0")
    print(json.dumps({"serving_check": CELL, "logits_err": errs}))
    assert max(errs) <= cell.limits["limits"]["logits_err"], errs


# --------------------------------------------------------------------------- #
# the readers
# --------------------------------------------------------------------------- #


def test_k5_roofline_reads_the_bound_over_the_device_time():
    """28 K5 launches, each twice the frozen bound at the cell's shape,
    read 50 %; the reader reads nothing without K5 launches."""
    cell = spec.load_cell(CELL)
    k5 = next(k for k in cell.kernels if k.GROUP == "K5")
    ms, by = k5.attention_bound(1, 32, 2, 8192, 8192, 128, True, None, "bfloat16")
    assert by == "operations" and round(ms, 3) == 0.556
    us = 2 * ms * 1e3
    ops = [tr.DeviceOp("flash_attention_sm90_k<128>", "K5", i * us, (i + 1) * us)
           for i in range(28)] + [tr.DeviceOp("nvjet_tst", "matmul", 28 * us, 29 * us)]
    slc = tr.Slice(ops=ops, wall_s=1.0, requests=[(1, 8192)], enqueue_ms_outside=[],
                   config=cell.config, reference=cell.reference, kernels=cell.kernels)
    read = cell.readers["k5_roofline"].read
    assert read(slc) == pytest.approx(50.0)
    assert read(tr.Slice(ops=ops[28:], wall_s=1.0, requests=[(1, 8192)],
                         enqueue_ms_outside=[], config=cell.config,
                         reference=cell.reference, kernels=cell.kernels)) is None


def test_rope_device_ms_reads_the_rotations_inside_attn():
    """The device time of operations launched inside ``rope`` spans a
    request, which ``attn`` also counts; None without a ``rope`` span."""
    us = 1000
    cell = spec.load_cell(CELL)
    reader = spec.load_module(spec.ROOT / "perfbench" / "metrics" / "rope_device_ms.py",
                              "rope_device_ms")

    def span(id, parent, name, a, b):
        return HostSpan(id, parent, 1, name, a * us, b * us, {}, None)

    with_rope = [span(1, None, "prefill", 100, 1000), span(2, 1, "block", 200, 600),
                 span(3, 2, "attn", 210, 400), span(4, 3, "rope", 250, 300)]
    calls = [Event("cudaLaunchKernel", 220 * us, 225 * us, 1),     # attn's projection
             Event("cudaLaunchKernel", 260 * us, 265 * us, 2),     # the rotation
             Event("cudaLaunchKernel", 280 * us, 285 * us, 3)]     # the rotation
    ops = [Event("nvjet", 230 * us, 300 * us, 1), Event("elementwise", 300 * us, 340 * us, 2),
           Event("cat", 340 * us, 350 * us, 3)]

    def slc(spans_):
        return SpanSlice(ops=[], wall_s=1e-3, requests=[(1, 8)], enqueue_ms_outside=[],
                         config=cell.config, reference=cell.reference, kernels=cell.kernels,
                         spans=spans_, device=ops, calls=calls, window_ns=(0, 1000 * us))

    assert reader.read(slc(with_rope)) == pytest.approx(0.050)
    assert spans.attribution(slc(with_rope)).device_inside["attn"] == 120 * us
    assert reader.read(slc(with_rope[:3])) is None

"""The Mamba mixer's fused causal conv, bias and SiLU
(``repro_torch.kernels.causal_conv``) and its route in ``mamba_apply``.

On the CPU: the wrapper is the plain composition (``causal_conv1d`` then
``F.silu``, both in ``repro_torch.kernels.causal_conv``) bit for bit, on strided views too; it refuses what the card's
kernel does not take on every device and counts no launch; an emulation
of the kernel's arithmetic (taps from the oldest, each bf16 product and
partial sum rounded once from its exact value) is ``causal_conv1d`` bit
for bit, as rounding once is rounding through float32 for bf16 operands;
``mamba_apply`` under ``"pallas"`` takes the wrapper, counts
``conv.plain`` on the CPU and holds to the ``"xla"`` path.

On the card (``cuda``-marked): the kernel against the plain composition bit
for bit at falcon-mamba-7b's shapes, at decode steps with a state, on the
one-channel-a-thread path; ``mamba_apply`` on the kernel against
``mamba_apply`` on the plain conv.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs as PC
from repro_torch import kernels, tracing
from repro_torch.kernels import causal_conv as CC
from repro_torch.kernels import ops
from repro_torch.kernels.causal_conv import causal_conv1d
from repro_torch.models import layers as PL

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def conv_inputs(B, S, C, dtype=torch.bfloat16, seed=0, device="cpu",
                param_dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, C), generator=g).to(dtype)
    w = (torch.randn((CC.WIDTH, C), generator=g) * 0.5).to(param_dtype)
    b = (torch.randn((C,), generator=g) * 0.1).to(param_dtype)
    state = torch.randn((B, CC.WIDTH - 1, C), generator=g).to(dtype)
    return tuple(t.to(device) for t in (x, w, b, state))


def xz_half(x):
    """``x`` as the mixer's ``xi``: the first half of each row of a (B, S,
    2C) tensor, not contiguous."""
    B, S, C = x.shape
    xz = torch.cat([x, torch.randn((B, S, C), generator=torch.Generator().manual_seed(9))
                    .to(x.device, x.dtype)], dim=-1)
    view = xz.chunk(2, dim=-1)[0]
    assert not view.is_contiguous() and view.stride(-1) == 1
    return view


def _exact(got, want):
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


# --------------------------------------------------------------------------- #
# CPU: the wrapper, its refusals, the kernel's arithmetic, the route
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "xz-half"])
@pytest.mark.parametrize("S", [1, 2, 3, 17])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrapper_is_the_plain_composition_on_cpu(dtype, with_state, with_bias, S, strided):
    x, w, b, state = conv_inputs(2, S, 24, dtype=DTYPES[dtype], seed=S)
    b = b if with_bias else None
    state = state if with_state else None
    want_y, want_state = causal_conv1d(x, w, b, state)
    xin = xz_half(x) if strided else x
    before = CC.causal_conv_silu.launches
    y, new_state = ops.causal_conv_silu(xin, w, b, state)
    assert CC.causal_conv_silu.launches == before
    _exact(y, F.silu(want_y))
    _exact(new_state, want_state)


@pytest.mark.parametrize("S", [1, 2, 5])
def test_new_state_is_the_last_rows_of_state_and_x(S):
    """``_new_state``, which the kernel path returns beside ``y``: a view of
    ``x`` when it has 3 rows, else the state's tail ahead of ``x`` --
    ``causal_conv1d``'s new state either way."""
    x, w, b, state = conv_inputs(2, S, 8, seed=4)
    for st in (state, None):
        got = CC._new_state(x, st)
        _exact(got, causal_conv1d(x, w, b, st)[1])
        if S >= CC.WIDTH - 1:
            assert got.data_ptr() == x[:, S - 3:].data_ptr()


def test_wrapper_refuses_what_the_kernel_does_not_take_and_counts_no_cpu_launch():
    x, w, b, state = conv_inputs(2, 5, 16, seed=1)
    before = CC.causal_conv_silu.launches
    ops.causal_conv_silu(x, w, b, state)
    assert CC.causal_conv_silu.launches == before
    with pytest.raises(ValueError, match="unit stride"):
        ops.causal_conv_silu(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="unit stride"):
        ops.causal_conv_silu(x, w, b, state.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.causal_conv_silu(x.half(), w, b)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.causal_conv_silu(x, w.double(), b)
    for width in (3, CC.WIDTH + 1):
        with pytest.raises(ValueError, match="width 4"):
            ops.causal_conv_silu(x, torch.randn(width, 16), b)
    with pytest.raises(ValueError, match="state"):
        ops.causal_conv_silu(x, w, b, state[:, :2])
    with pytest.raises(ValueError, match="state in x's dtype"):
        ops.causal_conv_silu(x, w, b, state.float())
    with pytest.raises(ValueError, match="b "):
        ops.causal_conv_silu(x, w, b[:8])
    with pytest.raises(ValueError, match="contiguous"):
        ops.causal_conv_silu(x, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.causal_conv_silu(*(t.to("meta") for t in (x, w, b)))
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.causal_conv_silu(x, w.clone().requires_grad_(), b)
    assert CC.causal_conv_silu.launches == before


def test_wrapper_refuses_a_dtensor_before_anything_else(monkeypatch):
    """``refuse_dtensor`` comes first (a real DTensor: the mesh suite's
    ``test_kernel_wrapper_refuses_a_dtensor``)."""
    from repro_torch.distributed import place

    x, w, b, state = conv_inputs(2, 5, 16, seed=1)
    monkeypatch.setattr(place, "is_dtensor", lambda t: t is state)
    with pytest.raises(TypeError, match="DTensor"):
        ops.causal_conv_silu(x, w, b, state)


def kernel_arithmetic(x, w, b, state):
    """The card kernel's arithmetic: from +0, each tap's product and the
    running sum rounded to ``x``'s dtype, the oldest input first, then the
    bias.  bf16 steps are rounded once from their exact value, as the
    kernel's PTX ``mul.rn.bf16x2`` / ``add.rn.bf16x2`` round them (float64
    here, exact or innocuous, then ``bf16_rounded_once``); float32 steps are
    float32 operations."""
    if x.dtype == torch.bfloat16:
        rnd, widen = (lambda v: bf16_rounded_once(v.numpy()).double()), torch.Tensor.double
    else:
        rnd, widen = (lambda v: v), torch.Tensor.float
    width, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = widen(torch.cat([state.to(x.dtype), x], dim=1))
    wr = widen(w.to(x.dtype))
    acc = torch.zeros_like(xp[:, :S])
    for i in range(width):
        acc = rnd(acc + rnd(xp[:, i:i + S] * wr[i]))
    if b is not None:
        acc = rnd(acc + widen(b.to(x.dtype)))
    return acc.to(x.dtype)


@pytest.mark.parametrize("S", [1, 3, 17, 64])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_arithmetic_is_causal_conv1d_bit_for_bit(dtype, S):
    """The kernel's rounding order, with float32 weights rounded to a bf16
    ``x``'s dtype as the plain version rounds them, equals
    ``causal_conv1d``; summing the taps in float32 and rounding once does
    not (the check that the order matters)."""
    x, w, b, state = conv_inputs(3, S, 40, dtype=DTYPES[dtype], seed=S)
    for st, bias in ((state, b), (None, None)):
        _exact(kernel_arithmetic(x, w, bias, st), causal_conv1d(x, w, bias, st)[0])
    if dtype == "bf16" and S >= 17:
        xp = torch.cat([state.to(x.dtype), x], 1).float()
        once = sum(xp[:, i:i + S] * w[i].to(x.dtype).float() for i in range(4)) + b.to(x.dtype).float()
        assert not torch.equal(once.to(x.dtype), causal_conv1d(x, w, b, state)[0])


def bf16_rounded_once(v):
    """float64 values rounded once to bf16, to nearest even (8 bits of
    precision, bf16's subnormals below 2**-126, inf past its largest
    finite value)."""
    _, e = np.frexp(v)
    quantum = np.ldexp(1.0, np.maximum(e, -125) - 8)
    out = np.rint(v / quantum) * quantum
    out[np.abs(out) > float(torch.finfo(torch.bfloat16).max)] *= np.inf
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("op", ["mul", "add"])
def test_bf16_ops_rounded_once_are_float32_ops_rounded_to_bf16(op):
    """The card kernel's bf16 products and sums (PTX ``mul.rn.bf16x2`` /
    ``add.rn.bf16x2``, each rounded once from the exact result) against the plain version's
    (computed in float32, then rounded to bf16), over random bf16 bit
    patterns of every finite exponent, subnormals and signed zeros
    included: the same bits, as 24 >= 2 * 8 + 2 makes double rounding
    innocuous."""
    rng = np.random.default_rng(7 if op == "mul" else 8)
    bits = rng.integers(0, 2 ** 16, (2, 1 << 20), dtype=np.uint16)
    bits = bits[:, ((bits & 0x7F80) != 0x7F80).all(0)]          # finite only
    a, b = (torch.from_numpy(r.view(np.int16).copy()).view(torch.bfloat16) for r in bits)
    a64, b64 = a.double().numpy(), b.double().numpy()
    exact = a64 * b64 if op == "mul" else a64 + b64   # exact, or innocuous at 53 bits
    plain = (a.float() * b.float() if op == "mul" else a.float() + b.float()).bfloat16()
    assert torch.equal(plain.view(torch.int16), bf16_rounded_once(exact).view(torch.int16))


def _mamba(dtype, attn_impl, seed=0):
    cfg = PC.get_config("falcon-mamba-7b", smoke=True).replace(
        compute_dtype=dtype, attn_impl=attn_impl)
    p = PL.mamba_init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, p


def _mamba_state(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return {"conv": torch.randn((B, s.conv_width - 1, d_in), generator=g).to(
                PL.dtype_of(cfg.compute_dtype)),
            "ssm": torch.randn((B, d_in, s.state_dim), generator=g)}


@pytest.mark.parametrize("S", [1, 2, 9])
@pytest.mark.parametrize("with_state", [False, True], ids=["no-cache", "cache"])
def test_mamba_apply_under_pallas_counts_conv_plain_on_cpu_and_holds_to_xla(with_state, S):
    cfg, p = _mamba("float32", "pallas")
    x = torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(S))
    states = [_mamba_state(cfg, 2, 5) if with_state else None for _ in range(2)]
    before = tracing.counters()
    with torch.no_grad():
        got = PL.mamba_apply(p, cfg, x, state=states[0])
    after = tracing.counters()
    assert after["conv.plain"] - before.get("conv.plain", 0) == 1
    assert after.get("conv.fused", 0) == before.get("conv.fused", 0)
    assert after["causal_conv"] == before["causal_conv"]
    with torch.no_grad():
        want = PL.mamba_apply(p, cfg.replace(attn_impl="xla"), x, state=states[1])
    assert tracing.counters()["conv.plain"] - after["conv.plain"] == 1
    assert float((got - want).abs().max()) < 1e-4 * max(float(want.abs().max()), 1.0)
    if with_state:
        _exact(states[0]["conv"], states[1]["conv"])
        torch.testing.assert_close(states[0]["ssm"], states[1]["ssm"], atol=1e-4, rtol=1e-4)


def test_mamba_apply_routes_the_conv_through_the_wrapper_only_under_pallas(monkeypatch):
    """``"pallas"`` calls ``kops.causal_conv_silu`` once a call (not under
    autograd); ``"xla"`` and a differentiated call keep ``causal_conv1d``;
    the RG-LRU block never takes the wrapper."""
    calls = []
    real = ops.causal_conv_silu
    monkeypatch.setattr(ops, "causal_conv_silu",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg, p = _mamba("bfloat16", "pallas")
    x = torch.randn((1, 5, cfg.d_model))
    with torch.no_grad():
        fused = PL.mamba_apply(p, cfg, x)
        assert len(calls) == 1
        plain = PL.mamba_apply(p, cfg.replace(attn_impl="xla"), x)
    assert len(calls) == 1
    # the conv is the same bits on both routes; the scans differ in order
    assert float((fused.float() - plain.float()).abs().max()) < 0.05
    xla = cfg.replace(attn_impl="xla")
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    PL.mamba_apply(pg, xla, x).float().sum().backward()
    assert len(calls) == 1 and pg["conv_w"].grad is not None
    # under "pallas" a differentiated call keeps the plain conv; K8 then
    # refuses it, as it refuses every call that would need a backward
    with pytest.raises(NotImplementedError, match="no backward"):
        PL.mamba_apply(pg, cfg, x)
    assert len(calls) == 1
    hyb = PC.get_config("recurrentgemma-9b", smoke=True).replace(attn_impl="pallas")
    rp = PL.rglru_init(hyb, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        PL.rglru_apply(rp, hyb, torch.randn((1, 5, hyb.d_model)).to(
            PL.dtype_of(hyb.compute_dtype)))
    assert len(calls) == 1


@pytest.mark.parametrize("width", [2, 3])
def test_mamba_apply_keeps_the_plain_conv_at_a_width_the_kernel_lacks(monkeypatch, width):
    """The kernel's width is 4; a Mamba config of another width keeps the
    plain conv under ``"pallas"`` (counted ``conv.plain``) and holds to
    ``"xla"``."""
    import dataclasses

    calls = []
    monkeypatch.setattr(ops, "causal_conv_silu", lambda *a, **k: calls.append(1))
    cfg, _ = _mamba("float32", "pallas")
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, conv_width=width))
    p = PL.mamba_init(cfg, torch.Generator().manual_seed(1), "cpu")
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(2))
    before = tracing.counters().get("conv.plain", 0)
    with torch.no_grad():
        got = PL.mamba_apply(p, cfg, x)
        want = PL.mamba_apply(p, cfg.replace(attn_impl="xla"), x)
    assert not calls and tracing.counters()["conv.plain"] - before == 2
    assert float((got - want).abs().max()) < 1e-4 * max(float(want.abs().max()), 1.0)


# --------------------------------------------------------------------------- #
# The card
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is compiled with nvcc for "
                    "sm_90a and has no CPU mode")
    return torch.device("cuda")


def _on_card(x, w, b, state):
    before = CC.causal_conv_silu.launches
    got = ops.causal_conv_silu(x, w, b, state)
    assert CC.causal_conv_silu.launches == before + 1
    want = CC.plain_causal_conv_silu(x, w, b, state)
    _exact(got[0], want[0])
    _exact(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 8192), (32, 2048)], ids=["8k", "batch"])
def test_kernel_is_the_plain_composition_at_falcon_mamba_shapes_on_card(cuda_device, B, S):
    """The strided ``xi`` half of the mixer's (B, S, 16 384) ``xz``, bf16,
    a zero state, bf16 weights and bias as the benchmark draws them."""
    g = torch.Generator(cuda_device).manual_seed(B)
    xz = torch.randn((B, S, 2 * 8192), generator=g, device=cuda_device).bfloat16()
    xi = xz.chunk(2, dim=-1)[0]
    w = (torch.randn((4, 8192), generator=g, device=cuda_device) * 0.5).bfloat16()
    b = (torch.randn((8192,), generator=g, device=cuda_device) * 0.1).bfloat16()
    _on_card(xi, w, b, None)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # decode steps with a state; ragged S against the 64-step tiles; C not a
    # multiple of 8; an unaligned base (one-channel path); float32 x with
    # bf16 and float32 weights, on both paths; bf16 weights with bf16 x
    dict(B=4, S=1, C=8192), dict(B=4, S=2, C=8192), dict(B=3, S=67, C=8192),
    dict(B=2, S=130, C=1000), dict(B=2, S=70, C=77), dict(B=2, S=33, C=520, offset=1),
    dict(B=2, S=100, C=256, dtype=torch.float32, param_dtype=torch.bfloat16),
    dict(B=2, S=100, C=260, dtype=torch.float32),
    dict(B=2, S=65, C=128, param_dtype=torch.bfloat16)],
    ids=lambda c: "-".join(f"{k}{v}".replace("torch.", "") for k, v in c.items()))
def test_kernel_is_the_plain_composition_at_the_edges_on_card(cuda_device, case):
    case = dict(case)
    offset = case.pop("offset", 0)
    B, S, C = case.pop("B"), case.pop("S"), case.pop("C")
    x, w, b, state = conv_inputs(B, S, C + offset, seed=S + C, device=cuda_device, **case)
    x, w, b, state = x[..., offset:], w[:, offset:].contiguous(), b[offset:].contiguous(), \
        state[..., offset:]
    for st in (state, None):
        for bias in (b, None):
            _on_card(x, w, bias, st)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 300], ids=["decode1", "decode2", "prefill300"])
def test_mamba_apply_on_the_kernel_is_the_plain_conv_bit_for_bit_on_card(
        cuda_device, monkeypatch, S):
    """The mixer at the smoke config in bf16 under ``"pallas"``, with a
    cache state: the fused conv against the same call with the wrapper
    swapped for the plain composition -- output and new conv state equal;
    ``conv.fused`` and one ``causal_conv`` launch a call."""
    cfg = PC.get_config("falcon-mamba-7b", smoke=True).replace(attn_impl="pallas")
    p = PL.mamba_init(cfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)
    x = torch.randn((2, S, cfg.d_model), device=cuda_device).bfloat16()
    state = {k: v.to(cuda_device) for k, v in _mamba_state(cfg, 2, 3).items()}
    twin = {k: v.clone() for k, v in state.items()}
    before = tracing.counters()
    with torch.no_grad():
        got = PL.mamba_apply(p, cfg, x, state=state)
    after = tracing.counters()
    assert after["conv.fused"] - before.get("conv.fused", 0) == 1
    assert after.get("conv.plain", 0) == before.get("conv.plain", 0)
    assert after["causal_conv"] - before["causal_conv"] == 1
    monkeypatch.setattr(ops, "causal_conv_silu",
                        lambda x, w, b, st: CC.plain_causal_conv_silu(x, w, b, st))
    with torch.no_grad():
        want = PL.mamba_apply(p, cfg, x, state=twin)
    _exact(got, want)
    _exact(state["conv"], twin["conv"])
    _exact(state["ssm"], twin["ssm"])
    assert kernels.launch_counts()["causal_conv"] == after["causal_conv"]
    torch.cuda.synchronize()

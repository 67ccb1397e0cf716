"""Port kernels K5-K8 (``repro_torch.kernels``) held against the JAX
package on the same NumPy-seeded inputs.

Pinned tolerances (those of ``tests/test_kernels.py``), absolute and
relative:

  * K5 flash attention: 2e-4 in float32, 2e-2 in bfloat16;
  * K6 RMSNorm and K7 fused residual RMSNorm: 1e-5 in float32 (the pin of
    ``test_rmsnorm_residual``), 2e-2 in bfloat16;
  * K8 selective scan: 2e-4 in float32, 2e-2 in bfloat16 (``tol_for``),
    and 1e-5 for the carried-state split;

for the port's ``ops.*`` on CPU tensors -- the plain versions -- against
the JAX package's Pallas kernels in interpret mode (as the JAX package's
own tests run them on the CPU) and its ``ref`` oracles; and for the
kernels against the plain versions on the card (``cuda``-marked tests,
which skip here with the reason).

The JAX package comes in through a fixture, so the ``cuda``-marked tests
also run where JAX is not installed (``python -m pytest -m cuda
tests/test_torch_kernels.py`` on the machine with the card).
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import configs as PC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import transformer as PT

FA_SHAPES = [
    # (B, H, K, S, T, D): tests/test_kernels.py's four, plus a ragged S
    (1, 4, 4, 128, 128, 64),     # MHA square
    (2, 8, 2, 128, 128, 32),     # GQA
    (1, 4, 1, 256, 256, 64),     # MQA
    (1, 2, 2, 64, 256, 32),      # cross-length (S != T)
    (1, 4, 2, 100, 100, 32),     # ragged: no 64/128 block divides S
]
MASKS = [(True, None), (False, None), (True, 64)]
DTYPES = {"f32": (torch.float32, 2e-4), "bf16": (torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's K5 (``ops``) and its reference (``ref``)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    class JX:
        np, ops, ref = jnp, jops, jref
        dtypes = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

    return JX


def qkv(shape, seed):
    B, H, K, S, T, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, K, T, D)).astype(np.float32),
            rng.standard_normal((B, K, T, D)).astype(np.float32))


def _block(n):
    for b in (64, 32, 25, 20, 16, 8, 4, 2, 1):
        if n % b == 0:
            return b
    return 1


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("causal,window", MASKS,
                         ids=["causal", "full", "causal-window64"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_flash_attention_matches_the_jax_kernel(jx, shape, dtype, causal,
                                                     window):
    tdt, tol = DTYPES[dtype]
    arrays = qkv(shape, seed=sum(shape))
    jq, jk, jv = (jx.np.asarray(a, jx.dtypes[tdt]) for a in arrays)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrays)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    want_ref = jx.ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want_ref), atol=tol, rtol=tol)
    B, H, K, S, T, D = shape
    if causal and S != T:
        return   # the Pallas kernel's tests leave this layout out too
    want = jx.ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=_block(S), block_kv=_block(T),
                                  interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=tol, rtol=tol)


def test_plain_version_zeroes_rows_with_no_live_key(jx):
    q, k, v = (torch.as_tensor(a) for a in qkv((1, 2, 1, 8, 8, 16), seed=3))
    # window 0: no key is within the window of any query
    out = ref.flash_attention_ref(q, k, v, causal=True, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    want = jx.ref.flash_attention_ref(*(jx.np.asarray(a.numpy()) for a in (q, k, v)),
                                      causal=True, window=0)
    np.testing.assert_array_equal(np.asarray(want), out.numpy())


def test_scale_argument_matches_the_jax_reference(jx):
    arrays = qkv((1, 4, 2, 16, 16, 32), seed=5)
    got = ops.flash_attention(*(torch.as_tensor(a) for a in arrays), scale=0.3)
    want = jx.ref.flash_attention_ref(*(jx.np.asarray(a) for a in arrays), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_strided_views_give_the_contiguous_result():
    """The model hands (B, S, H, D) projections over as transposed views."""
    q, k, v = (torch.as_tensor(a) for a in qkv((2, 4, 2, 24, 24, 16), seed=7))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(ops.flash_attention(*views), ops.flash_attention(q, k, v),
                               atol=0.0, rtol=0.0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = FA.flash_attention.launches
    q, k, v = (torch.as_tensor(a) for a in qkv((1, 2, 2, 8, 8, 16), seed=1))
    out = ops.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before
    torch.testing.assert_close(out, FA.plain_flash_attention(q, k, v), atol=0.0, rtol=0.0)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.as_tensor(a) for a in qkv((1, 4, 2, 8, 8, 16), seed=2))
    with pytest.raises(ValueError, match="multiple of KV heads"):
        ops.flash_attention(q, k[:, :1].expand(1, 3, 8, 16), v[:, :1].expand(1, 3, 8, 16))
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, k[..., :8], v)
    with pytest.raises(ValueError, match="takes q"):
        ops.flash_attention(q[0], k, v)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# --------------------------------------------------------------------------- #
# Kernel launches (need the card)
# --------------------------------------------------------------------------- #


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled with nvcc for "
                    "sm_90a and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES + [(2, 32, 2, 129, 129, 128),
                                               (1, 4, 4, 1, 1, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    tdt, tol = DTYPES[dtype]
    q, k, v = (torch.as_tensor(a).to(cuda_device, tdt)
               for a in qkv(shape, seed=sum(shape)))
    for causal, window in MASKS:
        before = FA.flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert FA.flash_attention.launches == before + 1
        want = FA.plain_flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take_on_card(cuda_device):
    q, k, v = (torch.as_tensor(a).to(cuda_device)
               for a in qkv((1, 2, 2, 8, 8, 16), seed=4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    big = torch.zeros((1, 1, 4, 320), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(big, big, big)
    assert math.isclose(float(ops.flash_attention(q, k, v).abs().max()),
                        float(FA.plain_flash_attention(q, k, v).abs().max()),
                        rel_tol=2e-4)


@pytest.mark.cuda
def test_pallas_forward_runs_k5_once_per_layer_on_card(cuda_device):
    cfg = PC.get_config("chatglm3-6b", smoke=True).replace(compute_dtype="float32")
    model = PT.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)),
                           device=cuda_device)
    batch = {"tokens": toks, "labels": toks}
    before = FA.flash_attention.launches
    h_k5, _ = PT.forward(model, cfg.replace(attn_impl="pallas"), batch)
    assert FA.flash_attention.launches == before + cfg.n_layers
    h_plain, _ = PT.forward(model, cfg, batch)
    torch.testing.assert_close(h_k5, h_plain, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------- #
# K6 / K7: RMSNorm and fused residual RMSNorm
# --------------------------------------------------------------------------- #

RMS_SHAPES = [(8, 128), (37, 256), (256, 512), (1, 64)]   # tests/test_kernels.py
RMS_TOL = {"f32": 1e-5, "bf16": 2e-2}


def rms_inputs(rows, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, d)).astype(np.float32),
            rng.standard_normal((rows, d)).astype(np.float32),
            (rng.standard_normal(d) + 1.0).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_rmsnorm_matches_the_jax_kernel(jx, shape, dtype):
    tdt, tol = DTYPES[dtype][0], RMS_TOL[dtype]
    x, _, sc = rms_inputs(*shape, seed=sum(shape))
    got = ops.rmsnorm(torch.as_tensor(x).to(tdt), torch.as_tensor(sc))
    assert got.dtype == tdt and got.shape == shape
    jxx = jx.np.asarray(x, jx.dtypes[tdt])
    for want in (jx.ops.rmsnorm(jxx, jx.np.asarray(sc), interpret=True),
                 jx.ref.rmsnorm_ref(jxx, jx.np.asarray(sc))):
        np.testing.assert_allclose(to_np(got), to_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(16, 9, 128), (37, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_rmsnorm_residual_matches_the_jax_kernel(jx, shape, dtype):
    tdt, tol = DTYPES[dtype][0], RMS_TOL[dtype]
    rng = np.random.default_rng(len(shape))
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    sc = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
    normed, h = ops.rmsnorm_residual(torch.as_tensor(x).to(tdt),
                                     torch.as_tensor(r).to(tdt), torch.as_tensor(sc))
    assert normed.dtype == h.dtype == tdt and normed.shape == h.shape == shape
    w_normed, w_h = jx.ops.rmsnorm_residual(
        jx.np.asarray(x, jx.dtypes[tdt]), jx.np.asarray(r, jx.dtypes[tdt]),
        jx.np.asarray(sc), interpret=True)
    np.testing.assert_allclose(to_np(normed), to_np(w_normed), atol=tol, rtol=tol)
    np.testing.assert_allclose(to_np(h), to_np(w_h), atol=tol, rtol=tol)
    if dtype == "f32":   # the JAX oracle agrees with the kernel in float32
        r_normed, r_h = jx.ref.rmsnorm_residual_ref(
            jx.np.asarray(x), jx.np.asarray(r), jx.np.asarray(sc))
        np.testing.assert_allclose(to_np(normed), to_np(r_normed), atol=tol, rtol=tol)
        np.testing.assert_allclose(to_np(h), to_np(r_h), atol=tol, rtol=tol)


def test_plain_rmsnorm_residual_follows_the_pallas_kernel_not_the_jax_oracle(jx):
    """In bfloat16 the Pallas kernel normalises the float32 sum, the JAX
    oracle the sum rounded to bf16 first: the port's plain K7 gives the
    kernel's output bit for bit and differs from the oracle's."""
    x, r, sc = rms_inputs(37, 256, seed=11)
    tx, tr = torch.as_tensor(x).bfloat16(), torch.as_tensor(r).bfloat16()
    normed, h = ref.rmsnorm_residual_ref(tx, tr, torch.as_tensor(sc))
    jxx, jr = jx.np.asarray(x, jx.np.bfloat16), jx.np.asarray(r, jx.np.bfloat16)
    k_normed, k_h = jx.ops.rmsnorm_residual(jxx, jr, jx.np.asarray(sc), interpret=True)
    o_normed, o_h = jx.ref.rmsnorm_residual_ref(jxx, jr, jx.np.asarray(sc))
    np.testing.assert_array_equal(to_np(normed), to_np(k_normed))
    np.testing.assert_array_equal(to_np(h), to_np(k_h))
    np.testing.assert_array_equal(to_np(h), to_np(o_h))
    differ = to_np(normed) != to_np(o_normed)
    assert differ.sum() > 0.05 * differ.size
    # ... by the rounding of h: at most a bf16 step or two of the output
    np.testing.assert_allclose(to_np(normed), to_np(o_normed), atol=0.07, rtol=2e-2)


def test_rmsnorm_takes_any_leading_shape_and_a_bf16_scale():
    x, r, sc = rms_inputs(12, 64, seed=4)
    x3 = torch.as_tensor(x).reshape(3, 4, 64)
    s16 = torch.as_tensor(sc).bfloat16()
    got = ops.rmsnorm(x3, s16)
    assert got.shape == x3.shape and got.dtype == torch.float32
    torch.testing.assert_close(got.reshape(12, 64),
                               ref.rmsnorm_ref(torch.as_tensor(x), s16), atol=0.0, rtol=0.0)


def test_rmsnorm_wrappers_reject_bad_inputs_and_count_no_cpu_launch():
    x, r, sc = (torch.as_tensor(a) for a in rms_inputs(4, 32, seed=5))
    before = (RN.rmsnorm.launches, RN.rmsnorm_residual.launches)
    ops.rmsnorm(x, sc)
    ops.rmsnorm_residual(x, r, sc)
    assert (RN.rmsnorm.launches, RN.rmsnorm_residual.launches) == before
    with pytest.raises(ValueError, match="does not match the last dim"):
        ops.rmsnorm(x, sc[:16])
    with pytest.raises(ValueError, match="residual"):
        ops.rmsnorm_residual(x, r[:2], sc)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rmsnorm(x.to("meta"), sc.to("meta"))


# --------------------------------------------------------------------------- #
# K8: selective scan
# --------------------------------------------------------------------------- #

SCAN_SHAPES = [
    # (B, S, Din, N, chunk, d_block): tests/test_kernels.py's grid
    (1, 32, 64, 4, 8, 32),
    (2, 64, 128, 8, 16, 64),
    (2, 64, 128, 8, 64, 128),    # single chunk / single block
    (1, 48, 96, 16, 16, 96),     # odd-ish sizes
]


def scan_inputs(B, S, Din, N, seed):
    """xi, dt_raw, Bm, Cm, A, h0 as tests/test_kernels.py scales them."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(B, S, Din) * 0.5, f(B, S, Din) * 0.5 - 1.0, f(B, S, N) * 0.3,
            f(B, S, N) * 0.3, -np.exp(f(Din, N) * 0.3), f(B, Din, N) * 0.5)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-zero", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_selective_scan_matches_the_jax_kernel(jx, shape, dtype, with_h0):
    tdt, tol = DTYPES[dtype]
    B, S, Din, N, chunk, dblk = shape
    xi, dt, bm, cm, A, h0 = scan_inputs(B, S, Din, N, seed=sum(shape))
    h0 = h0 if with_h0 else None
    y, hT = ops.selective_scan(*(torch.as_tensor(a).to(tdt) for a in (xi, dt, bm, cm)),
                               torch.as_tensor(A),
                               torch.as_tensor(h0) if with_h0 else None)
    assert y.dtype == tdt and y.shape == (B, S, Din)
    assert hT.dtype == torch.float32 and hT.shape == (B, Din, N)
    jin = [jx.np.asarray(a, jx.dtypes[tdt]) for a in (xi, dt, bm, cm)]
    jh0 = jx.np.asarray(h0) if with_h0 else None
    for want_y, want_h in (
            jx.ops.selective_scan(*jin, jx.np.asarray(A), jh0, chunk=chunk,
                                  d_block=dblk, interpret=True),
            jx.ref.selective_scan_ref(*jin, jx.np.asarray(A), jh0)):
        np.testing.assert_allclose(to_np(y), to_np(want_y), atol=tol, rtol=tol)
        np.testing.assert_allclose(to_np(hT), to_np(want_h), atol=tol, rtol=tol)


def test_plain_selective_scan_carries_state(jx):
    """Two halves with the carried state == the whole sequence, and the
    second half matches the Pallas kernel started from the same state."""
    xi, dt, bm, cm, A, _ = (torch.as_tensor(a) for a in scan_inputs(1, 32, 64, 4, seed=9))
    y_full, h_full = ops.selective_scan(xi, dt, bm, cm, A)
    y1, h1 = ops.selective_scan(xi[:, :16], dt[:, :16], bm[:, :16], cm[:, :16], A)
    y2, h2 = ops.selective_scan(xi[:, 16:], dt[:, 16:], bm[:, 16:], cm[:, 16:], A, h1)
    torch.testing.assert_close(y2, y_full[:, 16:], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h2, h_full, atol=1e-5, rtol=1e-5)
    jy2, jh2 = jx.ops.selective_scan(*(jx.np.asarray(a[:, 16:].numpy()) for a in (xi, dt, bm, cm)),
                                     jx.np.asarray(A.numpy()), jx.np.asarray(h1.numpy()),
                                     chunk=8, d_block=32, interpret=True)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), atol=1e-5, rtol=1e-5)


def test_softplus_is_jax_logaddexp_beyond_torch_threshold(jx):
    v = np.array([-50.0, -20.0, -1.0, 0.0, 1.0, 19.0, 20.0, 21.0, 40.0], np.float32)
    got = ref.softplus(torch.as_tensor(v)).numpy()
    want = np.asarray(jx.np.logaddexp(jx.np.asarray(v), 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0.0)


def test_scan_y_dtype_strided_inputs_and_out_state():
    """The model's call: bf16 xi, B, C (B and C column slices of one
    tensor), f32 dt_raw, f32 y asked for, hT written into h0's memory."""
    xi, dt, bm, cm, A, h0 = (torch.as_tensor(a) for a in scan_inputs(2, 5, 16, 4, seed=3))
    dbc = torch.cat([torch.zeros(2, 5, 3), bm, cm], dim=-1).bfloat16()
    b_view, c_view = torch.split(dbc, [3, 4, 4], dim=-1)[1:]
    assert not b_view.is_contiguous()
    want_y, want_h = ref.selective_scan_ref(xi.bfloat16(), dt, b_view.contiguous(),
                                            c_view.contiguous(), A, h0,
                                            y_dtype=torch.float32)
    state = h0.clone()
    y, hT = ops.selective_scan(xi.bfloat16(), dt, b_view, c_view, A, state,
                               y_dtype=torch.float32, out_state=state)
    assert y.dtype == torch.float32 and hT.data_ptr() == state.data_ptr()
    torch.testing.assert_close(y, want_y, atol=0.0, rtol=0.0)
    torch.testing.assert_close(state, want_h, atol=0.0, rtol=0.0)


def test_scan_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    xi, dt, bm, cm, A, h0 = (torch.as_tensor(a) for a in scan_inputs(1, 4, 8, 4, seed=1))
    before = SS.selective_scan.launches
    ops.selective_scan(xi, dt, bm, cm, A, h0)
    assert SS.selective_scan.launches == before
    with pytest.raises(ValueError, match="do not match"):
        ops.selective_scan(xi, dt[..., :4], bm, cm, A)
    with pytest.raises(ValueError, match="Bm"):
        ops.selective_scan(xi, dt, bm[..., :2], cm, A)
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(xi, dt, bm, cm, A, h0[..., :2])
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.selective_scan(*(t.to("meta") for t in (xi, dt, bm, cm, A)))


# --------------------------------------------------------------------------- #
# K6-K8 launches (need the card)
# --------------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES + [(8192, 4096), (3, 100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rmsnorm_kernels_match_plain_on_card(cuda_device, shape, dtype):
    tdt, tol = DTYPES[dtype][0], RMS_TOL[dtype]
    x, r, sc = (torch.as_tensor(a).to(cuda_device) for a in rms_inputs(*shape, seed=sum(shape)))
    x, r = x.to(tdt), r.to(tdt)
    for scale in (sc, sc.bfloat16()):
        before = RN.rmsnorm.launches
        got = ops.rmsnorm(x, scale)
        assert RN.rmsnorm.launches == before + 1
        torch.testing.assert_close(got.float(), RN.plain_rmsnorm(x, scale).float(),
                                   atol=tol, rtol=tol)
        before = RN.rmsnorm_residual.launches
        normed, h = ops.rmsnorm_residual(x, r, scale)
        assert RN.rmsnorm_residual.launches == before + 1
        w_normed, w_h = RN.plain_rmsnorm_residual(x, r, scale)
        torch.testing.assert_close(normed.float(), w_normed.float(), atol=tol, rtol=tol)
        torch.testing.assert_close(h, w_h, atol=0.0, rtol=0.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-zero", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [s[:4] for s in SCAN_SHAPES] + [(1, 1, 64, 4), (3, 17, 200, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_scan_kernel_matches_plain_on_card(cuda_device, shape, dtype, with_h0):
    tdt, tol = DTYPES[dtype]
    xi, dt, bm, cm, A, h0 = (torch.as_tensor(a).to(cuda_device)
                             for a in scan_inputs(*shape, seed=sum(shape)))
    h0 = h0 if with_h0 else None
    ins = [t.to(tdt) for t in (xi, dt, bm, cm)]
    before = SS.selective_scan.launches
    y, hT = ops.selective_scan(*ins, A, h0)
    assert SS.selective_scan.launches == before + 1
    want_y, want_h = SS.plain_selective_scan(*ins, A, h0)
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(hT, want_h, atol=tol, rtol=tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_scan_kernel_strided_views_and_in_place_state_on_card(cuda_device):
    xi, dt, bm, cm, A, h0 = (torch.as_tensor(a).to(cuda_device)
                             for a in scan_inputs(2, 33, 96, 16, seed=2))
    dbc = torch.cat([torch.zeros(2, 33, 6, device=cuda_device), bm, cm], -1).bfloat16()
    b_view, c_view = torch.split(dbc, [6, 16, 16], dim=-1)[1:]
    want_y, want_h = SS.plain_selective_scan(xi.bfloat16(), dt, b_view, c_view, A, h0,
                                             y_dtype=torch.float32)
    state = h0.clone()
    y, _ = ops.selective_scan(xi.bfloat16(), dt, b_view, c_view, A, state,
                              y_dtype=torch.float32, out_state=state)
    torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, want_h, atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="float32"):
        ops.selective_scan(xi, dt, bm, cm, A.double())
    with pytest.raises(ValueError, match="state size"):
        ops.selective_scan(xi, dt, torch.zeros(2, 33, 32, device=cuda_device),
                           torch.zeros(2, 33, 32, device=cuda_device),
                           torch.zeros(96, 32, device=cuda_device))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pallas_ssm_forward_runs_k6_k7_k8_on_card(cuda_device):
    cfg = PC.get_config("falcon-mamba-7b", smoke=True).replace(compute_dtype="float32")
    model = PT.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40)),
                           device=cuda_device)
    batch = {"tokens": toks, "labels": toks}
    before = (RN.rmsnorm.launches, RN.rmsnorm_residual.launches, SS.selective_scan.launches)
    h_k, _ = PT.forward(model, cfg.replace(attn_impl="pallas"), batch)
    after = (RN.rmsnorm.launches, RN.rmsnorm_residual.launches, SS.selective_scan.launches)
    assert [a - b for a, b in zip(after, before)] == [1, cfg.n_layers, cfg.n_layers]
    h_plain, _ = PT.forward(model, cfg, batch)
    torch.testing.assert_close(h_k, h_plain, atol=1e-4, rtol=1e-4)

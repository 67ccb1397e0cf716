"""Port kernels K5-K8 (``repro_torch.kernels``) held against the JAX
package on the same NumPy-seeded inputs.

Pinned tolerances (those of ``tests/test_kernels.py``), absolute and
relative:

  * K5 flash attention: 2e-4 in float32, 2e-2 in bfloat16 -- the bf16
    tolerance also for a CPU emulation of the tensor-core kernel's
    arithmetic (P rounded to bf16 before P V), both for one of the FMA
    kernel's (its tiles, live-tile loop and exp2 softmax);
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

import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch import configs as PC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import selective_scan as SS
from repro_torch.models import layers as PL
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
# The tensor-core kernel (flash_attention_sm90.cu): its arithmetic and route
# --------------------------------------------------------------------------- #

def wgmma_tiles(head_dim):
    """(query rows a CTA, keys a tile) of the tensor-core kernel's
    instantiation for ``head_dim`` (64, 128 or 256)."""
    return (128, 128) if head_dim <= 128 else (128, 80)


#: (B, H, K, S, T, D) around the kernel's 128-row tile, at head dims 64, 128
WGMMA_EDGES = [(1, 4, 2, n, n, d) for n in (127, 128, 129, 255) for d in (64, 128)]
#: ... and at head dim 256 around its 80-key tiles and 64-row halves, MQA
#: as recurrentgemma-9b
WGMMA_D256_EDGES = [(1, 4, 1, n, n, 256)
                    for n in (63, 64, 65, 79, 80, 81, 127, 128, 129, 159, 160, 161, 257)]


def emulate_wgmma_attention(q, k, v, *, causal=True, window=None, scale=None):
    """The tensor-core kernel's arithmetic step for step in plain torch (a
    model for these tests, on no path of the port): bf16 q, k products
    summed in float32; an online softmax in float32 over the key tiles of
    ``wgmma_tiles(D)`` -- only the tiles the masks leave live -- in log2
    units with 2^x; P rounded to bf16 before a float32 P V and before it is
    added into the row sum l; one division by l at the end, rows with no
    live key 0."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    bq, bkv = wgmma_tiles(D)
    c = (scale if scale is not None else 1.0 / math.sqrt(D)) * math.log2(math.e)
    qf = q.bfloat16().float()
    kf, vf = (t.bfloat16().float().repeat_interleave(H // K, dim=1) for t in (k, v))
    out = torch.zeros(B, H, S, D)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(q0 + bq, S))[:, None]
        kv_hi = min(T, q0 + bq, S) if causal else T
        kv_lo = min(T, max(0, q0 - window + 1)) if window is not None else 0
        m = torch.full((B, H, len(rows), 1), -math.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(rows), D)
        for k0 in range(kv_lo // bkv * bkv, kv_hi, bkv):
            cols = torch.arange(k0, min(k0 + bkv, T))[None, :]
            s = qf[:, :, rows[:, 0]] @ kf[:, :, cols[0]].transpose(-1, -2)
            live = torch.ones(len(rows), cols.shape[1], dtype=torch.bool)
            if causal:
                live &= cols <= rows
            if window is not None:
                live &= rows - cols < window
            s = s.masked_fill(~live, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            mu = m_new.masked_fill(m_new == -math.inf, 0.0)
            alpha = torch.exp2(m - mu)
            p = torch.exp2(s * c - mu).bfloat16().float()
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, cols[0]]
            m = m_new
        out[:, :, rows[:, 0]] = torch.where(l == 0, 0.0, acc / l)
    return out.to(q.dtype)


@pytest.mark.parametrize("causal,window", MASKS,
                         ids=["causal", "full", "causal-window64"])
@pytest.mark.parametrize("shape", FA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_rounding_fits_the_bf16_tolerance(jx, shape, causal, window):
    """P rounded to bf16 before P V stays within 2e-2 of the plain version
    and of the Pallas kernel, on the bf16 inputs both are held to."""
    arrays = qkv(shape, seed=sum(shape))
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in arrays)
    got = emulate_wgmma_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = FA.plain_flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-2, rtol=2e-2)
    B, H, K, S, T, D = shape
    if causal and S != T:
        return   # the Pallas kernel's tests leave this layout out too
    jq, jk, jv = (jx.np.asarray(a, jx.np.bfloat16) for a in arrays)
    pallas = jx.ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=_block(S), block_kv=_block(T),
                                    interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(pallas), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("window", [None, 64], ids=["causal", "causal-window64"])
@pytest.mark.parametrize("shape", WGMMA_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_rounding_at_the_tile_edges(jx, shape, window):
    arrays = qkv(shape, seed=sum(shape))
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in arrays)
    got = emulate_wgmma_attention(tq, tk, tv, causal=True, window=window)
    want = FA.plain_flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-2, rtol=2e-2)
    oracle = jx.ref.flash_attention_ref(*(jx.np.asarray(a, jx.np.bfloat16) for a in arrays),
                                        causal=True, window=window)
    np.testing.assert_allclose(to_np(got), to_np(oracle), atol=2e-2, rtol=2e-2)


def _one_block_unless_divisible(n):
    """The Pallas kernel's block along a sequence of n: ``_block(n)`` where
    that is 16 or more, else the whole sequence as one block (interpret mode
    pays per grid step, and a ragged n has no larger divisor)."""
    return _block(n) if _block(n) >= 16 else n


@pytest.mark.parametrize("window", [None, 64, 0],
                         ids=["causal", "causal-window64", "no-live-key"])
@pytest.mark.parametrize("shape", WGMMA_D256_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_d256_tiles_match_the_pallas_kernel(jx, shape, window):
    """The 80-key tiles at head dim 256 (query tiles of 128 rows, each key
    tile visited by both 64-row halves) against the Pallas kernel in
    interpret mode and the plain version, at 2e-2.  Window 0 leaves every
    row with no live key: the plain version and the JAX oracle write it as
    0, and so does the kernel; the Pallas kernel does so only for rows whose
    whole block it skips (inside a live block its -1e30 mask gives such a
    row the mean of V), so that case is held to the oracle."""
    arrays = qkv(shape, seed=sum(shape))
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in arrays)
    got = emulate_wgmma_attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = FA.plain_flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=2e-2, rtol=2e-2)
    B, H, K, S, T, D = shape
    jq, jk, jv = (jx.np.asarray(a, jx.np.bfloat16) for a in arrays)
    if window == 0:
        assert torch.equal(got, torch.zeros_like(got))
        oracle = jx.ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
        np.testing.assert_array_equal(to_np(oracle), to_np(got))
        return
    pallas = jx.ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                    block_q=_one_block_unless_divisible(S),
                                    block_kv=_one_block_unless_divisible(T),
                                    interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(pallas), atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------- #
# The FMA kernel (flash_attention.cu): its arithmetic
# --------------------------------------------------------------------------- #


def fma_tiles(head_dim):
    """(query rows a CTA, keys a tile) of the FMA kernel's instantiation
    for ``head_dim``."""
    return (128, 64) if head_dim <= 128 else (64, 64)


#: (B, H, K, S, T, D) at the FMA kernel's tile edges: S = T one below, at
#: and one above the query tile, and twice it, at head dims 64, 128, 256
FMA_EDGES = [(1, 4, 2, n, n, d) for d in (64, 128, 256)
             for bq in [fma_tiles(d)[0]] for n in (bq - 1, bq, bq + 1, 2 * bq)]


def emulate_fma_attention(q, k, v, *, causal=True, window=None, scale=None):
    """The FMA kernel's arithmetic step for step in plain torch (a model
    for these tests, on no path of the port): q, k, v converted to float32;
    query tiles and key tiles of ``fma_tiles(D)``, visiting only the key
    tiles the masks leave live; scores summed in float32, times
    ``scale * log2(e)`` (one float32 constant) and masked to -1e30; an
    online softmax in log2 units with 2^x; P V in float32; one division by
    l at the end, rows with no live key 0."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    bq, bkv = fma_tiles(D)
    neg = -1e30
    c = (torch.tensor(scale if scale is not None else 1.0 / math.sqrt(D))
         * torch.tensor(math.log2(math.e)))   # float32 times float32, as the host does
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(H // K, dim=1) for t in (k, v))
    out = torch.zeros(B, H, S, D)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(q0 + bq, S))[:, None]
        kv_hi = min(T, q0 + bq, S) if causal else T
        kv_lo = max(0, q0 - window + 1) if window is not None else 0
        m = torch.full((B, H, len(rows), 1), neg)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(rows), D)
        for k0 in range(kv_lo // bkv * bkv, kv_hi, bkv):
            cols = torch.arange(k0, min(k0 + bkv, T))[None, :]
            s = qf[:, :, rows[:, 0]] @ kf[:, :, cols[0]].transpose(-1, -2)
            live = torch.ones(len(rows), cols.shape[1], dtype=torch.bool)
            if causal:
                live &= cols <= rows
            if window is not None:
                live &= rows - cols < window
            t = torch.where(live, s * c, neg)
            m_new = torch.maximum(m, t.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(live, torch.exp2(t - m_new), 0.0)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, cols[0]]
            m = m_new
        out[:, :, rows[:, 0]] = torch.where(l == 0, 0.0, acc / l)
    return out.to(q.dtype)


@pytest.mark.parametrize("causal,window", MASKS,
                         ids=["causal", "full", "causal-window64"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", FA_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fma_kernel_arithmetic_matches_plain_and_pallas(jx, shape, dtype, causal,
                                                       window):
    """The FMA kernel's tiles, live-tile loop and exp2 softmax stay within
    the dtype's tolerance of the plain version and of the Pallas kernel."""
    tdt, tol = DTYPES[dtype]
    arrays = qkv(shape, seed=sum(shape))
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrays)
    got = emulate_fma_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == tq.shape
    want = FA.plain_flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=tol, rtol=tol)
    B, H, K, S, T, D = shape
    if causal and S != T:
        return   # the Pallas kernel's tests leave this layout out too
    jq, jk, jv = (jx.np.asarray(a, jx.dtypes[tdt]) for a in arrays)
    pallas = jx.ops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                    block_q=_block(S), block_kv=_block(T),
                                    interpret=True)
    np.testing.assert_allclose(to_np(got), to_np(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 64], ids=["causal", "causal-window64"])
@pytest.mark.parametrize("shape", FMA_EDGES, ids=lambda s: "x".join(map(str, s)))
def test_fma_kernel_arithmetic_at_the_tile_edges(jx, shape, window):
    arrays = qkv(shape, seed=sum(shape))
    tq, tk, tv = (torch.as_tensor(a) for a in arrays)
    got = emulate_fma_attention(tq, tk, tv, causal=True, window=window)
    want = FA.plain_flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)
    oracle = jx.ref.flash_attention_ref(*(jx.np.asarray(a) for a in arrays),
                                        causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-4, rtol=2e-4)


def test_fma_kernel_arithmetic_zeroes_rows_with_no_live_key_and_takes_any_scale():
    q, k, v = (torch.as_tensor(a) for a in qkv((1, 2, 1, 8, 8, 16), seed=3))
    out = emulate_fma_attention(q, k, v, causal=True, window=0)
    assert torch.equal(out, torch.zeros_like(out))
    for scale in (-0.3, 0.0):   # the route gives these to the FMA kernel
        got = emulate_fma_attention(q, k, v, causal=False, scale=scale)
        want = FA.plain_flash_attention(q, k, v, causal=False, scale=scale)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


ALIGNED = [0x7f0000000000 + 0x100000 * i for i in range(4)]
#: (batch, head, position) strides of q, k, v, out in the model's layout,
#: chatglm3-6b (H 32, K 2, D 128, S 2048), dims of extent 1 left out
MODEL_STRIDES = [2048 * 32 * 128, 128, 32 * 128] * 2 + [2048 * 2 * 128, 128, 2 * 128] * 2


@pytest.mark.parametrize("dtype,head_dim,kv_len,scale,ptrs,strides,want", [
    (torch.bfloat16, 128, 2048, 0.088, ALIGNED, MODEL_STRIDES, "wgmma"),
    (torch.bfloat16, 64, 1, 0.125, ALIGNED, [8, 64 * 8, 64], "wgmma"),
    (torch.float32, 128, 2048, 0.088, ALIGNED, MODEL_STRIDES, "fma"),
    (torch.bfloat16, 80, 2048, 0.1, ALIGNED, MODEL_STRIDES, "fma"),
    (torch.bfloat16, 256, 2048, 0.06, ALIGNED, MODEL_STRIDES, "wgmma"),
    (torch.bfloat16, 256, 2048, 0.06, ALIGNED[:3] + [ALIGNED[3] + 2], MODEL_STRIDES, "fma"),
    (torch.bfloat16, 128, 2048, 0.088, ALIGNED[:3] + [ALIGNED[3] + 2], MODEL_STRIDES, "fma"),
    (torch.bfloat16, 128, 2048, 0.088, ALIGNED, MODEL_STRIDES[:-1] + [129], "fma"),
    (torch.bfloat16, 128, 0, 0.088, ALIGNED, MODEL_STRIDES, "fma"),
    (torch.bfloat16, 128, 2048, -0.088, ALIGNED, MODEL_STRIDES, "fma"),
], ids=["bf16-d128-model", "bf16-d64", "f32", "d80", "d256", "d256-base-off-by-2-bytes",
        "base-off-by-2-bytes",
        "odd-stride", "no-keys", "negative-scale"])
def test_route_picks_the_tensor_cores_only_where_they_apply(dtype, head_dim, kv_len,
                                                            scale, ptrs, strides, want):
    assert FA._route(dtype, head_dim, kv_len, scale, ptrs, strides) == want


def test_route_never_picks_the_plain_version():
    routes = {FA._route(dtype, d, t, sc, [ALIGNED[0] + off] * 4, [st] * 12)
              for dtype in (torch.float32, torch.bfloat16, torch.float16)
              for d in (1, 16, 64, 100, 128, 256) for t in (0, 1, 300)
              for sc in (-1.0, 0.0, 0.1) for off in (0, 2, 8, 16) for st in (1, 8, 64, 130)}
    assert routes == {"wgmma", "fma"}


def test_tma_strides_leave_out_dims_of_extent_one():
    q = torch.zeros(1, 4, 1, 128).bfloat16()
    k = torch.zeros(2, 1, 9, 128).bfloat16().transpose(1, 2).contiguous().transpose(1, 2)
    assert FA._tma_strides(q, k) == [128, 9 * 128, 128]


class _FakeLib:
    """Stands in for the built kernel library: records which entry point
    the wrapper called and returns success."""

    def __init__(self):
        self.calls = []

    def repro_flash_attention_sm90(self, *args):
        self.calls.append(("wgmma", args))
        return 0

    def repro_flash_attention(self, *args):
        self.calls.append(("fma", args))
        return 0


@pytest.mark.parametrize("dtype,D,want", [(torch.bfloat16, 128, "wgmma"),
                                          (torch.bfloat16, 64, "wgmma"),
                                          (torch.bfloat16, 256, "wgmma"),
                                          (torch.bfloat16, 32, "fma"),
                                          (torch.float32, 128, "fma")])
def test_wrapper_launches_the_routed_kernel_and_counts_it(monkeypatch, dtype, D, want):
    """The dispatch of a CUDA call, with the card and the library stood in
    for: the routed entry point is called once, with the strides and no
    dtype code for the tensor-core kernel, and its own counter moves."""
    from repro_torch.core import _build

    fake = _FakeLib()
    monkeypatch.setattr(FA, "_on_kernel", lambda q, k, v: True)
    monkeypatch.setattr(_build, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 7})())
    q, k, v = (torch.as_tensor(a).to(dtype) for a in qkv((2, 4, 2, 16, 16, D), seed=6))
    FA.reset_launch_counts()
    FA.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, window=8)
    assert [name for name, _ in fake.calls] == [want]
    args = fake.calls[0][1]
    assert args[4:10] == (2, 4, 2, 16, 16, D) and args[-1] == 7
    assert len(args) == (27 if want == "wgmma" else 28)
    assert FA.flash_attention.launches == 1
    assert (FA.flash_attention.launches_wgmma, FA.flash_attention.launches_fma) == \
        ((1, 0) if want == "wgmma" else (0, 1))
    FA.reset_launch_counts()


# --------------------------------------------------------------------------- #
# Kernel launches (need the card)
# --------------------------------------------------------------------------- #


CARD_SHAPES = FA_SHAPES + [(2, 32, 2, 129, 129, 128), (1, 4, 4, 1, 1, 64),
                           (1, 4, 2, 255, 255, 128), (1, 4, 2, 256, 256, 64),
                           (1, 4, 2, 257, 257, 128), (1, 4, 2, 257, 257, 256),
                           (2, 8, 2, 129, 129, 80)]
#: ... and the FMA kernel's tile edges: its query tiles (FMA_EDGES, which
#: at head dim 256 are its 64-key tiles' too) and its 64-key tiles below
CARD_SHAPES += [sh for sh in FMA_EDGES + [(1, 4, 2, 63, 63, 128), (1, 4, 2, 65, 65, 64)]
                if sh not in CARD_SHAPES]
#: ... and the tensor-core kernel's 80-key tiles at head dim 256
CARD_SHAPES += [sh for sh in WGMMA_D256_EDGES + [(2, 8, 1, 191, 191, 256),
                                                 (1, 4, 2, 193, 193, 256)]
                if sh not in CARD_SHAPES]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled with nvcc for "
                    "sm_90a and have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    tdt, tol = DTYPES[dtype]
    q, k, v = (torch.as_tensor(a).to(cuda_device, tdt)
               for a in qkv(shape, seed=sum(shape)))
    # bf16 at head dim 64 / 128 / 256 takes the tensor-core kernel, the rest FMA
    counter = ("launches_wgmma" if tdt == torch.bfloat16 and shape[-1] in FA.WGMMA_HEAD_DIMS
               else "launches_fma")
    for causal, window in MASKS:
        before = FA.flash_attention.launches
        kernel_before = getattr(FA.flash_attention, counter)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert FA.flash_attention.launches == before + 1
        assert getattr(FA.flash_attention, counter) == kernel_before + 1
        want = FA.plain_flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 2, 255, 255, 128), (2, 8, 2, 129, 129, 64),
                                   (1, 4, 1, 129, 129, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_one_element_off_alignment_takes_the_fma_kernel_on_card(cuda_device, shape):
    """bf16 tensors whose bases lie one element past a 16-byte boundary,
    which TMA cannot address, launch the FMA kernel and match the plain
    version at 2e-2."""
    def on_card(a):
        flat = torch.zeros(a.size + 1, device=cuda_device, dtype=torch.bfloat16)
        flat[1:] = torch.as_tensor(a.ravel()).to(cuda_device, torch.bfloat16)
        return flat[1:].view(a.shape)

    q, k, v = (on_card(a) for a in qkv(shape, seed=sum(shape)))
    for causal, window in MASKS:
        FA.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        assert (FA.flash_attention.launches_wgmma, FA.flash_attention.launches_fma) == (0, 1)
        want = FA.plain_flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    FA.reset_launch_counts()


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


@pytest.mark.cuda
def test_bf16_chatglm_shaped_forward_runs_k5_on_the_tensor_cores_on_card(cuda_device):
    """chatglm3-6b's head dim (128) and GQA in bf16 compute: every K5
    launch takes the tensor-core kernel, and the hidden state stays as
    close to the plain attention's as bf16 allows (phase 7's limit)."""
    cfg = PC.get_config("chatglm3-6b", smoke=True).replace(head_dim=128)
    assert cfg.compute_dtype == "bfloat16"
    model = PT.init_model(cfg, torch.Generator(cuda_device).manual_seed(0),
                          device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 300)),
                           device=cuda_device)
    batch = {"tokens": toks, "labels": toks}
    FA.reset_launch_counts()
    h_k5, _ = PT.forward(model, cfg.replace(attn_impl="pallas"), batch)
    assert FA.flash_attention.launches_wgmma == cfg.n_layers
    assert FA.flash_attention.launches_fma == 0
    h_plain, _ = PT.forward(model, cfg, batch)
    h_f32, _ = PT.forward(model, cfg.replace(compute_dtype="float32"), batch)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    assert rel(h_k5, h_plain) <= max(2e-2, 1.5 * rel(h_plain, h_f32))
    FA.reset_launch_counts()


#: (B, S) of the qwen1.5-4b cells' prefills: the 32k request and chat's three
CACHED_PREFILL_SHAPES = [(1, 32768), (32, 128), (16, 256), (8, 512)]
#: max over rows of max |K5 route - plain path| / the plain row's std
#: (``perfbench/check.py``'s measure) of one attention layer's output.  It
#: read 0.0236 at 1 x 32 768 and 0.0303-0.0305 at chat's three shapes on an
#: H100 80GB HBM3 (700 W); the bound leaves 3.3 x room above the highest
CACHED_PREFILL_BOUND = 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", CACHED_PREFILL_SHAPES, ids=lambda n: str(n))
def test_cached_prefill_on_k5_holds_to_the_plain_chunked_path_on_card(cuda_device, B, S):
    """One qwen1.5-4b attention layer (MHA 20 x 128, QKV bias, rope, bf16,
    q-chunks of 1 024) in a cached prefill at the benchmark cells' shapes:
    under ``attn_impl="pallas"`` K5 on the tensor cores over the bf16 cache
    rows just written, against ``attn_impl="xla"``'s plain q-chunked path
    over the same cache.  The caches are written alike, bit for bit."""
    cfg = PC.get_config("qwen1.5-4b").replace(param_dtype="bfloat16", rope_theta=5e6)
    gen = torch.Generator(cuda_device).manual_seed(B * S)
    params = PL.attn_init(cfg, gen, cuda_device)
    params.update({n: torch.randn(p.shape, generator=gen, device=cuda_device).to(p.dtype)
                   for n, p in params.items() if n.startswith("b")})
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=cuda_device).bfloat16()
    pos = torch.arange(S, device=cuda_device).expand(B, S)
    rope = PT._rope_for(cfg, pos)
    out, caches = {}, {}
    for impl in ("pallas", "xla"):
        cache = {n: torch.zeros((B, S, cfg.n_kv_heads, cfg.head_dim_), dtype=torch.bfloat16,
                                device=cuda_device) for n in ("k", "v")}
        FA.reset_launch_counts()
        with torch.inference_mode():
            out[impl], caches[impl] = PL.attn_apply(
                params, cfg.replace(attn_impl=impl), x, rope=rope,
                mask=PL.MaskSpec(causal=True), q_pos=pos, k_pos=pos, cache=cache,
                cache_index=0)
        assert FA.flash_attention.launches_wgmma == (impl == "pallas")
        assert FA.flash_attention.launches_fma == 0
    torch.cuda.synchronize()
    for n in ("k", "v"):
        assert torch.equal(caches["pallas"][n], caches["xla"][n]), n
    got, want = out["pallas"].float(), out["xla"].float()
    err = float(((got - want).abs().amax(dim=-1) / want.std(dim=-1)).max())
    print(f"cached prefill B {B} S {S}: K5 against the plain path {err:.4f} "
          f"(bound {CACHED_PREFILL_BOUND})")
    assert err <= CACHED_PREFILL_BOUND
    FA.reset_launch_counts()


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
@pytest.mark.parametrize("shape", [s[:4] for s in SCAN_SHAPES] + [
    (1, 1, 64, 4), (3, 17, 200, 16),
    # N not a multiple of the 4 lanes of a channel; Din not one of the 64
    # channels of a CTA
    (2, 37, 100, 5), (1, 70, 130, 1), (1, 33, 64, 13)],
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

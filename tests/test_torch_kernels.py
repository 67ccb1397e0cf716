"""Port kernel K5 (``repro_torch.kernels``) held against the JAX package on
the same NumPy-seeded inputs.

Pinned tolerances (those of ``tests/test_kernels.py``): 2e-4 in float32 and
2e-2 in bfloat16, absolute and relative, for

  * the port's ``ops.flash_attention`` on CPU tensors -- the plain version
    -- against the JAX package's Pallas kernel in interpret mode (as the
    JAX package's own tests run it on the CPU) and against its
    ``flash_attention_ref``;
  * the kernel against the plain version on the card (``cuda``-marked
    tests, which skip here with the reason).

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
        pytest.skip("needs a CUDA card: K5 is compiled with nvcc for sm_90a "
                    "and has no CPU mode")
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

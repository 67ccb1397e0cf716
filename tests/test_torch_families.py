"""The port's MoE, hybrid, audio and VLM families held against the JAX
package on the same weights and NumPy-seeded inputs.

Weights come from ``repro.models.transformer.init_model`` and go across
through ``repro_torch.carry.model_from_jax``; tokens, frames and patches
are drawn with NumPy from a seed.  Configs: the ``moe``, ``hybrid``,
``audio`` and ``vlm`` configs of ``tests/test_models.py`` and the registry
``SMOKE`` configs of qwen2-moe-a2.7b, grok-1-314b, recurrentgemma-9b,
whisper-medium and paligemma-3b, all at float32 compute unless a test says
otherwise.  grok-1-314b (1.27 TB of float32 weights) and deepseek-67b do
not fit one card at full width: their smoke configs are all they run.

Pinned tolerances (max abs error):
  * forward hidden states, the MoE aux loss and ``loss_fn``: 1e-5;
  * ``attn_impl="pallas"`` on both sides (the JAX kernel in interpret mode,
    the port's K5 plain version): 1e-4;
  * prefill + decode logits against the JAX package's, and decode against
    the forward: 1e-4 relative to the largest logit;
  * bfloat16 compute: 2e-2 relative to the largest magnitude;
  * every MoE ``impl`` (gmm, dense, capacity) against the JAX package's
    same ``impl``: 1e-5;
  * the engine's token streams: identical to the JAX engine's.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro.models.config import Family as JFamily
from repro.models.config import HybridConfig as JHybridConfig
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.serving import engine as JE

from repro_torch import carry
from repro_torch import configs as PC
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.config import Family, HybridConfig, ModelConfig, MoEConfig
from repro_torch.serving import engine as PE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(1)
HIDDEN_TOL = 1e-5
PALLAS_TOL = 1e-4
DECODE_RTOL = 1e-4
BF16_RTOL = 2e-2

#: tests/test_models.py's configs of these families, as plain fields
TEST_CONFIGS = {
    "moe": dict(name="moe", family="moe", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab_size=64, remat="none",
                compute_dtype="float32",
                moe=dict(n_experts=4, top_k=2, d_ff_expert=48, n_shared_experts=2,
                         d_ff_shared=16)),
    "hybrid": dict(name="hyb", family="hybrid", n_layers=5, d_model=32, n_heads=4,
                   n_kv_heads=1, d_ff=64, vocab_size=64, remat="none", attn_window=6,
                   compute_dtype="float32", hybrid=dict(lru_width=32)),
    "audio": dict(name="aud", family="audio", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=4, d_ff=64, vocab_size=64, remat="none", rope_style="none",
                  norm="layernorm", mlp="gelu", compute_dtype="float32",
                  n_encoder_layers=2, encoder_seq_len=8, decoder_pos_len=32),
    "vlm": dict(name="vlm", family="vlm", n_layers=2, d_model=32, n_heads=4,
                n_kv_heads=1, d_ff=64, vocab_size=64, remat="none",
                compute_dtype="float32", n_vision_tokens=4, tie_embeddings=True),
}
SMOKE_ARCHS = ("qwen2-moe-a2.7b", "grok-1-314b", "recurrentgemma-9b", "whisper-medium",
               "paligemma-3b")
CONFIGS = tuple(TEST_CONFIGS) + tuple(f"{a}/smoke" for a in SMOKE_ARCHS)
#: one registry smoke config a family, for the slower tests
FAMILY_SMOKES = ("qwen2-moe-a2.7b/smoke", "recurrentgemma-9b/smoke",
                 "whisper-medium/smoke", "paligemma-3b/smoke")


def both_cfgs(name, **kw):
    """(JAX config, port config) of a ``CONFIGS`` name, replaced by ``kw``."""
    if name in TEST_CONFIGS:
        f = TEST_CONFIGS[name]
        j = dict(f, family=JFamily(f["family"]))
        p = dict(f, family=Family(f["family"]))
        if "moe" in f:
            j["moe"], p["moe"] = JMoEConfig(**f["moe"]), MoEConfig(**f["moe"])
        if "hybrid" in f:
            j["hybrid"], p["hybrid"] = JHybridConfig(**f["hybrid"]), HybridConfig(**f["hybrid"])
        jcfg, pcfg = JModelConfig(**j), ModelConfig(**p)
    else:
        arch = name.split("/")[0]
        jcfg = JC.get_config(arch, smoke=True).replace(compute_dtype="float32")
        pcfg = PC.get_config(arch, smoke=True).replace(compute_dtype="float32")
    return jcfg.replace(**kw), pcfg.replace(**kw)


class Pair:
    """One config's weights on both sides."""

    def __init__(self, name, **kw):
        self.jcfg, self.pcfg = both_cfgs(name, **kw)
        self.params, _ = JT.init_model(KEY, self.jcfg)
        self.model = carry.model_from_jax(
            self.pcfg, jax.tree.map(np.asarray, self.params), device="cpu")

    def moe_impl(self, impl, **kw):
        """The same weights under another MoE dispatch."""
        return (self.jcfg.replace(moe=dataclasses.replace(self.jcfg.moe, impl=impl, **kw)),
                self.pcfg.replace(moe=dataclasses.replace(self.pcfg.moe, impl=impl, **kw)))


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    return Pair(request.param)


_PAIRS = {}


def family_pair(name):
    """A module-wide cache of the ``FAMILY_SMOKES`` pairs."""
    if name not in _PAIRS:
        _PAIRS[name] = Pair(name)
    return _PAIRS[name]


def make_batch(cfg, B, S, seed):
    """NumPy-seeded tokens (and frames / patches) as (JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    arrays = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}   # next tokens
    if cfg.family == Family.AUDIO:
        arrays["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.family == Family.VLM:
        arrays["patches"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
          for k, v in arrays.items()}
    tb = {k: torch.as_tensor(v) for k, v in arrays.items()}
    return jb, tb


def without_labels(batch, S=None):
    """The batch's prompt: tokens cut to their first S, frames / patches whole."""
    out = {k: v for k, v in batch.items() if k != "labels"}
    if S is not None:
        out["tokens"] = out["tokens"][:, :S]
    return out


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def rel_err(got, want):
    want = np.asarray(want, np.float32)
    return max_err(got, want) / (float(np.max(np.abs(want))) + 1e-6)


def k5_per_forward(cfg):
    """K5 calls of one forward under ``attn_impl="pallas"``: every layer of
    a MoE stack, each hybrid group's local attention, each decoder
    self-attention of the audio family, and none for the VLM (its prefix
    turns the kernel off, as in the JAX package)."""
    if cfg.family == Family.HYBRID:
        return PT.hybrid_layout(cfg)[0]
    if cfg.family == Family.VLM:
        return 0
    return cfg.n_layers


# --------------------------------------------------------------------------- #
# Forward and loss
# --------------------------------------------------------------------------- #


def test_published_widths():
    counts = {"qwen2-moe-a2.7b": 1.442e10, "recurrentgemma-9b": 8.63e9,
              "whisper-medium": 8.11e8, "paligemma-3b": 2.51e9}
    for arch, n in counts.items():
        assert abs(PC.get_config(arch).param_counts()[0] - n) < 0.01 * n, arch
    hyb = PC.get_config("recurrentgemma-9b")
    assert PT.hybrid_layout(hyb) == (12, 2) and hyb.head_dim_ == 256
    moe = PC.get_config("qwen2-moe-a2.7b").moe
    assert (moe.n_experts, moe.top_k, moe.n_shared_experts, moe.impl) == (60, 4, 4, "gmm")


def test_forward_matches_jax(pair):
    jb, tb = make_batch(pair.pcfg, 2, 12, seed=2)
    hj, auxj = JT.forward(pair.params, pair.jcfg, jb)
    ht, auxt = PT.forward(pair.model, pair.pcfg, tb)
    assert ht.shape == hj.shape and ht.dtype == torch.float32
    assert max_err(ht, hj) < HIDDEN_TOL
    assert abs(float(auxt) - float(auxj)) < HIDDEN_TOL
    assert (float(auxt) > 0) == (pair.pcfg.family == Family.MOE)


def test_loss_matches_jax(pair):
    jb, tb = make_batch(pair.pcfg, 2, 16, seed=4)
    lj, mj = JT.loss_fn(pair.params, pair.jcfg, jb)
    lt, mt = PT.loss_fn(pair.model, pair.pcfg, tb)
    assert abs(float(lt) - float(lj)) < HIDDEN_TOL
    for key in ("loss", "aux_loss"):
        assert abs(float(mt[key]) - float(mj[key])) < HIDDEN_TOL, key
    assert float(mt["accuracy"]) == float(mj["accuracy"])


def test_pallas_forward_matches_jax_in_interpret_mode(pair, monkeypatch):
    """K5 where the JAX package runs its Pallas kernel, and as often."""
    jb, tb = make_batch(pair.pcfg, 2, 32, seed=3)
    jcfg, pcfg = pair.jcfg.replace(attn_impl="pallas"), pair.pcfg.replace(attn_impl="pallas")
    calls = []
    real = FA.plain_flash_attention
    monkeypatch.setattr(FA, "plain_flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ht, _ = PT.forward(pair.model, pcfg, tb)
    assert len(calls) == k5_per_forward(pcfg)
    hj, _ = JT.forward(pair.params, jcfg, jb)
    assert max_err(ht, hj) < PALLAS_TOL
    if pcfg.attn_logit_softcap is None:   # the kernel ignores the cap (R5)
        h_plain, _ = PT.forward(pair.model, pair.pcfg, tb)
        assert max_err(ht, h_plain) < PALLAS_TOL


@pytest.mark.parametrize("name", FAMILY_SMOKES + ("grok-1-314b/smoke",))
def test_bf16_compute_matches_jax(name):
    p = Pair(name, compute_dtype="bfloat16")
    jb, tb = make_batch(p.pcfg, 2, 16, seed=6)
    hj, _ = JT.forward(p.params, p.jcfg, jb)
    ht, _ = PT.forward(p.model, p.pcfg, tb)
    assert ht.dtype == torch.bfloat16
    assert rel_err(ht.float(), np.asarray(hj, np.float32)) < BF16_RTOL
    lj, _ = JT.loss_fn(p.params, p.jcfg, jb)
    lt, _ = PT.loss_fn(p.model, p.pcfg, tb)
    assert abs(float(lt) - float(lj)) < BF16_RTOL * abs(float(lj))


# --------------------------------------------------------------------------- #
# MoE dispatch
# --------------------------------------------------------------------------- #


MOE_CASES = [(name, impl, {}) for name in ("moe", "qwen2-moe-a2.7b/smoke", "grok-1-314b/smoke")
             for impl in ("gmm", "dense", "capacity")]
#: a capacity factor no routing can overflow (C = T k), and one that drops
#: rows past each expert's capacity
NO_DROPS = {"capacity_factor": 64.0}
MOE_CASES += [("moe", "capacity", NO_DROPS), ("qwen2-moe-a2.7b/smoke", "capacity", NO_DROPS),
              ("moe", "capacity", {"capacity_factor": 0.5}),
              ("qwen2-moe-a2.7b/smoke", "capacity", {"capacity_factor": 0.5})]


@pytest.mark.parametrize("name,impl,kw", MOE_CASES, ids=[
    f"{n}-{i}" + (f"-cf{kw['capacity_factor']}" if kw else "") for n, i, kw in MOE_CASES])
def test_moe_impl_matches_jax(name, impl, kw):
    p = Pair(name)
    jcfg, pcfg = p.moe_impl(impl, **kw)
    jb, tb = make_batch(pcfg, 2, 12, seed=9)
    hj, auxj = JT.forward(p.params, jcfg, jb)
    ht, auxt = PT.forward(p.model, pcfg, tb)
    assert max_err(ht, hj) < HIDDEN_TOL
    assert abs(float(auxt) - float(auxj)) < HIDDEN_TOL
    gmm, _ = PT.forward(p.model, p.pcfg, tb)
    if impl != "capacity" or kw == NO_DROPS:   # every row computed, as gmm does
        assert max_err(ht, gmm) < HIDDEN_TOL
    elif kw:   # capacity 0.5: rows are dropped
        assert max_err(ht, gmm) > HIDDEN_TOL


def test_moe_gmm_skips_the_experts_without_rows():
    """One token reaches top_k of the experts; gmm runs only those and
    agrees with the dense dispatch, which runs them all."""
    cfg = PC.get_config("qwen2-moe-a2.7b", smoke=True).replace(compute_dtype="float32")
    model = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y, aux = PL.moe_apply(model.layers[0].moe, cfg, x)
    assert y.shape == x.shape and torch.isfinite(y).all() and float(aux) > 0
    # the same token through the dense dispatch
    dense = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="dense"))
    y_dense, _ = PL.moe_apply(model.layers[0].moe, dense, x)
    assert max_err(y, y_dense) < HIDDEN_TOL


# --------------------------------------------------------------------------- #
# Prefill and decode
# --------------------------------------------------------------------------- #


def _jax_prefill_decode(pair, jb, S, index):
    cache, _ = JT.init_cache(pair.jcfg, jb["tokens"].shape[0], S)
    cache, _ = JT.prefill(pair.params, pair.jcfg, without_labels(jb, S - 1), cache)
    return JT.decode_step(pair.params, pair.jcfg, cache, jb["tokens"][:, S - 1:], index)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-index", "row-index"])
def test_prefill_decode_matches_jax_and_forward(pair, per_row):
    """S 12 exceeds the hybrid's windows (6, 8): its prefill writes the last
    W positions into the ring and the decode step attends over it."""
    B, S = 2, 12
    jb, tb = make_batch(pair.pcfg, B, S, seed=7)
    j_index = jnp.full((B,), S - 1, jnp.int32) if per_row else jnp.int32(S - 1)
    t_index = torch.full((B,), S - 1) if per_row else S - 1
    _, want = _jax_prefill_decode(pair, jb, S, j_index)

    cache = PT.init_cache(pair.pcfg, B, S, device="cpu")
    cache, last = PT.prefill(pair.model, pair.pcfg, without_labels(tb, S - 1), cache)
    cache, got = PT.decode_step(pair.model, pair.pcfg, cache, tb["tokens"][:, S - 1:],
                                t_index)
    assert got.shape == (B, 1, pair.pcfg.vocab_size)
    assert rel_err(got, want) < DECODE_RTOL

    hidden, _ = PT.forward(pair.model, pair.pcfg, tb)
    full = PL.unembed_apply(pair.model.embed, pair.pcfg, hidden)
    assert rel_err(got[:, 0], full[:, -1]) < DECODE_RTOL
    assert rel_err(last[:, 0], full[:, -2]) < DECODE_RTOL


def _flat(cache, prefix=""):
    for k, v in cache.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_pallas_prefill_matches_the_plain_prefill_and_jax(pair, monkeypatch):
    """A prefill under ``attn_impl="pallas"``: K5 once in each cached causal
    self-attention of the MoE stack and the audio decoder (none where a
    softcap, the VLM's prefix or the hybrid's ring write keeps the route
    as it was: the hybrid attends x itself, as in a forward); its last-token
    logits and every cache tensor equal the plain prefill's and the JAX
    package's."""
    B, S = 2, 11
    jb, tb = make_batch(pair.pcfg, B, S, seed=14)
    jcache, _ = JT.init_cache(pair.jcfg, B, S + 3)
    jcache, want = JT.prefill(pair.params, pair.jcfg, without_labels(jb), jcache)
    pcfg = pair.pcfg.replace(attn_impl="pallas")
    calls = []
    real = FA.plain_flash_attention
    monkeypatch.setattr(FA, "plain_flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cache, got = PT.prefill(pair.model, pcfg, without_labels(tb),
                            PT.init_cache(pcfg, B, S + 3, device="cpu"))
    assert len(calls) == (0 if pcfg.attn_logit_softcap else k5_per_forward(pcfg))
    plain_cache, plain = PT.prefill(pair.model, pair.pcfg, without_labels(tb),
                                    PT.init_cache(pair.pcfg, B, S + 3, device="cpu"))
    assert max_err(got, plain) < PALLAS_TOL and max_err(got, want) < PALLAS_TOL
    want_cache, plain_cache = dict(_flat(jcache)), dict(_flat(plain_cache))
    for key, t in _flat(cache):
        assert max_err(t, plain_cache[key]) < PALLAS_TOL, key
        assert max_err(t, want_cache[key]) < PALLAS_TOL, key


@pytest.mark.parametrize("name", ("hybrid", "recurrentgemma-9b/smoke", "audio",
                                  "whisper-medium/smoke", "vlm", "paligemma-3b/smoke"))
def test_prefill_fills_the_cache_as_jax_does(name):
    """Every cache tensor after a prefill: the hybrid's ring slots and
    recurrent states, the audio family's self and cross k/v, the VLM's
    prefix and text slots -- shaped and filled as the JAX package's."""
    p = family_pair(name) if name in FAMILY_SMOKES else Pair(name)
    B, S = 2, 11
    jb, tb = make_batch(p.pcfg, B, S, seed=13)
    jcache, _ = JT.init_cache(p.jcfg, B, S + 3)
    jcache, _ = JT.prefill(p.params, p.jcfg, without_labels(jb), jcache)
    tcache = PT.init_cache(p.pcfg, B, S + 3, device="cpu")
    tcache, _ = PT.prefill(p.model, p.pcfg, without_labels(tb), tcache)
    want = dict(_flat(jcache))
    got = dict(_flat(tcache))
    assert sorted(got) == sorted(want)
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape, key
        assert max_err(t, want[key]) < HIDDEN_TOL, key


@pytest.mark.parametrize("name", ("hybrid", "recurrentgemma-9b/smoke"))
def test_hybrid_token_by_token_decode_wraps_the_ring(name):
    """Decode from an empty cache past the window: the ring wraps, and until
    it is full the unwritten slots are attended as positions below 0 (the
    JAX package's behaviour, as ROADMAP.md R6 for the dense ring)."""
    p = family_pair(name) if name in FAMILY_SMOKES else Pair(name)
    B, S = 2, 2 * p.pcfg.attn_window + 3
    jb, tb = make_batch(p.pcfg, B, S, seed=8)
    jcache, _ = JT.init_cache(p.jcfg, B, S)
    tcache = PT.init_cache(p.pcfg, B, S, device="cpu")
    assert tcache["groups"]["att"]["k"].shape[2] == p.pcfg.attn_window
    j_decode = jax.jit(JT.decode_step, static_argnums=1)
    for i in range(S):
        jcache, jl = j_decode(p.params, p.jcfg, jcache, jb["tokens"][:, i:i + 1],
                              jnp.full((B,), i, jnp.int32))
        tcache, tl = PT.decode_step(p.model, p.pcfg, tcache, tb["tokens"][:, i:i + 1],
                                    torch.full((B,), i))
        assert rel_err(tl, jl) < DECODE_RTOL, i
    for key, t in _flat(tcache):
        assert max_err(t, dict(_flat(jcache))[key]) < HIDDEN_TOL, key


@pytest.mark.parametrize("name", ("audio", "whisper-medium/smoke"))
def test_decode_leaves_the_whisper_cross_cache_unwritten(name):
    p = family_pair(name) if name in FAMILY_SMOKES else Pair(name)
    B, S = 2, 6
    jb, tb = make_batch(p.pcfg, B, S, seed=10)
    cache = PT.init_cache(p.pcfg, B, S + 4, device="cpu")
    cache, _ = PT.prefill(p.model, p.pcfg, without_labels(tb), cache)
    cross = {k: v.clone() for k, v in cache["cross"].items()}
    assert float(cross["k"].abs().max()) > 0
    for i in range(4):
        cache, _ = PT.decode_step(p.model, p.pcfg, cache, tb["tokens"][:, :1], S + i)
    for k in ("k", "v"):
        assert torch.equal(cache["cross"][k], cross[k])
    # the cross k/v are the encoder's, projected without bias or rope
    enc = PT.encode(p.model, p.pcfg, tb["frames"])
    wk = p.model.dec_layers[1].cross["wk"]
    want = torch.einsum("bsd,dhk->bshk", enc, wk)
    assert max_err(cache["cross"]["k"][1], want) < HIDDEN_TOL
    j_enc = JT.encode(p.params, p.jcfg, jb["frames"])
    assert max_err(enc, j_enc) < HIDDEN_TOL


def test_row_index_past_the_decoder_position_table_gives_nan_as_jax_does():
    """Per-row decode indices at and past ``decoder_pos_len``: the JAX
    package's ``jnp.take`` fills those rows of the table with NaN (its
    default out-of-bounds mode), so their logits are NaN; the rows inside
    the table decode as usual."""
    n = 4
    p = Pair("audio", decoder_pos_len=n)
    B, S, P = 3, 8, 2
    jb, tb = make_batch(p.pcfg, B, S, seed=3)
    index = np.array([n - 1, n, n + 2])
    jcache, _ = JT.init_cache(p.jcfg, B, S)
    jcache, _ = JT.prefill(p.params, p.jcfg, without_labels(jb, P), jcache)
    _, want = JT.decode_step(p.params, p.jcfg, jcache, jb["tokens"][:, P:P + 1],
                             jnp.asarray(index, jnp.int32))
    want = np.asarray(want)
    assert np.isfinite(want[0]).all() and np.isnan(want[1:]).all()

    tcache = PT.init_cache(p.pcfg, B, S, device="cpu")
    tcache, _ = PT.prefill(p.model, p.pcfg, without_labels(tb, P), tcache)
    _, got = PT.decode_step(p.model, p.pcfg, tcache, tb["tokens"][:, P:P + 1],
                            torch.as_tensor(index))
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert rel_err(got[0], want[0]) < DECODE_RTOL


# --------------------------------------------------------------------------- #
# Serving engine
# --------------------------------------------------------------------------- #


def _requests(mod, prompts, new_tokens):
    return [mod.Request(rid=i, prompt=list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]


def _staggered(engine, reqs):
    engine.submit(reqs[0])
    engine.step()                       # r0 in flight before the others
    for r in reqs[1:]:
        engine.submit(r)
    engine.run_to_completion()
    return [r.generated for r in reqs]


PROMPTS = [[1, 2, 3], [4, 5], [], [7, 8, 9, 10], [11]]
NEW_TOKENS = [5, 4, 3, 3, 6]


@pytest.mark.parametrize("name", FAMILY_SMOKES)
def test_engine_streams_match_the_jax_engine(name):
    """The same streams token for token, R7 (the hybrid's idle slots
    advance their recurrent state) and R8 (the cross cache and the vision
    prefix stay empty) included."""
    p = family_pair(name)
    j_eng = JE.BatchedEngine(p.params, p.jcfg, slots=3, max_len=32)
    j_out = _staggered(j_eng, _requests(JE, PROMPTS, NEW_TOKENS))
    t_eng = PE.BatchedEngine(p.model, p.pcfg, slots=3, max_len=32, device="cpu")
    t_out = _staggered(t_eng, _requests(PE, PROMPTS, NEW_TOKENS))
    assert t_out == j_out
    assert [len(g) for g in t_out] == NEW_TOKENS


def _solo(pair, prompt, n, slots=1):
    eng = PE.BatchedEngine(pair.model, pair.pcfg, slots=slots, max_len=32, device="cpu")
    req = PE.Request(rid=0, prompt=list(prompt), max_new_tokens=n)
    eng.submit(req)
    eng.run_to_completion()
    return req.generated


@pytest.mark.parametrize("name", ("qwen2-moe-a2.7b/smoke", "whisper-medium/smoke",
                                  "paligemma-3b/smoke"))
def test_engine_staggered_admissions_match_solo(name):
    """gmm routing is per token and a KV slot's dummy writes are
    overwritten, so batching changes no stream of these families."""
    p = family_pair(name)
    prompts, new_tokens = PROMPTS[:2] + PROMPTS[3:4], [5, 5, 3]
    solo = [_solo(p, pr, n, slots=3) for pr, n in zip(prompts, new_tokens)]
    eng = PE.BatchedEngine(p.model, p.pcfg, slots=3, max_len=32, device="cpu")
    assert _staggered(eng, _requests(PE, prompts, new_tokens)) == solo


def _greedy_decode(pair, prompt, n, max_len):
    """Greedy tokens through ``decode_step`` alone, the prompt token by token
    from an empty cache of ``max_len``: what a one-slot engine computes."""
    cache = PT.init_cache(pair.pcfg, 1, max_len, device="cpu")
    toks = list(prompt) or [0]
    for i, t in enumerate(toks):
        cache, logits = PT.decode_step(pair.model, pair.pcfg, cache,
                                       torch.tensor([[t]]), i)
    out = [int(logits[0, -1].argmax())]
    for i in range(n - 1):
        cache, logits = PT.decode_step(pair.model, pair.pcfg, cache,
                                       torch.tensor([[out[-1]]]), len(toks) + i)
        out.append(int(logits[0, -1].argmax()))
    return out


@pytest.mark.parametrize("name", ("hybrid", "recurrentgemma-9b/smoke"))
def test_hybrid_one_slot_engine_matches_greedy_decode(name):
    """One slot has no idle neighbour (R7), so its streams are greedy decode;
    a reused slot starts from the last request's recurrent state."""
    p = family_pair(name) if name in FAMILY_SMOKES else Pair(name)
    for prompt, n in zip(PROMPTS[:2], NEW_TOKENS[:2]):
        assert _solo(p, prompt, n) == _greedy_decode(p, prompt, n, max_len=32)
    eng = PE.BatchedEngine(p.model, p.pcfg, slots=1, max_len=32, device="cpu")
    first, second = _requests(PE, PROMPTS[:2], NEW_TOKENS[:2])
    eng.submit(first)
    eng.run_to_completion()
    assert float(eng.cache["groups"]["rec"]["lru"].abs().max()) > 0
    j_eng = JE.BatchedEngine(p.params, p.jcfg, slots=1, max_len=32)
    j_first, j_second = _requests(JE, PROMPTS[:2], NEW_TOKENS[:2])
    j_eng.submit(j_first)
    j_eng.run_to_completion()
    eng.submit(second)
    eng.run_to_completion()
    j_eng.submit(j_second)
    j_eng.run_to_completion()
    assert second.generated == j_second.generated


@pytest.mark.parametrize("name", ("whisper-medium/smoke", "paligemma-3b/smoke"))
def test_engine_never_fills_the_cross_cache_or_the_prefix(name):
    """ROADMAP.md R8: the engine's cache is written by decode_step alone."""
    p = family_pair(name)
    eng = PE.BatchedEngine(p.model, p.pcfg, slots=2, max_len=16, device="cpu")
    eng.submit(PE.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
    eng.run_to_completion()
    if p.pcfg.family == Family.AUDIO:
        assert float(eng.cache["cross"]["k"].abs().max()) == 0.0
        assert float(eng.cache["self"]["k"].abs().max()) > 0
    else:
        P = p.pcfg.n_vision_tokens
        assert eng.cache["k"].shape[2] == 16 + P
        assert float(eng.cache["k"][:, :, :P].abs().max()) == 0.0
        assert float(eng.cache["k"][:, :, P:].abs().max()) > 0


@pytest.mark.parametrize("name", FAMILY_SMOKES)
def test_engine_never_reaches_the_flash_attention_kernel(name, monkeypatch):
    p = family_pair(name)
    pcfg = p.pcfg.replace(attn_impl="pallas")
    seen = []
    real = FA.plain_flash_attention
    monkeypatch.setattr(FA, "plain_flash_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    eng = PE.BatchedEngine(p.model, pcfg, slots=2, max_len=16, device="cpu")
    eng.submit(PE.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    eng.run_to_completion()
    assert seen == []


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "recurrentgemma-9b", "whisper-medium",
                                  "paligemma-3b"))
def test_serve_launcher_serves_the_family_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--requests", "3", "--new-tokens", "2",
         "--slots", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "served 3 requests" in out.stdout


# --------------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------------- #


def _leaves(tree, prefix=""):
    """(path, array) of a JAX tree, the stacked leaves split per layer the
    way the port keeps them."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _port_leaf(tree, path):
    """The port's tensor at a "/"-separated path (``"attn/wq"``) of a
    ``ParamTree``."""
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


@pytest.mark.parametrize("name", ("moe", "hybrid", "audio", "vlm"))
def test_model_carries_the_jax_parameter_layout(name):
    p = Pair(name)
    cfg = p.pcfg
    stacks = {"layers": 1, "tail": 1, "enc_layers": 1, "dec_layers": 1}
    n_copied = 0
    for path, a in _leaves(p.params):
        top, _, rest = path.partition("/")
        if top == "groups":
            branch, _, leaf = rest.partition("/")
            for g in range(a.shape[0]):
                group = p.model.groups[g]
                if branch == "rec":
                    for j in range(2):
                        got = _port_leaf(group.rec[j], leaf).numpy()
                        np.testing.assert_array_equal(got, a[g, j], path)
                        n_copied += 1
                else:
                    np.testing.assert_array_equal(_port_leaf(group.att, leaf).numpy(),
                                                  a[g], path)
                    n_copied += 1
        elif top in stacks:
            for i in range(a.shape[0]):
                np.testing.assert_array_equal(_port_leaf(p.model[top][i], rest).numpy(),
                                              a[i], path)
                n_copied += 1
        else:
            np.testing.assert_array_equal(_port_leaf(p.model, path).numpy(), a, path)
            n_copied += 1
    assert n_copied == sum(1 for _ in p.model.parameters())
    fresh = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert (sorted((n, tuple(t.shape)) for n, t in fresh.named_parameters())
            == sorted((n, tuple(t.shape)) for n, t in p.model.named_parameters()))


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "recurrentgemma-9b", "whisper-medium",
                                  "paligemma-3b"))
def test_init_draws_the_jax_package_scales(arch):
    """Each leaf's spread as the JAX package draws it: N(0, 1/leading dim)
    unless the package names a scale, ones and zeros where it fills."""
    cfg = PC.get_config(arch, smoke=True)
    model = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    d = cfg.d_model

    def std(t):
        return float(t.float().std())

    assert abs(std(model.embed["tok"]) - 1) < 0.05
    if cfg.family == Family.MOE:
        moe = model.layers[0].moe
        E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        assert moe["w_gate"].shape == (E, d, f)
        assert abs(std(moe["w_gate"]) * E ** 0.5 - 1) < 0.05
        assert abs(std(moe["w_down"]) * f ** 0.5 - 1) < 0.05
        assert abs(std(moe["router"]) * d ** 0.5 - 1) < 0.1
        assert moe["shared"]["w_gate"].shape == (d, cfg.moe.d_ff_shared
                                                 * cfg.moe.n_shared_experts)
    elif cfg.family == Family.HYBRID:
        rec = model.groups[0].rec[1].rec
        w = cfg.hybrid.lru_width
        assert rec["gate_a"].shape == (8, w // 8, w // 8)
        assert abs(std(rec["gate_a"]) * 8 ** 0.5 - 1) < 0.05
        assert abs(std(rec["conv_w"]) / 0.1 - 1) < 0.2
        assert float((rec["lambda"] - 2.0).abs().max()) == 0.0
        assert float(rec["conv_b"].abs().max()) == 0.0
        assert len(model.tail) == 2
    elif cfg.family == Family.AUDIO:
        assert model.enc_pos.shape == (cfg.encoder_seq_len, d)
        assert abs(std(model.dec_pos) / 0.02 - 1) < 0.05
        assert float(model.enc_norm["bias"].abs().max()) == 0.0
        assert float(model.dec_layers[0].mlp["b_up"].abs().max()) == 0.0
        assert len(model.enc_layers) == cfg.n_encoder_layers
    else:
        assert "unembed" not in model.embed
        assert abs(std(model.layers[0].mlp["w_gate"]) * d ** 0.5 - 1) < 0.05


def test_model_checks_its_stacks():
    cfg = PC.get_config("recurrentgemma-9b", smoke=True)
    model = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = {"embed": dict(model.embed.items()), "final_norm": dict(model.final_norm.items()),
              "groups": []}
    with pytest.raises(ValueError, match="has 1 groups, got 0"):
        PT.Model(cfg, params)

"""The port's dense and SSM model stacks and serving engine held against
the JAX package on the same weights and NumPy-seeded tokens (the MoE,
hybrid, audio and VLM families: ``tests/test_torch_families.py``).

Weights come from ``repro.models.transformer.init_model`` and go across
through ``repro_torch.carry.model_from_jax``.  Configs: the dense ones of
``tests/test_models.py`` (``dense``, ``dense-qk-bias-halfrope``), chatglm3's
``SMOKE`` and a sliding-window config; the ``ssm`` config of
``tests/test_models.py`` and falcon-mamba's ``SMOKE``; all at float32
compute unless a test says otherwise.

Pinned tolerances (max abs error):
  * forward hidden states and ``loss_fn``: 1e-5 (the same float32 math;
    the sums run in another order) -- for the SSM family under both
    ``attn_impl`` settings, since the JAX package's SSM stack has no kernel
    path and its outputs are the reference for both;
  * ``attn_impl="pallas"`` on both sides (the JAX kernel in interpret mode,
    the port's K5 plain version): 1e-4, the pin of
    ``tests/test_models.py::test_pallas_attention_equivalence``;
  * prefill + decode logits against the JAX package's, and decode against
    the forward, 1e-4 relative to the largest logit
    (``tests/test_models.py::test_decode_matches_forward``);
  * bfloat16 compute: 2e-2 relative to the largest magnitude;
  * the engine's token streams: identical.
"""

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
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro.serving import engine as JE

from repro_torch import carry
from repro_torch import configs as PC
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.config import Family, ModelConfig, SSMConfig
from repro_torch.serving import engine as PE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(1)
HIDDEN_TOL = 1e-5
PALLAS_TOL = 1e-4
DECODE_RTOL = 1e-4
BF16_RTOL = 2e-2


def _dense(**kw):
    base = dict(name="dense", family="dense", n_layers=3, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                remat="none", compute_dtype="float32")
    base.update(kw)
    return base


def _chatglm_smoke():
    fields = {f: getattr(JC.get_config("chatglm3-6b", smoke=True), f)
              for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                        "d_ff", "vocab_size", "rope_style", "qkv_bias", "mlp",
                        "norm", "logits_chunk", "attn_q_chunk", "remat")}
    return dict(fields, family="dense", compute_dtype="float32")


CONFIGS = {
    "dense": _dense(),
    "dense-qk-bias-halfrope": _dense(name="dq", qk_norm=True, qkv_bias=True,
                                     rope_style="half"),
    "chatglm3-smoke": _chatglm_smoke(),
    "sliding-window": _dense(name="swa", attn_window=6, mlp="geglu"),
}


def both_cfgs(fields):
    jfields = dict(fields, family=JFamily(fields["family"]))
    pfields = dict(fields, family=Family(fields["family"]))
    if "ssm" in fields:
        jfields["ssm"], pfields["ssm"] = (JSSMConfig(**fields["ssm"]),
                                          SSMConfig(**fields["ssm"]))
    return JModelConfig(**jfields), ModelConfig(**pfields)


class Pair:
    """One config's weights on both sides."""

    def __init__(self, fields):
        self.jcfg, self.pcfg = both_cfgs(fields)
        self.params, _ = JT.init_model(KEY, self.jcfg)
        self.model = carry.model_from_jax(
            self.pcfg, jax.tree.map(np.asarray, self.params), device="cpu")


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    return Pair(CONFIGS[request.param])


def tokens(B, S, vocab, seed=2):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    return ({"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(toks, jnp.int32)},
            {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)})


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def rel_err(got, want):
    want = np.asarray(want, np.float32)
    return max_err(got, want) / (float(np.max(np.abs(want))) + 1e-6)


# --------------------------------------------------------------------------- #
# Forward and loss
# --------------------------------------------------------------------------- #


def test_config_copy_matches_the_jax_registry():
    assert PC.ARCH_IDS == JC.ARCH_IDS
    for arch in JC.ARCH_IDS:
        for smoke in (False, True):
            j, p = JC.get_config(arch, smoke), PC.get_config(arch, smoke)
            assert repr(j) == repr(p)
            assert j.param_counts() == p.param_counts()
    glm = PC.get_config("chatglm3-6b")
    assert abs(glm.param_counts()[0] - 6.24e9) < 0.01e9


def test_forward_matches_jax(pair):
    jb, tb = tokens(2, 12, pair.jcfg.vocab_size)
    hj, auxj = JT.forward(pair.params, pair.jcfg, jb)
    ht, auxt = PT.forward(pair.model, pair.pcfg, tb)
    assert ht.shape == hj.shape and ht.dtype == torch.float32
    assert max_err(ht, hj) < HIDDEN_TOL
    assert float(auxt) == float(auxj) == 0.0


def test_pallas_forward_matches_jax_in_interpret_mode(pair):
    jb, tb = tokens(2, 32, pair.jcfg.vocab_size, seed=3)
    jcfg, pcfg = pair.jcfg.replace(attn_impl="pallas"), pair.pcfg.replace(attn_impl="pallas")
    hj, _ = JT.forward(pair.params, jcfg, jb)
    ht, _ = PT.forward(pair.model, pcfg, tb)
    assert max_err(ht, hj) < PALLAS_TOL
    h_plain, _ = PT.forward(pair.model, pair.pcfg, tb)
    assert max_err(ht, h_plain) < PALLAS_TOL


def test_loss_matches_jax(pair):
    jb, tb = tokens(2, 16, pair.jcfg.vocab_size, seed=4)
    lj, mj = JT.loss_fn(pair.params, pair.jcfg, jb)
    lt, mt = PT.loss_fn(pair.model, pair.pcfg, tb)
    assert abs(float(lt) - float(lj)) < HIDDEN_TOL
    assert abs(float(mt["loss"]) - float(mj["loss"])) < HIDDEN_TOL
    assert float(mt["accuracy"]) == float(mj["accuracy"])


@pytest.mark.parametrize("variant", [dict(attn_q_chunk=4), dict(logits_chunk=4)],
                         ids=["attn_q_chunk", "logits_chunk"])
def test_chunked_variants_match_jax(variant):
    p = Pair(CONFIGS["dense-qk-bias-halfrope"])
    jcfg, pcfg = p.jcfg.replace(**variant), p.pcfg.replace(**variant)
    jb, tb = tokens(2, 16, jcfg.vocab_size, seed=5)
    lj, _ = JT.loss_fn(p.params, jcfg, jb)
    lt, _ = PT.loss_fn(p.model, pcfg, tb)
    assert abs(float(lt) - float(lj)) < HIDDEN_TOL
    hj, _ = JT.forward(p.params, jcfg, jb)
    ht, _ = PT.forward(p.model, pcfg, tb)
    assert max_err(ht, hj) < HIDDEN_TOL
    # and the chunked port equals the unchunked port
    l_plain, _ = PT.loss_fn(p.model, p.pcfg, tb)
    assert abs(float(lt) - float(l_plain)) < HIDDEN_TOL


def test_bf16_compute_matches_jax():
    p = Pair(dict(CONFIGS["chatglm3-smoke"], compute_dtype="bfloat16"))
    jb, tb = tokens(2, 16, p.jcfg.vocab_size, seed=6)
    hj, _ = JT.forward(p.params, p.jcfg, jb)
    ht, _ = PT.forward(p.model, p.pcfg, tb)
    assert ht.dtype == torch.bfloat16
    assert rel_err(ht.float(), np.asarray(hj, np.float32)) < BF16_RTOL
    lj, _ = JT.loss_fn(p.params, p.jcfg, jb)
    lt, _ = PT.loss_fn(p.model, p.pcfg, tb)
    assert abs(float(lt) - float(lj)) < BF16_RTOL * abs(float(lj))


# --------------------------------------------------------------------------- #
# Prefill and decode
# --------------------------------------------------------------------------- #


def _jax_prefill_decode(pair, jb, S, index):
    cache, _ = JT.init_cache(pair.jcfg, jb["tokens"].shape[0], S)
    cache, _ = JT.prefill(pair.params, pair.jcfg, {"tokens": jb["tokens"][:, :S - 1]}, cache)
    return JT.decode_step(pair.params, pair.jcfg, cache, jb["tokens"][:, S - 1:], index)[1]


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar-index", "row-index"])
def test_prefill_decode_matches_jax_and_forward(pair, per_row):
    B = 2
    S = 6 if pair.pcfg.attn_window else 12   # the JAX prefill fits the window
    jb, tb = tokens(B, S, pair.jcfg.vocab_size, seed=7)
    j_index = jnp.full((B,), S - 1, jnp.int32) if per_row else jnp.int32(S - 1)
    t_index = torch.full((B,), S - 1) if per_row else S - 1
    want = _jax_prefill_decode(pair, jb, S, j_index)

    cache = PT.init_cache(pair.pcfg, B, S, device="cpu")
    cache, last = PT.prefill(pair.model, pair.pcfg, {"tokens": tb["tokens"][:, :S - 1]}, cache)
    cache, got = PT.decode_step(pair.model, pair.pcfg, cache, tb["tokens"][:, S - 1:], t_index)
    assert got.shape == (B, 1, pair.pcfg.vocab_size)
    assert rel_err(got, want) < DECODE_RTOL

    hidden, _ = PT.forward(pair.model, pair.pcfg, tb)
    full = PL.unembed_apply(pair.model.embed, pair.pcfg, hidden)
    assert rel_err(got[:, 0], full[:, -1]) < DECODE_RTOL
    assert rel_err(last[:, 0], full[:, -2]) < DECODE_RTOL


@pytest.mark.parametrize("extra", [0, 3], ids=["cache-fits", "cache-longer"])
def test_pallas_prefill_runs_k5_over_the_cache_and_matches_plain_and_jax(pair, extra,
                                                                         monkeypatch):
    """Under ``attn_impl="pallas"`` a cached prefill runs K5 once a layer over
    the rows it has just written (a window config's prompt fills its
    window-long cache); its last-token logits and every cache tensor equal
    the plain prefill's and the JAX package's prefill's."""
    B = 2
    S = pair.pcfg.attn_window or 12
    jb, tb = tokens(B, S, pair.jcfg.vocab_size, seed=9)
    jcache, _ = JT.init_cache(pair.jcfg, B, S + extra)
    jcache, want = JT.prefill(pair.params, pair.jcfg, {"tokens": jb["tokens"]}, jcache)
    pcfg = pair.pcfg.replace(attn_impl="pallas")
    calls = []
    real = FA.plain_flash_attention
    monkeypatch.setattr(FA, "plain_flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cache, got = PT.prefill(pair.model, pcfg, {"tokens": tb["tokens"]},
                            PT.init_cache(pcfg, B, S + extra, device="cpu"))
    assert len(calls) == pcfg.n_layers
    plain_cache, plain = PT.prefill(pair.model, pair.pcfg, {"tokens": tb["tokens"]},
                                    PT.init_cache(pair.pcfg, B, S + extra, device="cpu"))
    assert len(calls) == pcfg.n_layers   # none in the plain prefill
    assert max_err(got, plain) < PALLAS_TOL and max_err(got, want) < PALLAS_TOL
    for name in ("k", "v"):
        assert cache[name].shape == plain_cache[name].shape == jcache[name].shape
        assert max_err(cache[name], plain_cache[name]) < PALLAS_TOL, name
        assert max_err(cache[name], jcache[name]) < PALLAS_TOL, name


def test_token_by_token_decode_wraps_the_window_ring_buffer():
    """Sliding window 6 over 14 positions: the cache is a 6-slot ring.

    Until the ring is full, the JAX package's decode reads the unwritten
    slots as positions below 0 and leaves them unmasked (they hold zero
    keys and values), so a decode from an empty cache does not equal the
    forward; the port reproduces that step for step."""
    p = Pair(CONFIGS["sliding-window"])
    B, S = 2, 14
    jb, tb = tokens(B, S, p.jcfg.vocab_size, seed=8)
    jcache, _ = JT.init_cache(p.jcfg, B, S)
    tcache = PT.init_cache(p.pcfg, B, S, device="cpu")
    assert tcache["k"].shape[2] == 6
    j_decode = jax.jit(JT.decode_step, static_argnums=1)
    for i in range(S):
        jcache, jl = j_decode(p.params, p.jcfg, jcache, jb["tokens"][:, i:i + 1],
                              jnp.full((B,), i, jnp.int32))
        tcache, tl = PT.decode_step(p.model, p.pcfg, tcache, tb["tokens"][:, i:i + 1],
                                    torch.full((B,), i))
        assert rel_err(tl, jl) < DECODE_RTOL, i


# --------------------------------------------------------------------------- #
# Serving engine
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def glm():
    return Pair(CONFIGS["chatglm3-smoke"])


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


def test_engine_streams_match_the_jax_engine(glm):
    prompts = [[1, 2, 3], [4, 5], [], [7, 8, 9, 10], [11]]
    new_tokens = [5, 4, 3, 3, 6]
    j_out = _staggered(JE.BatchedEngine(glm.params, glm.jcfg, slots=3, max_len=32),
                       _requests(JE, prompts, new_tokens))
    t_out = _staggered(PE.BatchedEngine(glm.model, glm.pcfg, slots=3, max_len=32,
                                        device="cpu"),
                       _requests(PE, prompts, new_tokens))
    assert t_out == j_out
    assert [len(g) for g in t_out] == new_tokens


def _solo(glm, prompt, n):
    eng = PE.BatchedEngine(glm.model, glm.pcfg, slots=1, max_len=32, device="cpu")
    req = PE.Request(rid=0, prompt=list(prompt), max_new_tokens=n)
    eng.submit(req)
    eng.run_to_completion()
    return req.generated


def test_engine_pads_an_empty_prompt(glm):
    eng = PE.BatchedEngine(glm.model, glm.pcfg, slots=2, max_len=32, device="cpu")
    req = PE.Request(rid=0, prompt=[], max_new_tokens=3)
    eng.submit(req)
    eng.run_to_completion()
    assert len(req.generated) == 3
    assert req.generated == _solo(glm, [0], 3)


def test_engine_staggered_admissions_match_solo(glm):
    prompts, new_tokens = [[1, 2, 3], [4, 5], [7, 8, 9, 10]], [5, 5, 3]
    solo = [_solo(glm, p, n) for p, n in zip(prompts, new_tokens)]
    eng = PE.BatchedEngine(glm.model, glm.pcfg, slots=3, max_len=32, device="cpu")
    assert _staggered(eng, _requests(PE, prompts, new_tokens)) == solo


def test_engine_reuses_a_slot_after_completion(glm):
    solo = _solo(glm, [11, 12], 4)
    eng = PE.BatchedEngine(glm.model, glm.pcfg, slots=1, max_len=32, device="cpu")
    first = PE.Request(rid=0, prompt=[3, 1, 4], max_new_tokens=3)
    eng.submit(first)
    eng.run_to_completion()
    second = PE.Request(rid=1, prompt=[11, 12], max_new_tokens=4)
    eng.submit(second)
    eng.run_to_completion()
    assert second.generated == solo


def test_engine_never_reaches_the_flash_attention_kernel(glm, monkeypatch):
    """The engine prefills token by token through decode_step (cached
    attention), as the JAX engine does: K5 is for full-sequence forwards."""
    pcfg = glm.pcfg.replace(attn_impl="pallas")
    seen = []
    real = FA.plain_flash_attention
    monkeypatch.setattr(FA, "plain_flash_attention",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    eng = PE.BatchedEngine(glm.model, pcfg, slots=2, max_len=16, device="cpu")
    eng.submit(PE.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    eng.run_to_completion()
    assert seen == []
    PT.forward(glm.model, pcfg, tokens(1, 4, pcfg.vocab_size)[1])
    assert seen == [1] * pcfg.n_layers   # the forward: once per layer


def test_serve_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "chatglm3-6b",
         "--smoke", "--device", "cpu", "--requests", "3", "--new-tokens", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "served 3 requests" in out.stdout
    moe = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-moe-a2.7b", "--smoke", "--device", "cpu", "--requests", "3",
         "--new-tokens", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert moe.returncode == 0, moe.stdout + moe.stderr
    assert "served 3 requests" in moe.stdout


# --------------------------------------------------------------------------- #
# Devices and families
# --------------------------------------------------------------------------- #


def test_entry_points_need_a_card_unless_asked_for_the_cpu(glm):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_model(glm.pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_cache(glm.pcfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.BatchedEngine(glm.model, glm.pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        carry.model_from_jax(glm.pcfg, jax.tree.map(np.asarray, glm.params))
    model = PT.init_model(glm.pcfg, torch.Generator().manual_seed(0), device="cpu")
    assert model.device.type == "cpu"
    # param_counts leaves the final norm out
    assert sum(p.numel() for p in model.parameters()) == \
        int(glm.pcfg.param_counts()[0]) + glm.pcfg.d_model


def test_init_draws_the_jax_package_scales():
    cfg = PC.get_config("chatglm3-6b", smoke=True)
    model = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = model.layers[0]
    d, q_dim = cfg.d_model, cfg.q_dim
    assert blk.attn["wq"].shape == (d, cfg.n_heads, cfg.head_dim_)
    assert blk.attn["wo"].shape == (cfg.n_heads, cfg.head_dim_, d)
    assert blk.mlp["w_gate"].shape == (d, cfg.d_ff)
    assert abs(float(blk.mlp["w_gate"].std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(blk.attn["wo"].std()) * q_dim ** 0.5 - 1) < 0.05
    assert abs(float(model.embed["tok"].std()) - 1) < 0.05
    assert float(blk.attn["bq"].abs().max()) == 0.0


# --------------------------------------------------------------------------- #
# The SSM family (falcon-mamba)
# --------------------------------------------------------------------------- #


def _ssm_fields(name, **kw):
    """``tests/test_models.py``'s ``ssm`` config, or a registry SMOKE
    config, as plain fields (the SSM sub-config as a dict)."""
    if name == "falcon-mamba-smoke":
        j = JC.get_config("falcon-mamba-7b", smoke=True)
        fields = {f: getattr(j, f) for f in ("name", "n_layers", "d_model", "n_heads",
                                              "n_kv_heads", "d_ff", "vocab_size",
                                              "rope_style", "logits_chunk", "remat")}
        fields["ssm"] = dict(state_dim=j.ssm.state_dim, conv_width=j.ssm.conv_width,
                             expand=j.ssm.expand)
    else:
        fields = dict(name="ssm", n_layers=2, d_model=32, n_heads=1, n_kv_heads=1,
                      d_ff=0, vocab_size=64, remat="none", rope_style="none",
                      ssm=dict(state_dim=4))
    fields.update(family="ssm", compute_dtype="float32")
    fields.update(kw)
    return fields


SSM_CONFIGS = ("ssm", "falcon-mamba-smoke")
IMPLS = ("xla", "pallas")


@pytest.fixture(scope="module", params=SSM_CONFIGS)
def ssm_pair(request):
    return Pair(_ssm_fields(request.param))


@pytest.fixture(scope="module")
def mamba():
    return Pair(_ssm_fields("falcon-mamba-smoke"))


def test_falcon_mamba_config_is_the_published_width():
    cfg = PC.get_config("falcon-mamba-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim,
            cfg.ssm.conv_width, cfg.vocab_size) == (64, 4096, 8192, 16, 4, 65024)
    assert abs(cfg.param_counts()[0] - 7.27e9) < 0.01e9


def test_ssm_model_carries_the_jax_parameter_layout(mamba):
    jlayer = jax.tree.map(lambda a: a[0], mamba.params["layers"])
    blk = mamba.model.layers[0]
    for name, leaf in jlayer["mamba"].items():
        np.testing.assert_array_equal(blk.mamba[name].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(blk.ln["scale"].numpy(), np.asarray(jlayer["ln"]["scale"]))
    fresh = PT.init_model(mamba.pcfg, torch.Generator().manual_seed(0), device="cpu")
    for name, t in fresh.layers[0].mamba.items():
        assert t.shape == blk.mamba[name].shape, name
    torch.testing.assert_close(fresh.layers[0].mamba["A_log"], blk.mamba["A_log"])
    dt = torch.nn.functional.softplus(fresh.layers[0].mamba["dt_bias"])
    assert 1e-3 <= float(dt.min()) and float(dt.max()) <= 0.101


@pytest.mark.parametrize("impl", IMPLS)
def test_ssm_forward_matches_jax(ssm_pair, impl):
    jb, tb = tokens(2, 12, ssm_pair.jcfg.vocab_size)
    hj, auxj = JT.forward(ssm_pair.params, ssm_pair.jcfg, jb)
    ht, auxt = PT.forward(ssm_pair.model, ssm_pair.pcfg.replace(attn_impl=impl), tb)
    assert ht.shape == hj.shape and ht.dtype == torch.float32
    assert max_err(ht, hj) < HIDDEN_TOL
    assert float(auxt) == float(auxj) == 0.0


@pytest.mark.parametrize("impl", IMPLS)
def test_ssm_loss_matches_jax(ssm_pair, impl):
    jb, tb = tokens(2, 16, ssm_pair.jcfg.vocab_size, seed=4)
    lj, mj = JT.loss_fn(ssm_pair.params, ssm_pair.jcfg, jb)
    lt, mt = PT.loss_fn(ssm_pair.model, ssm_pair.pcfg.replace(attn_impl=impl), tb)
    assert abs(float(lt) - float(lj)) < HIDDEN_TOL
    assert float(mt["accuracy"]) == float(mj["accuracy"])


@pytest.mark.parametrize("impl", IMPLS)
def test_ssm_prefill_decode_matches_jax_and_forward(ssm_pair, impl):
    B, S = 2, 12
    pcfg = ssm_pair.pcfg.replace(attn_impl=impl)
    jb, tb = tokens(B, S, ssm_pair.jcfg.vocab_size, seed=7)
    want = _jax_prefill_decode(ssm_pair, jb, S, jnp.int32(S - 1))
    cache = PT.init_cache(pcfg, B, S, device="cpu")
    assert cache["conv"].dtype == torch.float32 and cache["ssm"].dtype == torch.float32
    cache, last = PT.prefill(ssm_pair.model, pcfg, {"tokens": tb["tokens"][:, :S - 1]}, cache)
    cache, got = PT.decode_step(ssm_pair.model, pcfg, cache, tb["tokens"][:, S - 1:], S - 1)
    assert got.shape == (B, 1, pcfg.vocab_size)
    assert rel_err(got, want) < DECODE_RTOL
    hidden, _ = PT.forward(ssm_pair.model, pcfg, tb)
    full = PL.unembed_apply(ssm_pair.model.embed, pcfg, hidden)
    assert rel_err(got[:, 0], full[:, -1]) < DECODE_RTOL
    assert rel_err(last[:, 0], full[:, -2]) < DECODE_RTOL


@pytest.mark.parametrize("impl", IMPLS)
def test_ssm_prefill_continues_from_the_cached_state(mamba, impl):
    """A second prefill starts from the states the first left, as the JAX
    package's does: two prefills == one over the joined prompt."""
    B, S = 2, 10
    pcfg = mamba.pcfg.replace(attn_impl=impl)
    jb, tb = tokens(B, S, pcfg.vocab_size, seed=12)
    jcache, _ = JT.init_cache(mamba.jcfg, B, S)
    jcache, _ = JT.prefill(mamba.params, mamba.jcfg, {"tokens": jb["tokens"][:, :6]}, jcache)
    jcache, want = JT.prefill(mamba.params, mamba.jcfg, {"tokens": jb["tokens"][:, 6:]}, jcache)
    cache = PT.init_cache(pcfg, B, S, device="cpu")
    cache, _ = PT.prefill(mamba.model, pcfg, {"tokens": tb["tokens"][:, :6]}, cache)
    cache, got = PT.prefill(mamba.model, pcfg, {"tokens": tb["tokens"][:, 6:]}, cache)
    assert rel_err(got, want) < DECODE_RTOL
    for key in ("conv", "ssm"):
        assert max_err(cache[key], jcache[key]) < HIDDEN_TOL
    whole = PT.prefill(mamba.model, pcfg, {"tokens": tb["tokens"]},
                       PT.init_cache(pcfg, B, S, device="cpu"))[1]
    assert rel_err(got, whole) < DECODE_RTOL


@pytest.mark.parametrize("impl", IMPLS)
def test_ssm_bf16_compute_matches_jax(impl):
    p = Pair(_ssm_fields("falcon-mamba-smoke", compute_dtype="bfloat16"))
    pcfg = p.pcfg.replace(attn_impl=impl)
    jb, tb = tokens(2, 16, p.jcfg.vocab_size, seed=6)
    hj, _ = JT.forward(p.params, p.jcfg, jb)
    ht, _ = PT.forward(p.model, pcfg, tb)
    assert ht.dtype == torch.bfloat16
    assert rel_err(ht.float(), np.asarray(hj, np.float32)) < BF16_RTOL
    lj, _ = JT.loss_fn(p.params, p.jcfg, jb)
    lt, _ = PT.loss_fn(p.model, pcfg, tb)
    assert abs(float(lt) - float(lj)) < BF16_RTOL * abs(float(lj))


@pytest.fixture(scope="module")
def jax_mamba_engine_streams(mamba):
    prompts = [[1, 2, 3], [4, 5], [], [7, 8, 9, 10], [11]]
    new_tokens = [5, 4, 3, 3, 6]
    out = _staggered(JE.BatchedEngine(mamba.params, mamba.jcfg, slots=3, max_len=32),
                     _requests(JE, prompts, new_tokens))
    return prompts, new_tokens, out


@pytest.mark.parametrize("impl", IMPLS)
def test_ssm_engine_streams_match_the_jax_engine(mamba, jax_mamba_engine_streams, impl):
    prompts, new_tokens, j_out = jax_mamba_engine_streams
    eng = PE.BatchedEngine(mamba.model, mamba.pcfg.replace(attn_impl=impl), slots=3,
                           max_len=32, device="cpu")
    t_out = _staggered(eng, _requests(PE, prompts, new_tokens))
    assert t_out == j_out
    assert [len(g) for g in t_out] == new_tokens


def test_ssm_engine_reproduces_the_jax_engine_state_sharing(mamba, jax_mamba_engine_streams):
    """ROADMAP.md R7: the JAX engine decodes a dummy token in every idle
    slot and never resets a slot's state, so SSM streams served together
    differ from the same requests served alone -- in both packages alike."""
    prompts, new_tokens, j_out = jax_mamba_engine_streams
    solo = [_solo(mamba, p, n) for p, n in zip(prompts, new_tokens)]
    assert solo != j_out
    j_solo = []
    for p, n in zip(prompts[:2], new_tokens[:2]):
        eng = JE.BatchedEngine(mamba.params, mamba.jcfg, slots=1, max_len=32)
        req = JE.Request(rid=0, prompt=list(p), max_new_tokens=n)
        eng.submit(req)
        eng.run_to_completion()
        j_solo.append(req.generated)
    assert j_solo == solo[:2]
    # the first request alone in its slot until the others arrive: its
    # first tokens agree, later ones drift on the shared dummy decodes
    assert j_out[0][:2] == solo[0][:2]


def _count_kernel_calls(monkeypatch):
    counts = {"rmsnorm": 0, "rmsnorm_residual": 0, "selective_scan": 0}
    for name in counts:
        real = getattr(kops, name)

        def counted(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kops, name, counted)
    return counts


@pytest.mark.parametrize("n_layers", [2, 5])
def test_ssm_kernel_calls_per_forward_and_decode_step(monkeypatch, n_layers):
    """At full depth a forward and a decode step each make 1 K6, 64 K7 and
    64 K8 calls: 1, L and L at depth L; the plain setting makes none."""
    cfg = PC.get_config("falcon-mamba-7b", smoke=True).replace(
        n_layers=n_layers, compute_dtype="float32")
    model = PT.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    counts = _count_kernel_calls(monkeypatch)
    tb = tokens(2, 6, cfg.vocab_size)[1]
    PT.forward(model, cfg, tb)
    assert counts == {"rmsnorm": 0, "rmsnorm_residual": 0, "selective_scan": 0}
    k = cfg.replace(attn_impl="pallas")
    want = {"rmsnorm": 1, "rmsnorm_residual": n_layers, "selective_scan": n_layers}
    PT.forward(model, k, tb)
    assert counts == want
    cache = PT.init_cache(k, 2, 8, device="cpu")
    counts.update(dict.fromkeys(counts, 0))
    PT.decode_step(model, k, cache, tb["tokens"][:, :1], 0)
    assert counts == want


def test_serve_launcher_serves_falcon_mamba_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "falcon-mamba-7b",
         "--smoke", "--device", "cpu", "--requests", "3", "--new-tokens", "2",
         "--slots", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "served 3 requests" in out.stdout

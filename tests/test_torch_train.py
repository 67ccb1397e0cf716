"""The port's AdamW and train step against the JAX package's, on the CPU.

Inputs are seeded with NumPy; the JAX package's ``init_model`` weights are
carried across by ``carry.model_from_jax``.  Tolerances:

* ``schedule``, ``global_norm`` and ``update`` (with and without
  ``compress_grads``) on the same float32 inputs: 1e-6 relative (the same
  float32 operations; the sums over leaves run in another order);
* gradients of ``loss_fn`` per leaf: 1e-5 of the leaf's largest (the
  smoke configs at float32 compute; measured about 1e-6);
* two ``make_train_step`` steps (dense, SSM, MoE, audio, hybrid; and ``accum=2``):
  loss, ``grad_norm`` and ``lr`` 1e-5 relative; the parameters 1e-5 of
  each leaf's largest on every element whose first-step gradient is at
  least 1e-2 of its leaf's largest.  Adam divides each element's moment by
  its own magnitude, so an element whose gradient is rounding noise (a key
  bias, whose gradient is 0 in exact arithmetic: it shifts a row's scores
  alike) moves by up to lr a step with a sign the rounding sets, in either
  package; those elements are held to 2 x (lr_1 + lr_2).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.training import step as JS

from repro_torch import carry
from repro_torch import configs as C
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.training import step as S

OPT_RTOL = 1e-6
GRAD_TOL = 1e-5
STEP_RTOL = 1e-5
DETERMINED = 1e-2
B, SEQ = 4, 16
FAMILIES = ("chatglm3-6b", "falcon-mamba-7b", "qwen2-moe-a2.7b", "whisper-medium",
            "recurrentgemma-9b")


def configs(arch):
    return (JC.get_config(arch, smoke=True).replace(compute_dtype="float32"),
            C.get_config(arch, smoke=True).replace(compute_dtype="float32"))


def batches(cfg, n, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, SEQ)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (batch, SEQ)).astype(np.int32)}
        if cfg.family.value == "audio":
            b["frames"] = rng.standard_normal(
                (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def jax_flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def pair(arch, oc=None):
    jcfg, cfg = configs(arch)
    oc = oc or JA.OptimizerConfig()
    toc = A.OptimizerConfig(**dataclasses.asdict(oc))
    jstate, _ = JS.init_state(jax.random.PRNGKey(0), jcfg, oc)
    model = carry.model_from_jax(cfg, jax.tree.map(np.asarray, jstate["params"]),
                                 device="cpu")
    return jcfg, cfg, oc, toc, jstate, S.init_state(cfg, toc, model=model)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# --------------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("step", [0, 1, 7, 199, 200, 201, 5000, 9999, 10_000, 12_000])
def test_schedule_matches_reference(step):
    oc = JA.OptimizerConfig()
    got = A.schedule(torch.tensor(step, dtype=torch.int32), A.OptimizerConfig())
    want = JA.schedule(jnp.int32(step), oc)
    assert got.dtype == torch.float32
    assert rel(got, want) <= OPT_RTOL or float(want) == float(got)


def _tree(seed, shapes=((5, 7), (3,), (2, 4, 6))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate(shapes)}


def test_global_norm_matches_reference():
    t = _tree(3)
    got = A.global_norm({k: torch.as_tensor(v) for k, v in t.items()})
    want = JA.global_norm({k: jnp.asarray(v) for k, v in t.items()})
    assert rel(got, want) <= OPT_RTOL


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_update_matches_reference(compress, clip):
    oc = JA.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20,
                            compress_grads=compress, clip_norm=clip)
    toc = A.OptimizerConfig(**dataclasses.asdict(oc))
    params = _tree(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    js, ts = JA.init(jp, oc), A.init(tp, toc)
    for i in range(3):
        g = {k: v * 3.0 for k, v in _tree(10 + i).items()}
        jp, js, jstats = JA.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, oc)
        tp, ts, tstats = A.update({k: torch.as_tensor(v) for k, v in g.items()}, ts, tp, toc)
        for key in ("grad_norm", "lr"):
            assert rel(tstats[key], jstats[key]) <= OPT_RTOL
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for part, tree_t, tree_j in (("params", tp, jp), ("m", ts["m"], js["m"]),
                                     ("v", ts["v"], js["v"])) + (
                (("ef", ts["ef"], js["ef"]),) if compress else ()):
            for k in params:
                np.testing.assert_allclose(tree_t[k].numpy(), np.asarray(tree_j[k]),
                                           rtol=OPT_RTOL, atol=OPT_RTOL * float(
                                               np.max(np.abs(np.asarray(tree_j[k])))),
                                           err_msg=f"{part}/{k} at step {i + 1}")


def test_init_state_is_float32_zeros_and_trainable():
    _, cfg = configs("chatglm3-6b")
    st = S.init_state(cfg, A.OptimizerConfig(compress_grads=True), device="cpu")
    params = A.params_of(st["params"])
    assert all(p.requires_grad for p in params.values())
    for part in ("m", "v", "ef"):
        assert set(st["opt"][part]) == set(params)
        assert all(t.dtype == torch.float32 and not t.any() for t in st["opt"][part].values())
    assert st["opt"]["step"].dtype == torch.int32 and int(st["opt"]["step"]) == 0


# --------------------------------------------------------------------------- #
# Gradients and the train step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_gradients_match_reference(arch):
    jcfg, cfg, _, _, jstate, tstate = pair(arch)
    b = batches(cfg, 1, seed=5)[0]
    want = jax_flat(jax.grad(lambda p: JT.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})[0])(jstate["params"]))
    _, _, grads = S.loss_and_grads(tstate["params"], cfg,
                                   {k: torch.as_tensor(v) for k, v in b.items()})
    got = S._stacked(grads, "g")
    assert set(got) == {"g/" + k for k in want}
    for k, w in want.items():
        err = np.max(np.abs(got["g/" + k].numpy() - w))
        assert err <= GRAD_TOL * max(np.max(np.abs(w)), 1e-30), (k, err)


def _two_steps(arch, accum=1, oc=None):
    jcfg, cfg, oc, toc, jstate, tstate = pair(arch, oc)
    bs = batches(cfg, 2, seed=1, batch=B * accum)
    g1 = jax_flat(jax.grad(lambda p: JT.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in bs[0].items()})[0])(jstate["params"]))
    jstep = jax.jit(JS.make_train_step(jcfg, oc, accum=accum))
    tstep = S.make_train_step(cfg, toc, accum=accum)
    lrs = []
    for b in bs:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.as_tensor(v) for k, v in b.items()})
        for key in ("loss", "total_loss", "grad_norm", "lr", "accuracy", "aux_loss"):
            assert rel(tm[key], jm[key]) <= STEP_RTOL or abs(float(jm[key])) < 1e-12, key
        lrs.append(float(jm["lr"]))
    return jstate, tstate, g1, lrs


def _hold_params(jstate, tstate, g1, lrs):
    got = S.state_arrays(tstate)
    for k, want in jax_flat(jstate["params"]).items():
        diff = np.abs(got["params/" + k].numpy() - want)
        g = np.abs(g1[k])
        determined = g >= DETERMINED * g.max()
        assert np.all(diff[determined] <= STEP_RTOL * np.max(np.abs(want))), k
        assert np.all(diff[~determined] <= 2 * sum(lrs)), k
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 2


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_train_steps_match_reference(arch):
    _hold_params(*_two_steps(arch))


def test_accumulated_train_step_matches_reference():
    _hold_params(*_two_steps("chatglm3-6b", accum=2))


def test_train_step_updates_in_place_and_keeps_inference_paths_graph_free():
    _, cfg = configs("chatglm3-6b")
    st = S.init_state(cfg, A.OptimizerConfig(), device="cpu")
    model = st["params"]
    before = {k: p.detach().clone() for k, p in A.params_of(model).items()}
    b = {k: torch.as_tensor(v) for k, v in batches(cfg, 1)[0].items()}
    st2, metrics = S.make_train_step(cfg, A.OptimizerConfig())(st, b)
    assert st2["params"] is model
    assert any(not torch.equal(before[k], p) for k, p in A.params_of(model).items())
    assert all(not v.requires_grad for v in metrics.values())
    # a frozen model's forward stays under inference mode
    frozen = T.init_model(cfg, device="cpu")
    hidden, _ = T.forward(frozen, cfg, b)
    assert hidden.is_inference() and not T.trains(frozen)
    # and a trainable model's forward under no_grad builds no graph
    with torch.no_grad():
        hidden, _ = T.forward(model, cfg, b)
    assert hidden.grad_fn is None


# --------------------------------------------------------------------------- #
# attn_impl="pallas" under autograd
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-medium"])
def test_pallas_attention_under_grad_raises_as_the_reference_does(arch):
    """``jax.grad`` through the Pallas attention kernel (interpret mode)
    fails in the JAX package's ``_pallas_call_jvp_rule``; the port's K5
    wrapper refuses the call on the CPU too rather than differentiate its
    plain version."""
    jcfg, cfg = configs(arch)
    jcfg, cfg = jcfg.replace(attn_impl="pallas"), cfg.replace(attn_impl="pallas")
    b = batches(cfg, 1, batch=2)[0]
    params, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(Exception):
        jax.grad(lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})[0])(params)
    st = S.init_state(cfg, A.OptimizerConfig(), model=carry.model_from_jax(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    with pytest.raises(NotImplementedError, match="no backward"):
        S.make_train_step(cfg, A.OptimizerConfig())(
            st, {k: torch.as_tensor(v) for k, v in b.items()})


def test_ssm_kernels_under_grad_raise_where_the_reference_takes_none():
    """For the SSM family ``attn_impl="pallas"`` routes the port to K6-K8
    (``models.transformer``), which have no backward, so the train step
    raises; the JAX package's SSM blocks take no Pallas kernel under that
    switch and differentiate."""
    jcfg, cfg = configs("falcon-mamba-7b")
    jcfg, cfg = jcfg.replace(attn_impl="pallas"), cfg.replace(attn_impl="pallas")
    b = batches(cfg, 1, batch=2)[0]
    params, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
    g = jax.grad(lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in b.items()})[0])(params)
    assert all(np.all(np.isfinite(np.asarray(x))) for x in jax.tree.leaves(g))
    st = S.init_state(cfg, A.OptimizerConfig(), model=carry.model_from_jax(
        cfg, jax.tree.map(np.asarray, params), device="cpu"))
    with pytest.raises(NotImplementedError, match="no backward"):
        S.make_train_step(cfg, A.OptimizerConfig())(
            st, {k: torch.as_tensor(v) for k, v in b.items()})


def test_checkpoint_layout_round_trips_every_family():
    for arch in ("chatglm3-6b", "recurrentgemma-9b", "whisper-medium", "qwen2-moe-a2.7b"):
        _, cfg = configs(arch)
        toc = A.OptimizerConfig(compress_grads=True)
        st = S.init_state(cfg, toc, device="cpu")
        for t in st["opt"]["m"].values():
            t.normal_()
        arrays = S.state_arrays(st)
        back = S.state_from_arrays(cfg, arrays, toc, device="cpu")
        assert S.state_arrays(back).keys() == arrays.keys()
        for k, v in S.state_arrays(back).items():
            assert torch.equal(v, arrays[k]), (arch, k)

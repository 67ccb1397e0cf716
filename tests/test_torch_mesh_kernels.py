"""The model kernels K5-K8 on a mesh, on the CPU.

Under ``attn_impl="pallas"`` the port runs K5 (attention), K6 / K7 (the SSM
stack's norms) and K8 (the selective scan) on each device's local tensors,
in explicit local regions; a kernel wrapper refuses a DTensor.  Here the
wrappers run their plain versions (CPU tensors), on the same local tensors
the card's kernels get, so the routing is the card's.

4 ``gloo`` processes (``torch_distributed_worker.py kernels``, a file store,
no network) run every family's smoke config in float32 on a (2, 2)
``("data", "model")`` mesh under ``tp``, and the hybrid's on a (4, 1) one,
without autograd:

* the forward's hidden states, a prefill's and a decode step's logits and
  the cache after them, sharded against unsharded: 1e-5 of the largest;
* a spy on the four ``kernels.ops`` entry points: the sharded runs call
  each as often as the unsharded ones (the counts of one forward, prefill
  and decode step by hand below), and never with a DTensor;
* each wrapper handed a DTensor raises ``TypeError`` (the Mamba mixer's
  fused conv too, which a sharded mixer does not call: its DTensors take
  the plain conv);
* chatglm3-6b's and falcon-mamba-7b's sharded forward and prefill on the
  JAX package's weights against the JAX package's ``attn_impl="pallas"``
  forward and prefill (its Pallas kernel in interpret mode): 1e-4, the
  bound of ``tests/test_torch_families.py`` for that comparison.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as JC
from repro.models import transformer as JT
from repro_torch import configs as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
#: the (2, 2) mesh's cases, and the hybrid on a (4, 1) mesh, whose "model"
#: axis of size 1 "splits" its one kv head
CASES = ("chatglm3-6b", "chatglm3-6b-one-kv-head", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "recurrentgemma-9b", "whisper-medium", "paligemma-3b", "recurrentgemma-9b-4x1")
KERNEL_OPS = ("flash_attention", "rmsnorm", "rmsnorm_residual", "selective_scan")
JAX_ARCHS = ("chatglm3-6b", "falcon-mamba-7b")
B, S = 4, 16
MESH_RTOL = 1e-5
PALLAS_TOL = 1e-4


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _jax_side(tmp):
    """The JAX package's weights and tokens for ``JAX_ARCHS`` into
    ``tmp/kernels.npz``; -> its pallas forward's hidden states and its
    prefill's logits."""
    arrays, want = {}, {}
    for arch in JAX_ARCHS:
        jcfg = JC.get_config(arch, smoke=True).replace(compute_dtype="float32",
                                                       attn_impl="pallas")
        params, _ = JT.init_model(jax.random.PRNGKey(0), jcfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            arrays[f"{arch}/params/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
        tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
        arrays[f"{arch}/tokens"] = tokens
        batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
        hidden, _ = JT.forward(params, jcfg, batch)
        cache, _ = JT.init_cache(jcfg, B, S + 4)
        _, logits = JT.prefill(params, jcfg, batch, cache)
        want[arch] = {"hidden": np.asarray(hidden), "prefill": np.asarray(logits)}
    np.savez(os.path.join(tmp, "kernels.npz"), **arrays)
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_kernels"))
    want = _jax_side(tmp)
    procs = [subprocess.Popen([sys.executable, WORKER, "kernels", str(r), "4", tmp],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    with open(os.path.join(tmp, "kernels.json")) as f:
        got = json.load(f)
    return got, dict(np.load(os.path.join(tmp, "kernels_out.npz"))), want


def calls_by_hand(case, stage):
    """The ``kops`` calls of one forward, prefill or decode step of a case's
    smoke config: K5 in every causal self-attention without a prefix but a
    decode step's (each dense or MoE layer's forward or prefill, the
    hybrid's local-attention blocks in a forward or prefill, the audio
    decoder's self-attention in a forward or prefill), K6 once and K7 and
    K8 once a layer in each SSM call."""
    cfg = C.get_config(case.replace("-one-kv-head", "").replace("-4x1", ""), smoke=True)
    out = dict.fromkeys(KERNEL_OPS, 0)
    family = cfg.family.value
    if family == "ssm":
        out.update(rmsnorm=1, rmsnorm_residual=cfg.n_layers, selective_scan=cfg.n_layers)
    elif family in ("dense", "moe", "audio") and stage != "decode":
        out["flash_attention"] = cfg.n_layers
    elif family == "hybrid" and stage != "decode":
        from repro_torch.models import transformer as T

        out["flash_attention"] = T.hybrid_layout(cfg)[0]
    return out


@pytest.mark.parametrize("case", CASES)
def test_sharded_pallas_run_matches_unsharded(run, case):
    """Forward, prefill, decode step and cache within 1e-5 of the largest."""
    errors = run[0][case]["errors"]
    assert max(errors.values()) <= MESH_RTOL, errors


@pytest.mark.parametrize("case", CASES)
def test_sharded_run_hands_the_kernels_local_tensors(run, case):
    """The kernels are called as often sharded as unsharded, as often as
    counted by hand, and never with a DTensor."""
    got = run[0][case]
    for stage in ("forward", "prefill", "decode"):
        sharded, plain = got["sharded_calls"][stage], got["unsharded_calls"][stage]
        assert sharded["dtensor_calls"] == dict.fromkeys(KERNEL_OPS, 0), (stage, sharded)
        assert sharded["calls"] == plain["calls"] == calls_by_hand(case, stage), (
            stage, sharded["calls"], plain["calls"])


@pytest.mark.parametrize("op", KERNEL_OPS + ("causal_conv_silu",))
def test_kernel_wrapper_refuses_a_dtensor(run, op):
    kind, msg = run[0]["refusals"][op]
    assert kind == "TypeError" and "DTensor" in msg and "local region" in msg, msg


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_sharded_forward_and_prefill_match_the_jax_package(run, arch):
    _, got, want = run
    for what in ("hidden", "prefill"):
        err = float(np.abs(got[f"{arch}/{what}"] - want[arch][what]).max())
        assert err < PALLAS_TOL, (what, err)

"""The port's sharded layer against the JAX package's.

* The rules: every spec (parameters, optimizer state, cache, batch,
  activation rules) of every registered config, smoke and full, under
  every variant on the meshes (2, 4), (16, 16) and (2, 16, 16), equal to
  the JAX package's ``PartitionSpec`` entries (its side computed in
  ``torch_distributed_reference.py`` with 512 host devices).
* The counts: one dense block on a (2, 4) mesh under ``tp``, with and
  without sequence parallelism, per device -- dot FLOPs and collective
  bytes by kind equal to a count by hand, and printed beside the JAX
  package's compiled numbers with their ratio pinned.  Counting runs in a
  fake process group, in a subprocess (one default group a process).
* The counts of one whole train step (forward, backward, the gradients'
  reduction and AdamW) of a one-layer dense model on a (2, 2) mesh under
  ``tp``, ``zero1`` and ``fsdp``: collective bytes and counts by kind
  equal to a count by hand, each gradient reduced once.
* Real collectives: 8 ``gloo`` processes on the CPU (a file store, no
  network, ``torch_distributed_worker.py``) -- the sharded loss of
  qwen3-32b smoke under ``tp`` on the JAX package's weights, against the
  port's unsharded loss (1e-5) and the JAX package's sharded loss (1e-3,
  the bound of ``tests/test_distributed.py``); two sharded train steps;
  every family's prefill and decode step on a (2, 2) mesh against the
  unsharded ones; ``shard_sweep`` over a 4-rank ``variants`` mesh against
  the meshless run; and an 8 -> 4 elastic reshard of a checkpoint.
* The port's counterparts of ``tests/test_distributed.py``'s mini dry run
  (grok-1-314b smoke, fsdp, (2, 2, 2), 4 devices a pod) and of the dry run
  CLI on a production mesh.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch import configs as C
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "tests", "torch_distributed_reference.py")
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
MESHES = {"2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHE_BS = (256, 64)
BATCH_SIZES = (256, 3)

#: The one dense block's per-device counts on (2, 4) under tp, by hand:
#: B 4 S 32 D 64, 8 heads of 8 (2 a device), 4 kv heads (1 a device), ffn
#: 128 (32 a device), float32; each device 2 rows of the batch.
#: dot FLOPs: q 2*64*64*16, k and v 2*64*64*8 each, scores and P V
#: 2*2*2*32*32*8 each, out 2*64*16*64, gate / up / down 2*64*64*32 each.
LAYER_DOT = 2 * 64 * 64 * 16 + 2 * (2 * 64 * 64 * 8) + 2 * (2 * 2 * 2 * 32 * 32 * 8) \
    + 2 * 64 * 16 * 64 + 3 * (2 * 64 * 64 * 32)
#: Collectives: with sequence parallelism the attention's and the MLP's
#: input is gathered over the sequence (an all-gather of the device's
#: (2, 8, 64) float32 slice, 4 096 B) and each branch's partial sums are
#: reduce-scattered back (the (2, 32, 64) partial, 16 384 B); without it
#: each branch's partial sums are all-reduced (16 384 B).
LAYER_COLLECTIVES = {"sp": {"all-gather": 2 * 4096, "reduce-scatter": 2 * 16384},
                     "nosp": {"all-reduce": 2 * 16384}}
#: port / JAX package, per device: XLA gathers 40 960 B under sequence
#: parallelism where DTensor gathers 8 192 and reduce-scatters 32 768; the
#: totals and the dot FLOPs agree (ROADMAP R17).
LAYER_RATIOS = {"sp": {"dot_flops": 1.0, "collective_bytes": 1.0},
                "nosp": {"dot_flops": 1.0, "collective_bytes": 1.0}}


#: One train step of a one-layer dense model (chatglm3-6b smoke at d_model
#: 1024, 8 heads of 128, 2 kv heads, ffn 1024, vocab 1024, float32), B 4
#: S 32 on (2, 2) ``("data", "model")``, per device, by hand.  A device
#: holds 2 rows; sequence parallelism splits their 32 positions over
#: "model".
#: Activations, every variant: ACT is the (2, 32, 1024) float32 partial sum
#: a device reduce-scatters over "model" (the embedding's and each
#: branch's), SEQ the (2, 16, 1024) slice it all-gathers (each branch's
#: input and the head's); the backward mirrors the forward (an all-gather's
#: gradient is a reduce-scatter and the reverse).  The loss reduces three
#: (2, 32, 1) float32 columns over the vocabulary's shards (max, sum of
#: exponentials, the label's logit) and the accuracy gathers the shards'
#: (2, 32) maxima (float32) and their indices (int64).
ACT, SEQ = 2 * 32 * 1024 * 4, 2 * 16 * 1024 * 4
STEP_ACTS = {"all-gather": (8, 6 * SEQ + 2 * 32 * 4 + 2 * 32 * 8),
             "reduce-scatter": (6, 6 * ACT), "all-reduce": (3, 3 * 2 * 32 * 4)}
#: Gradients, each reduced once over "data" at its "model" shard's bytes:
#: BIG for the seven tensors of 2**20 elements (the embedding, the
#: unembedding, wq, wo and the MLP's three; 1024 x 512 float32 a device),
#: KV for wk and wv (1024 x 1 x 128, below ZeRO's 2**20 elements: always
#: all-reduced), NORM for the three norm scales (1024, replicated), each
#: reduced twice: a partial sum over "data" and over "model" (sequence
#: parallelism) takes DTensor two all-reduces (R17).  tp all-reduces the
#: seven; zero1 reduce-scatters them to the moments' "data" shards and
#: all-gathers the updated halves (BIG / 2) after AdamW; fsdp gathers those
#: halves where the forward reads them and reduce-scatters their gradients
#: inside the backward.  The global norm all-reduces one float32 scalar
#: per axis its terms are partial over: "model" under tp, both under zero1
#: and fsdp.
BIG, KV, NORM = 1024 * 512 * 4, 1024 * 128 * 4, 1024 * 4
_SMALL = (2 + 6, 2 * KV + 6 * NORM)
STEP_GRADS = {
    "tp": {"all-reduce": (7 + _SMALL[0] + 1, 7 * BIG + _SMALL[1] + 4)},
    "zero1": {"reduce-scatter": (7, 7 * BIG), "all-gather": (7, 7 * BIG // 2),
              "all-reduce": (_SMALL[0] + 2, _SMALL[1] + 8)},
    "fsdp": {"reduce-scatter": (7, 7 * BIG), "all-gather": (7, 7 * BIG // 2),
             "all-reduce": (_SMALL[0] + 2, _SMALL[1] + 8)},
}


def _step_by_hand(variant):
    out = {}
    for part in (STEP_ACTS, STEP_GRADS[variant]):
        for kind, (n, b) in part.items():
            n0, b0 = out.get(kind, (0, 0))
            out[kind] = (n0 + n, b0 + b)
    return out


def _env(devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def _run(args, devices=None, timeout=600):
    out = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                         env=_env(devices), timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-4000:] + "\n" + out.stderr[-4000:]
    return out.stdout


def _reference(tmp, entry, devices, *extra):
    out = os.path.join(tmp, f"{entry}.json")
    _run([REFERENCE, entry, out, *extra], devices=devices)
    with open(out) as f:
        return json.load(f)


def _port(code: str) -> dict:
    """Run ``code`` in a fresh process (its own fake world); its last line
    of output is JSON."""
    return json.loads(_run(["-c", textwrap.dedent(code)]).strip().splitlines()[-1])


def _gloo(tmp, task, world):
    procs = [subprocess.Popen([sys.executable, WORKER, task, str(r), str(world), tmp],
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    with open(os.path.join(tmp, f"{task}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("distributed"))


@pytest.fixture(scope="module")
def jax_specs(tmp):
    return _reference(tmp, "specs", 512)


@pytest.fixture(scope="module")
def jax_layer(tmp):
    return _reference(tmp, "layer", 8)


@pytest.fixture(scope="module")
def gloo(tmp):
    ref = _reference(tmp, "loss", 8, os.path.join(tmp, "loss.npz"))
    train = _gloo(tmp, "train", 8)
    restore = _gloo(tmp, "restore", 4)
    infer = _gloo(tmp, "infer", 4)
    return {"jax": ref, "train": train, "restore": restore, "infer": infer}


@pytest.fixture(scope="module")
def port_layer():
    return _port("""
        import json, torch
        from repro_torch import configs as C
        from repro_torch.core import costs as CO
        from repro_torch.distributed import ctx as CTX, place as PL, sharding as SH
        from repro_torch.launch import mesh as MESH
        from repro_torch.models import layers as L, transformer as T

        MESH.fake_world(8)
        mesh = MESH.make_mesh((2, 4), ("data", "model"))
        cfg = C.get_config("chatglm3-6b", smoke=True).replace(
            n_heads=8, n_kv_heads=4, d_ff=128, qkv_bias=False,
            compute_dtype="float32", param_dtype="float32")
        sc = SH.ShardingConfig(variant="tp")
        block = T.ParamTree(T._dense_block_init(cfg, None, "meta"))
        PL.shard_model(block, SH.param_specs(
            T.param_shapes(block), T._dense_block_axes(cfg), mesh, sc), mesh)
        B, S = 4, 32
        pos = torch.arange(S, device="meta").expand(B, S)
        out = {}
        for sp in (True, False):
            rules = SH.activation_rules(mesh, sc, kind="train" if sp else "decode")
            x = PL.distribute(torch.empty(B, S, cfg.d_model, device="meta"),
                              rules["acts"], mesh)
            c = CO.OpCounter((block, x))
            with PL.sharded_step(), CTX.use_rules(rules), c:
                T._dense_block_apply(block, cfg, x, rope=T._rope_for(cfg, pos),
                                     mask=L.MaskSpec(causal=True), q_pos=pos, k_pos=pos)
            out["sp" if sp else "nosp"] = {
                "dot_flops": c.stats.dot_flops,
                "collective_bytes": c.stats.collective_bytes}
        print(json.dumps(out))
    """)


@pytest.fixture(scope="module")
def port_step():
    return _port("""
        import json
        from repro_torch import configs as C
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch import mesh as MESH
        from repro_torch.launch.extract import run_cell

        MESH.fake_world(4)
        mesh = MESH.make_mesh((2, 2), ("data", "model"))
        cfg = C.get_config("chatglm3-6b", smoke=True).replace(
            n_layers=1, d_model=1024, n_heads=8, n_kv_heads=2, head_dim=128,
            d_ff=1024, vocab_size=1024, qkv_bias=False,
            compute_dtype="float32", param_dtype="float32")
        out = {}
        for v in SH.SHARDING_VARIANTS:
            p = run_cell(cfg, ShapeSpec("t", 32, 4, "train"), device="meta",
                         mesh=mesh, variant=v)
            out[v] = {k: [p.collective_counts[k], p.collective_bytes[k]]
                      for k in p.collective_bytes}
        print(json.dumps(out))
    """)


# --------------------------------------------------------------------------- #
# the rules
# --------------------------------------------------------------------------- #


def test_spec_rules():
    mesh = MESHES["2x4"]
    sc = SH.ShardingConfig(variant="tp")
    # mlp dim sharded on model
    assert SH.spec_for_tensor((64, 128), ("embed", "mlp"), mesh, sc) == (None, "model")
    # kv_heads=2 not divisible by model=4 -> head_dim fallback
    assert SH.spec_for_tensor((64, 2, 16), ("embed", "kv_heads", "head_dim"),
                              mesh, sc) == (None, None, "model")
    # kv_heads divisible -> sharded, head_dim left alone
    assert SH.spec_for_tensor((64, 4, 16), ("embed", "kv_heads", "head_dim"),
                              mesh, sc) == (None, "model", None)
    # batch axis across data; not divisible -> replicated
    assert SH.spec_for_tensor((8, 128), ("batch", None), mesh, sc) == ("data", None)
    assert SH.spec_for_tensor((3, 128), ("batch", None), mesh, sc) == (None, None)
    # fsdp shards the biggest replicated dim over data
    assert SH.spec_for_tensor((64, 128), ("embed", "mlp"), mesh,
                              SH.ShardingConfig(variant="fsdp"),
                              fsdp_this=True) == ("data", "model")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = [list(e) if isinstance(e, tuple) else e for e in v]
    return out


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_specs_match_the_jax_package(jax_specs, arch):
    for smoke in (True, False):
        cfg = C.get_config(arch, smoke=smoke)
        model = T.init_model(cfg, device="meta")
        shapes, axes = T.param_shapes(model), T.param_axes(cfg)
        cache = T.init_cache(cfg, *CACHE_BS, device="meta")
        cache_shapes = _shapes(cache)
        for mname, mesh in MESHES.items():
            for variant in SH.SHARDING_VARIANTS:
                sc = SH.ShardingConfig(variant=variant, multi_pod="pod" in mesh)
                ref = jax_specs[f"{arch}/{int(smoke)}/{mname}/{variant}"]
                where = (arch, smoke, mname, variant)
                assert _flat(SH.param_specs(shapes, axes, mesh, sc)) == ref["params"], where
                assert _flat(SH.opt_state_specs(shapes, axes, mesh, sc)) == ref["opt"], where
                assert _flat(SH.param_specs(cache_shapes, T.cache_axes(cfg), mesh, sc,
                                            fsdp=False)) == ref["cache"], where
                assert {f"{nd}/{b}": _entries(SH.batch_spec(mesh, sc, nd, b))
                        for nd in (2, 3) for b in BATCH_SIZES} == ref["batch"], where
                for kind in ("train", "prefill", "decode"):
                    rules = SH.activation_rules(mesh, sc, kind=kind)
                    got = {k: (_entries(v) if isinstance(v, tuple) else v)
                           for k, v in rules.items() if k != "shmap"}
                    assert got == ref[f"rules/{kind}"], (where, kind)


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tuple(tree.shape)


# --------------------------------------------------------------------------- #
# the counts
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sp", ["sp", "nosp"])
def test_one_dense_layer_counts_equal_a_count_by_hand(port_layer, sp):
    got = port_layer[sp]
    assert got["dot_flops"] == LAYER_DOT
    want = {k: float(LAYER_COLLECTIVES[sp].get(k, 0)) for k in got["collective_bytes"]}
    assert got["collective_bytes"] == want


@pytest.mark.parametrize("sp", ["sp", "nosp"])
def test_one_dense_layer_beside_the_jax_package(port_layer, jax_layer, sp):
    port, ref = port_layer[sp], jax_layer[sp]
    print(f"\n{sp}: dot FLOPs port {port['dot_flops']:.0f} jax {ref['dot_flops']:.0f}")
    for kind in port["collective_bytes"]:
        print(f"  {kind:18s} port {port['collective_bytes'][kind]:8.0f} B "
              f"jax {ref['collective_bytes'][kind]:8.0f} B")
    ratios = {"dot_flops": port["dot_flops"] / ref["dot_flops"],
              "collective_bytes": sum(port["collective_bytes"].values())
              / sum(ref["collective_bytes"].values())}
    assert ratios == pytest.approx(LAYER_RATIOS[sp], rel=1e-12)


@pytest.mark.parametrize("variant", SH.SHARDING_VARIANTS)
def test_one_train_step_counts_equal_a_count_by_hand(port_step, variant):
    got = port_step[variant]
    want = _step_by_hand(variant)
    assert got == {k: [want.get(k, (0, 0))[0], float(want.get(k, (0, 0))[1])]
                   for k in got}
    total = {v: sum(b for _, b in port_step[v].values()) for v in port_step}
    assert total["fsdp"] >= total["tp"]


# --------------------------------------------------------------------------- #
# real collectives (gloo)
# --------------------------------------------------------------------------- #


def test_sharded_loss_matches_unsharded(gloo):
    t = gloo["train"]
    assert abs(t["sharded"] - t["unsharded"]) < 1e-5, t


def test_sharded_loss_matches_the_jax_package(gloo):
    assert abs(gloo["train"]["sharded"] - gloo["jax"]["sharded"]) < 1e-3, gloo


def test_sharded_train_step_runs(gloo):
    t = gloo["train"]
    l1, l2 = t["step_losses"]
    assert l2 < l1   # the same batch twice -> the loss drops
    assert abs(l1 - t["step_unsharded"]) <= 1e-5 * abs(t["step_unsharded"]), t
    # the gradients too, of every parameter (the kv heads, gathered over
    # "model" and read in part by each device, included), on the scale of
    # the largest
    assert t["grad_err"] <= 1e-6, t


@pytest.mark.parametrize("case", ["chatglm3-6b", "chatglm3-6b-one-kv-head",
                                  "qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "recurrentgemma-9b", "whisper-medium",
                                  "paligemma-3b"])
def test_sharded_gradients_prefill_and_decode_match_unsharded(gloo, case):
    """Every family on a (2, 2) mesh: the loss's gradients, a prefill's and
    a decode step's logits and the cache within 1e-5 of the largest
    (float32; the MoE, the attention and the embedding run in local
    regions whose gradients are partial sums)."""
    got = gloo["infer"][case]
    assert max(got.values()) <= 1e-5, got


def test_shard_sweep_over_the_variants_mesh_equals_the_meshless_run(gloo):
    sw = gloo["restore"]["sweep"]
    assert sw == {"mesh_axis": "variants=4 mesh", "same_front": True,
                  "same_best": True, "same_candidates": True}


def test_elastic_checkpoint_reshard(gloo):
    r = gloo["restore"]
    assert r["step"] == 5 and r["mesh_size"] == 4 and r["local"] == [4, 4]
    assert r["whole"] == [[float(8 * i + j) for j in range(8)] for i in range(8)]


# --------------------------------------------------------------------------- #
# dry runs
# --------------------------------------------------------------------------- #


def test_mini_dryrun_profile_extraction():
    """Multi-pod mesh, fsdp: per-device profile with collectives that cross
    pods, and the congruence / roofline reports on it."""
    out = _port("""
        import json
        from repro_torch import configs as C
        from repro_torch.configs.shapes import ShapeSpec
        from repro_torch.core import TPU_V5E, profile_congruence
        from repro_torch.core.roofline import analyze
        from repro_torch.launch import mesh as MESH
        from repro_torch.launch.extract import run_cell

        MESH.fake_world(8)
        mesh = MESH.make_mesh((2, 2, 2), ("pod", "data", "model"))
        cfg = C.get_config("grok-1-314b", smoke=True)
        prof = run_cell(cfg, ShapeSpec("t", 32, 4, "train"), device="meta",
                        mesh=mesh, variant="fsdp", multi_pod=True,
                        devices_per_pod=4)
        rep = profile_congruence(prof, TPU_V5E)
        rl = analyze(prof, TPU_V5E)
        print(json.dumps({"n": prof.num_devices, "flops": prof.flops,
                          "coll": prof.total_collective_bytes,
                          "pod": prof.pod_collective_bytes,
                          "scores": sorted(rep.scores), "dominant": rl.dominant}))
    """)
    assert out["n"] == 8 and out["flops"] > 0 and out["coll"] > 0
    assert out["pod"] > 0
    assert out["scores"] == ["HRCS", "ICS", "LBCS"]
    assert out["dominant"] in ("compute", "memory", "interconnect")


def test_dryrun_cli_writes_a_per_device_profile_on_the_pod_mesh(tmp_path):
    from repro_torch.core.costs import WorkloadProfile

    _run(["-m", "repro_torch.launch.dryrun", "--arch", "chatglm3-6b", "--shape",
          "train_4k", "--smoke", "--mesh", "pod", "--out", str(tmp_path)])
    prof = WorkloadProfile.load(str(
        tmp_path / "chatglm3-smoke__train_4k__pod16x16__zero1.json"))
    assert prof.num_devices == 256 and prof.mesh == "pod16x16"
    assert prof.total_collective_bytes > 0 and prof.pod_collective_bytes == 0
    assert prof.meta["variant"] == "zero1"

"""The JAX package's sharded layer, in a subprocess, for
``tests/test_torch_distributed.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=N \\
        python tests/torch_distributed_reference.py ENTRY OUT.json [OUT.npz]

``specs`` (N = 512): every spec the rules give -- parameters, optimizer
state, cache, batch, activation rules -- for every registered config at
``smoke`` True and False, under every variant, on the meshes (2, 4),
(16, 16) and (2, 16, 16), as JSON lists keyed by leaf path.

``layer`` (N = 8): one dense block forward (``LAYER_CFG``) compiled on a
(2, 4) mesh under ``tp`` with and without sequence parallelism; its
per-device dot FLOPs and collective bytes by kind from the compiled HLO
(``core.costs.parse_hlo_stats``).

``loss`` (N = 8): qwen3-32b smoke in float32, ``init_model`` at
``PRNGKey(0)``, the unsharded loss and the loss on a (2, 4) mesh under
``tp`` of ``SyntheticLM``'s batch 0 (seq 32, batch 4); the parameters and
the batch go to OUT.npz for the port.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as C
from repro.distributed import ctx as CTX
from repro.distributed import sharding as SH
from repro.launch import mesh as MESH
from repro.models import layers as L
from repro.models import transformer as T

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BS = (256, 64)     # the cache specs' batch and length
BATCH_SIZES = (256, 3)   # a batch that divides every data world, one that does not
LAYER_B, LAYER_S = 4, 32


def layer_cfg(get_config):
    return get_config("chatglm3-6b", smoke=True).replace(
        n_heads=8, n_kv_heads=4, d_ff=128, qkv_bias=False,
        compute_dtype="float32", param_dtype="float32")


def _entries(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[key] = _entries(leaf.spec)
    return out


def specs():
    out = {}
    for smoke in (True, False):
        for arch in C.ARCH_IDS:
            cfg = C.get_config(arch, smoke=smoke)
            params, axes = T.init_model(jax.random.PRNGKey(0), cfg, abstract=True)
            cache, cache_axes = T.init_cache(cfg, *CACHE_BS, abstract=True)
            for mname, (shape, names) in MESHES.items():
                mesh = MESH.make_mesh(shape, names)
                for variant in SH.SHARDING_VARIANTS:
                    sc = SH.ShardingConfig(variant=variant, multi_pod=len(shape) == 3)
                    rec = {"params": _flat(SH.param_specs(params, axes, mesh, sc)),
                           "opt": _flat(SH.opt_state_specs(params, axes, mesh, sc)),
                           "cache": _flat(SH.param_specs(cache, cache_axes, mesh, sc,
                                                         fsdp=False)),
                           "batch": {f"{nd}/{b}": _entries(SH.batch_spec(
                               mesh, sc, ndim=nd, batch_size=b).spec)
                               for nd in (2, 3) for b in BATCH_SIZES}}
                    for kind in ("train", "prefill", "decode"):
                        rules = SH.activation_rules(mesh, sc, kind=kind)
                        rec[f"rules/{kind}"] = {
                            k: (_entries(v.spec) if hasattr(v, "spec") else v)
                            for k, v in rules.items() if k != "shmap"}
                    out[f"{arch}/{int(smoke)}/{mname}/{variant}"] = rec
    return out


def layer():
    from repro.core import costs as CO

    cfg = layer_cfg(C.get_config)
    mesh = MESH.make_mesh((2, 4), ("data", "model"))
    sc = SH.ShardingConfig(variant="tp")
    bp, axes = T._dense_block_init(jax.random.PRNGKey(0), cfg)
    p_sh = SH.param_specs(bp, axes, mesh, sc)
    B, S, D = LAYER_B, LAYER_S, cfg.d_model
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    out = {}
    for sp in (True, False):
        rules = SH.activation_rules(mesh, sc, kind="train" if sp else "decode")
        x_sh = rules["acts"]

        def f(bp, x):
            rope = T._rope_for(cfg, positions)
            y, _, _ = T._dense_block_apply(bp, cfg, x, rope=rope,
                                           mask=L.MaskSpec(causal=True),
                                           q_pos=positions, k_pos=positions)
            return y

        x = jax.ShapeDtypeStruct((B, S, D), jnp.float32, sharding=x_sh)
        with MESH.use_mesh(mesh), CTX.use_rules(rules):
            compiled = jax.jit(f, in_shardings=(p_sh, x_sh), out_shardings=x_sh
                               ).lower(bp, x).compile()
        st = CO.parse_hlo_stats(compiled.as_text())
        out["sp" if sp else "nosp"] = {
            "dot_flops": float(st.dot_flops),
            "collective_bytes": {k: float(v) for k, v in st.collective_bytes.items()}}
    return out


def loss(npz):
    from repro.data.pipeline import DataConfig, SyntheticLM

    cfg = C.get_config("qwen3-32b", smoke=True).replace(compute_dtype="float32")
    params, axes = T.init_model(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4)).batch(0).items()}
    base, _ = T.loss_fn(params, cfg, batch)
    mesh = MESH.make_mesh((2, 4), ("data", "model"))
    sc = SH.ShardingConfig(variant="tp")
    params_sh = jax.tree.map(jax.device_put, params,
                             SH.param_specs(params, axes, mesh, sc))
    with MESH.use_mesh(mesh), CTX.use_rules(SH.activation_rules(mesh, sc, kind="train")):
        sharded, _ = jax.jit(lambda p, b: T.loss_fn(p, cfg, b))(params_sh, batch)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(npz, **{f"params/{k}": v for k, v in flat.items()},
             **{f"batch/{k}": np.asarray(v) for k, v in batch.items()})
    return {"unsharded": float(base), "sharded": float(sharded)}


if __name__ == "__main__":
    entry, out = sys.argv[1], sys.argv[2]
    res = {"specs": specs, "layer": layer}.get(entry)
    res = res() if res else loss(sys.argv[3])
    with open(out, "w") as f:
        json.dump(res, f)

"""One rank of a real ``gloo`` process group on the CPU, for
``tests/test_torch_distributed.py``.

    python tests/torch_distributed_worker.py TASK RANK WORLD DIR

Ranks meet through the file store ``DIR/store`` (no network).  ``TASK``:

* ``train`` (8 ranks, a (2, 4) mesh): qwen3-32b smoke in float32 with the
  JAX package's weights and batch (``DIR/loss.npz``, from
  ``torch_distributed_reference.py loss``), its loss unsharded and sharded
  under ``tp``; the gradients and two ``zero1`` train steps of a narrow
  chatglm3 smoke on the same batch, and the same unsharded; an (8, 8) array sharded
  ``("data", "model")`` saved by rank 0 under ``DIR/ckpt``.
* ``infer`` (4 ranks, a (2, 2) mesh): each family's gradients, prefill
  and decode step sharded under ``tp`` against the unsharded ones.
* ``restore`` (4 ranks): ``shard_sweep`` over the 4-rank ``variants`` mesh
  beside the meshless run, and that checkpoint restored onto a (2, 2)
  mesh.
* ``kernels`` (4 ranks, a (2, 2) mesh and a (4, 1) one, for
  ``tests/test_torch_mesh_kernels.py``): each family under
  ``attn_impl="pallas"``, its forward, prefill and decode step sharded
  under ``tp`` against the unsharded ones, with the model
  kernels' entry points spied on; each kernel wrapper handed a DTensor;
  chatglm3-6b's and falcon-mamba-7b's sharded forward and prefill on the
  JAX package's weights (``DIR/kernels.npz``) saved to
  ``DIR/kernels_out.npz``.

Rank 0 writes ``DIR/TASK.json``.
"""

import json
import os
import sys

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.carry import model_from_jax
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import ctx as CTX
from repro_torch.distributed import place as PL
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.training.step import init_state, loss_and_grads, make_train_step


def _jax_tree(npz, prefix):
    """The npz's ``prefix/a/b`` leaves as the nested dict ``{a: {b: ...}}``."""
    tree = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = npz[key]
    return tree


def _sharded(fn, mesh, sc, kind="train"):
    with PL.sharded_step(), CTX.use_rules(SH.activation_rules(mesh, sc, kind=kind)):
        return fn()


def train(d, rank):
    out = {}
    mesh = MESH.make_mesh((2, 4), ("data", "model"))
    npz = np.load(os.path.join(d, "loss.npz"))
    cfg = C.get_config("qwen3-32b", smoke=True).replace(compute_dtype="float32")
    batch = {k: torch.as_tensor(v) for k, v in _jax_tree(npz, "batch").items()}
    model = model_from_jax(cfg, _jax_tree(npz, "params"), device="cpu")
    out["unsharded"] = float(T.loss_fn(model, cfg, batch)[0])
    sc = SH.ShardingConfig(variant="tp")
    PL.shard_state(cfg, model, mesh, sc)
    loss = _sharded(lambda: T.loss_fn(model, cfg, PL.shard_batch(batch, mesh, sc))[0],
                    mesh, sc)
    out["sharded"] = float(PL.full(loss))

    cfg = C.get_config("chatglm3-6b", smoke=True).replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, compute_dtype="float32")
    oc = adamw.OptimizerConfig(warmup_steps=1, total_steps=10)
    sc = SH.ShardingConfig(variant="zero1")
    data = {k: torch.as_tensor(v) for k, v in
            SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=4)).batch(0).items()}
    step = make_train_step(cfg, oc)
    plain = init_state(cfg, oc, device="cpu")
    _, m = step(plain, data)
    out["step_unsharded"] = float(m["loss"])
    state = init_state(cfg, oc, device="cpu")
    PL.shard_state(cfg, state["params"], mesh, sc, state)
    sb = PL.shard_batch(data, mesh, sc)
    losses = []
    # every gradient against the unsharded one, on the scale of the largest
    # (Adam's update divides by the gradient's own size, so the updates of
    # parameters whose gradient is rounding noise, such as the k bias under
    # a softmax, would differ whatever the order of the sums)
    want = loss_and_grads(init_state(cfg, oc, device="cpu")["params"], cfg, data)[2]
    got = _sharded(lambda: loss_and_grads(state["params"], cfg, sb)[2], mesh, sc)
    scale = max(float(g.abs().max()) for g in want.values())
    out["grad_err"] = max(float((PL.full(got[k]) - want[k]).abs().max())
                          for k in want) / scale
    for _ in range(2):
        state, m = _sharded(lambda: step(state, sb), mesh, sc)
        losses.append(float(PL.full(m["loss"])))
    out["step_losses"] = losses

    w = PL.distribute(torch.arange(64, dtype=torch.float32).reshape(8, 8),
                      ("data", "model"), mesh)
    whole = PL.full(w)
    if rank == 0:
        store.save(os.path.join(d, "ckpt"), 5, {"w": whole})
    torch.distributed.barrier()
    return out


def restore(d, rank):
    from repro_torch.core import shard_sweep
    from repro_torch.core.suites import resolve_suite

    apps = resolve_suite("gen:8")
    plain = shard_sweep(apps, n=1000, num_shards=3, device="cpu", backend="torch")
    split = shard_sweep(apps, n=1000, num_shards=3, device="cpu", backend="torch",
                        mesh=MESH.make_variant_mesh())
    sweep = {"mesh_axis": split.mesh_axis,
             "same_front": plain.pareto_names() == split.pareto_names(),
             "same_best": all(plain.best_fit(a.name) == split.best_fit(a.name)
                              for a in apps),
             "same_candidates": plain.candidate_indices.tolist()
             == split.candidate_indices.tolist()}
    mesh = MESH.make_mesh((2, 2), ("data", "model"))
    tree = {"w": np.zeros((8, 8), np.float32)}
    restored, extra = store.restore(os.path.join(d, "ckpt"), tree,
                                    shardings={"w": (mesh, ("data", "model"))})
    w = restored["w"]
    return {"sweep": sweep, "step": extra["step"], "mesh_size": w.device_mesh.size(),
            "local": list(w.to_local().shape),
            "whole": PL.full(w).tolist()}


#: (arch, config changes) of the ``infer`` task: every family, and a dense
#: model whose one kv head splits on head_dim
INFER_CASES = {"chatglm3-6b": {}, "chatglm3-6b-one-kv-head": {"n_kv_heads": 1},
               "qwen2-moe-a2.7b": {}, "falcon-mamba-7b": {},
               "recurrentgemma-9b": {}, "whisper-medium": {}, "paligemma-3b": {}}


def infer(d, rank):
    """Each family's smoke config in float32, unsharded and on a (2, 2)
    mesh under ``tp``: the largest gradient error (on the scale of the
    largest gradient), the largest logit error of a prefill and of one
    decode step, and of the cache after it (each on its largest's
    scale)."""
    from repro_torch.launch.specs import _shapes

    mesh = MESH.make_mesh((2, 2), ("data", "model"))
    sc = SH.ShardingConfig(variant="tp")
    out = {}
    B, S = 4, 16
    for case, change in INFER_CASES.items():
        arch = case.replace("-one-kv-head", "")
        cfg = C.get_config(arch, smoke=True).replace(compute_dtype="float32", **change)
        gen = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
        if cfg.family.value == "audio":
            batch["frames"] = torch.randn(B, cfg.encoder_seq_len, cfg.d_model, generator=gen)
        if cfg.family.value == "vlm":
            batch["patches"] = torch.randn(B, cfg.n_vision_tokens, cfg.d_model, generator=gen)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
        batch["labels"] = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        model = T.init_model(cfg, device="cpu")
        cache, l0 = T.prefill(model, cfg, batch, T.init_cache(cfg, B, S + 4, device="cpu"))
        cache, l1 = T.decode_step(model, cfg, cache, tok, S)
        model.requires_grad_(True)
        grads = loss_and_grads(model, cfg, batch)[2]
        PL.shard_state(cfg, model, mesh, sc)
        got = _sharded(lambda: loss_and_grads(model, cfg, PL.shard_batch(batch, mesh, sc))[2],
                       mesh, sc)
        scale = max(float(g.abs().max()) for g in grads.values())
        grad_err = max(float((PL.full(got[k]) - grads[k]).abs().max()) for k in grads) / scale
        model.requires_grad_(False)
        c2 = T.init_cache(cfg, B, S + 4, device="cpu")
        c2 = PL.shard_tree(c2, SH.param_specs(_shapes(c2), T.cache_axes(cfg), mesh, sc,
                                              fsdp=False), mesh)
        c2, m0 = _sharded(lambda: T.prefill(model, cfg, PL.shard_batch(batch, mesh, sc), c2),
                          mesh, sc, "prefill")
        tok_s = PL.shard_batch({"t": tok}, mesh, sc)["t"]
        c2, m1 = _sharded(lambda: T.decode_step(model, cfg, c2, tok_s, S), mesh, sc, "decode")

        def err(a, b):
            if isinstance(b, dict):
                return max(err(a[k], b[k]) for k in b)
            return float((PL.full(a) - b).abs().max() / max(float(b.abs().max()), 1e-30))

        out[case] = {"prefill": err(m0, l0), "decode": err(m1, l1), "cache": err(c2, cache),
                     "grads": grad_err}
    return out


#: the model kernels' entry points (``repro_torch.kernels.ops``)
KERNEL_OPS = ("flash_attention", "rmsnorm", "rmsnorm_residual", "selective_scan")


class KernelSpy:
    """Wraps the ``kops`` entry points: counts each one's calls, and the
    calls that were handed a DTensor, in ``calls`` / ``dtensor_calls``."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops, self.real = ops, {n: getattr(ops, n) for n in KERNEL_OPS}
        self.reset()
        for name in KERNEL_OPS:
            setattr(ops, name, self._spy(name))

    def _spy(self, name):
        real = self.real[name]

        def call(*args, **kwargs):
            self.calls[name] += 1
            if any(PL.is_dtensor(t) for t in (*args, *kwargs.values())):
                self.dtensor_calls[name] += 1
            return real(*args, **kwargs)

        return call

    def reset(self):
        self.calls = dict.fromkeys(KERNEL_OPS, 0)
        self.dtensor_calls = dict.fromkeys(KERNEL_OPS, 0)

    def take(self):
        out = {"calls": self.calls, "dtensor_calls": self.dtensor_calls}
        self.reset()
        return out

    def close(self):
        for name, fn in self.real.items():
            setattr(self.ops, name, fn)


def _refusals(mesh):
    """Each wrapper called with one DTensor argument on ``mesh``: -> the
    error each raised (its type and message), or None."""
    from repro_torch.kernels import ops

    def dt(*shape):
        return PL.distribute(torch.randn(*shape), (), mesh)

    k = torch.randn(2, 2, 8, 16)
    x, scale = torch.randn(4, 8, 32), torch.ones(32)
    xi, bc, A = torch.rand(2, 8, 16), torch.rand(2, 8, 4), -torch.rand(16, 4)
    calls = {
        "flash_attention": lambda: ops.flash_attention(dt(2, 4, 8, 16), k, k),
        "rmsnorm": lambda: ops.rmsnorm(dt(4, 8, 32), scale),
        "rmsnorm_residual": lambda: ops.rmsnorm_residual(x, dt(4, 8, 32), scale),
        "selective_scan": lambda: ops.selective_scan(xi, xi, bc, bc, A,
                                                     dt(2, 16, 4)),
        "causal_conv_silu": lambda: ops.causal_conv_silu(dt(2, 8, 16), torch.randn(4, 16),
                                                         None),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except Exception as exc:   # noqa: BLE001 -- the test reads the type
            out[name] = [type(exc).__name__, str(exc)]
    return out


#: (arch, config changes, mesh shape) of the ``kernels`` task: every
#: ``INFER_CASES`` case on (2, 2), and the hybrid on a "model" axis of size
#: 1, which splits its one kv head over it
KERNEL_CASES = {**{case: (case.replace("-one-kv-head", ""), change, (2, 2))
                   for case, change in INFER_CASES.items()},
                "recurrentgemma-9b-4x1": ("recurrentgemma-9b", {}, (4, 1))}


def kernels(d, rank):
    """Every ``KERNEL_CASES`` case's smoke config in float32 under
    ``attn_impl="pallas"`` and ``torch.no_grad()``, unsharded and on its
    mesh under ``tp``: the largest error of the forward's hidden
    states, of a prefill's and a decode step's logits and of the cache after
    them (each on its largest's scale), and the ``kops`` calls of each,
    sharded and unsharded.  chatglm3-6b and falcon-mamba-7b run on the JAX
    package's weights and tokens (``DIR/kernels.npz``); rank 0 saves their
    sharded forward's hidden states and prefill's logits."""
    from repro_torch.launch.specs import _shapes

    meshes = {shape: MESH.make_mesh(shape, ("data", "model"))
              for shape in {m for _, _, m in KERNEL_CASES.values()}}
    sc = SH.ShardingConfig(variant="tp")
    npz = np.load(os.path.join(d, "kernels.npz"))
    out, saved = {"refusals": _refusals(meshes[2, 2])}, {}
    spy = KernelSpy()
    B, S = 4, 16
    for case, (arch, change, shape) in KERNEL_CASES.items():
        mesh = meshes[shape]
        cfg = C.get_config(arch, smoke=True).replace(
            compute_dtype="float32", attn_impl="pallas", **change)
        gen = torch.Generator().manual_seed(1)
        if f"{arch}/tokens" in npz.files and not change:
            model = model_from_jax(cfg, _jax_tree(npz, f"{arch}/params"), device="cpu")
            batch = {"tokens": torch.as_tensor(npz[f"{arch}/tokens"])}
        else:
            model = T.init_model(cfg, device="cpu")
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
        if cfg.family.value == "audio":
            batch["frames"] = torch.randn(B, cfg.encoder_seq_len, cfg.d_model, generator=gen)
        if cfg.family.value == "vlm":
            batch["patches"] = torch.randn(B, cfg.n_vision_tokens, cfg.d_model, generator=gen)
        tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
        with torch.no_grad():
            calls = {}
            h, _ = T.forward(model, cfg, batch)
            calls["forward"] = spy.take()
            cache, l0 = T.prefill(model, cfg, batch, T.init_cache(cfg, B, S + 4, device="cpu"))
            calls["prefill"] = spy.take()
            cache, l1 = T.decode_step(model, cfg, cache, tok, S)
            calls["decode"] = spy.take()
            PL.shard_state(cfg, model, mesh, sc)
            sb = PL.shard_batch(batch, mesh, sc)
            sharded = {}
            h_s, _ = _sharded(lambda: T.forward(model, cfg, sb), mesh, sc, "prefill")
            sharded["forward"] = spy.take()
            c2 = T.init_cache(cfg, B, S + 4, device="cpu")
            c2 = PL.shard_tree(c2, SH.param_specs(_shapes(c2), T.cache_axes(cfg), mesh, sc,
                                                  fsdp=False), mesh)
            c2, m0 = _sharded(lambda: T.prefill(model, cfg, sb, c2), mesh, sc, "prefill")
            sharded["prefill"] = spy.take()
            tok_s = PL.shard_batch({"t": tok}, mesh, sc)["t"]
            c2, m1 = _sharded(lambda: T.decode_step(model, cfg, c2, tok_s, S), mesh, sc,
                              "decode")
            sharded["decode"] = spy.take()

        def err(a, b):
            if isinstance(b, dict):
                return max(err(a[k], b[k]) for k in b)
            return float((PL.full(a) - b).abs().max() / max(float(b.abs().max()), 1e-30))

        out[case] = {"errors": {"forward": err(h_s, h), "prefill": err(m0, l0),
                                "decode": err(m1, l1), "cache": err(c2, cache)},
                     "unsharded_calls": calls, "sharded_calls": sharded}
        if f"{arch}/tokens" in npz.files and not change:
            saved[f"{arch}/hidden"] = PL.full(h_s).numpy()
            saved[f"{arch}/prefill"] = PL.full(m0).numpy()
    spy.close()
    if rank == 0:
        np.savez(os.path.join(d, "kernels_out.npz"), **saved)
    return out


if __name__ == "__main__":
    task, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    MESH.init_world("gloo", init_method=f"file://{os.path.join(d, task + '.store')}",
                    rank=rank, world_size=world)
    torch.manual_seed(0)
    res = {"train": train, "restore": restore, "infer": infer,
           "kernels": kernels}[task](d, rank)
    if rank == 0:
        with open(os.path.join(d, task + ".json"), "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()

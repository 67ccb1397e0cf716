"""The port's data pipeline, checkpoints, trainer and launchers against the
JAX package's, on the CPU.

* ``SyntheticLM`` batches: equal bit for bit (the same NumPy code);
* checkpoints: a train state saved by either package (float32 and bfloat16
  leaves) loads in the other, bit for bit;
* ``Trainer``: a run with an injected failure resumes from its checkpoint
  to the uninterrupted run's parameters bit for bit (the CPU's kernels are
  deterministic); ``StragglerStats`` counts the same events from the same
  step times as the JAX package's;
* the ``launch.train`` and ``launch.dryrun`` CLIs run at ``--smoke``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint import store as JSTORE
from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro.training import step as JS
from repro.training import trainer as JTR

from repro_torch import configs as C
from repro_torch.checkpoint import store as PSTORE
from repro_torch.data import pipeline as PP
from repro_torch.optim import adamw as A
from repro_torch.training import step as S
from repro_torch.training import trainer as PTR


def jax_flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-medium", "paligemma-3b",
                                  "falcon-mamba-7b"])
@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_reference_bit_for_bit(arch, hosts):
    index, count = hosts
    kw = dict(seq_len=24, global_batch=4, seed=3, host_index=index, host_count=count)
    ref = JP.SyntheticLM(JC.get_config(arch, smoke=True), JP.DataConfig(**kw))
    port = PP.SyntheticLM(C.get_config(arch, smoke=True), PP.DataConfig(**kw))
    for step in (0, 1, 17):
        want, got = ref.batch(step), port.batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_iterator_yields_the_steps_in_order():
    cfg = C.get_config("chatglm3-6b", smoke=True)
    src = PP.SyntheticLM(cfg, PP.DataConfig(seq_len=8, global_batch=2))
    it = PP.PrefetchIterator(src, start_step=5, depth=2)
    try:
        for want in (5, 6, 7):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"], src.batch(want)["tokens"])
    finally:
        it.close()


# --------------------------------------------------------------------------- #
# Checkpoints, both ways
# --------------------------------------------------------------------------- #


def _jax_state(arch, dtype=None):
    cfg = JC.get_config(arch, smoke=True)
    if dtype:
        cfg = cfg.replace(param_dtype=dtype)
    oc = JA.OptimizerConfig()
    state, _ = JS.init_state(jax.random.PRNGKey(1), cfg, oc)
    # moments that are not zeros, and a step count
    state["opt"]["m"] = jax.tree.map(lambda p: jnp.full(p.shape, 0.25, jnp.float32),
                                     state["params"])
    state["opt"]["step"] = jnp.int32(7)
    return cfg, oc, state


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "recurrentgemma-9b"])
def test_reference_checkpoint_loads_in_the_port(tmp_path, arch, dtype):
    jcfg, oc, state = _jax_state(arch, dtype)
    JSTORE.save(str(tmp_path), 3, state, extra={"loss": 1.5})
    arrays, extra = PSTORE.restore_tensors(str(tmp_path))
    assert extra == {"loss": 1.5, "step": 3}
    want = {"params/" + k: v for k, v in jax_flat(state["params"]).items()}
    want.update({"opt/" + k: v for k, v in jax_flat(state["opt"]).items()})
    assert arrays.keys() == want.keys()
    for k, v in want.items():
        got = arrays[k]
        if str(v.dtype) == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(), v.astype(np.float32))
        else:
            np.testing.assert_array_equal(got.numpy(), v)
    cfg = C.get_config(arch, smoke=True)
    if dtype:
        cfg = cfg.replace(param_dtype=dtype)
    pstate = S.state_from_arrays(cfg, arrays, A.OptimizerConfig(), device="cpu")
    assert int(pstate["opt"]["step"]) == 7
    for k, v in S.state_arrays(pstate).items():
        assert torch.equal(v, arrays[k]), k


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-medium"])
def test_port_checkpoint_loads_in_the_reference(tmp_path, arch, dtype):
    cfg = C.get_config(arch, smoke=True)
    jcfg = JC.get_config(arch, smoke=True)
    if dtype:
        cfg, jcfg = cfg.replace(param_dtype=dtype), jcfg.replace(param_dtype=dtype)
    pstate = S.init_state(cfg, A.OptimizerConfig(), generator=torch.Generator().manual_seed(2),
                          device="cpu")
    for t in pstate["opt"]["v"].values():
        t.fill_(0.5)
    arrays = S.state_arrays(pstate)
    PSTORE.save(str(tmp_path), 9, arrays, extra={"note": "port"})
    oc = JA.OptimizerConfig()
    template = jax.eval_shape(lambda: JS.init_state(jax.random.PRNGKey(0), jcfg, oc)[0])
    restored, extra = JSTORE.restore(str(tmp_path), template)
    assert extra == {"note": "port", "step": 9}
    got = {"params/" + k: v for k, v in jax_flat(restored["params"]).items()}
    got.update({"opt/" + k: v for k, v in jax_flat(restored["opt"]).items()})
    assert got.keys() == arrays.keys()
    for k, v in got.items():
        want = arrays[k]
        assert str(v.dtype) == str(want.dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(np.asarray(v, np.float32) if want.dtype == torch.bfloat16
                                      else v, want.float().numpy()
                                      if want.dtype == torch.bfloat16 else want.numpy())


def test_async_checkpointer_saves_a_copy_and_retains(tmp_path):
    ck = PSTORE.AsyncCheckpointer(str(tmp_path), keep=2)
    t = torch.arange(6, dtype=torch.float32)
    for step in (1, 2, 3):
        ck.save(step, {"w": t, "b": t.to(torch.bfloat16)}, extra={"s": step})
        t.add_(100.0)   # the saved tree is a copy taken before save returned
    ck.wait()
    assert PSTORE.latest_step(str(tmp_path)) == 3
    assert sorted(n for n in __import__("os").listdir(tmp_path)) == [
        "step_00000002", "step_00000003"]
    arrays, extra = PSTORE.restore_tensors(str(tmp_path))
    assert extra == {"s": 3, "step": 3}
    assert torch.equal(arrays["w"], torch.arange(6, dtype=torch.float32) + 200.0)
    assert arrays["b"].dtype == torch.bfloat16
    assert torch.equal(arrays["b"], (torch.arange(6) + 200.0).to(torch.bfloat16))


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #


def _trainer(tmp, fail_at=None, steps=6, device="cpu"):
    cfg = C.get_config("chatglm3-6b", smoke=True)
    tc = PTR.TrainerConfig(total_steps=steps, checkpoint_every=2,
                           checkpoint_dir=str(tmp), log_every=100)
    dc = PP.DataConfig(seq_len=16, global_batch=4)
    oc = A.OptimizerConfig(peak_lr=1e-2, warmup_steps=2, total_steps=steps)
    inj = PTR.FailureInjector(fail_at) if fail_at else None
    return PTR.Trainer(cfg, tc, dc, oc, seed=0, device=device, failure_injector=inj)


def test_trainer_resumes_to_the_uninterrupted_run(tmp_path):
    clean = _trainer(tmp_path / "clean").run()
    faulty_trainer = _trainer(tmp_path / "faulty", fail_at=[2, 5])
    faulty = faulty_trainer.run()
    assert clean["restarts"] == 0 and faulty["restarts"] == 2
    assert faulty["steps"] == clean["steps"] == 6
    # killed right after the checkpoint of step 2 was handed to the writer
    # (the restart waits for it), and at step 5, rerun from step 4's
    assert [m["step"] for m in faulty["metrics"]] == [0, 1, 2, 3, 4, 4, 5]
    want = S.state_arrays(clean["final_state"])
    got = S.state_arrays(faulty["final_state"])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    losses = {m["step"]: m["loss"] for m in clean["metrics"]}
    assert all(m["loss"] == losses[m["step"]] for m in faulty["metrics"])
    assert PSTORE.latest_step(str(tmp_path / "faulty")) == 6


def test_trainer_gives_up_after_max_restarts(tmp_path):
    tr = _trainer(tmp_path, steps=4)
    tr.tc.max_restarts = 1
    tr.failure_injector = PTR.FailureInjector([1])
    tr.failure_injector.maybe_fail = lambda step: (_ for _ in ()).throw(RuntimeError("x"))
    with pytest.raises(RuntimeError, match="exceeded max_restarts=1"):
        tr.run()


def test_straggler_stats_count_as_the_reference_does(tmp_path):
    times = [0.10, 0.11, 0.50, 0.09, 0.10, 0.90, 0.12, 0.31, 0.1]
    cfg = JC.get_config("chatglm3-6b", smoke=True)
    dc = JP.DataConfig(seq_len=8, global_batch=2)
    ref = JTR.Trainer(cfg, JTR.TrainerConfig(checkpoint_dir=str(tmp_path / "j")), dc)
    port = _trainer(tmp_path / "p")
    seen = []
    port.on_straggler = lambda step, dt, ewma: seen.append(step)
    for i, dt in enumerate(times):
        ref._track_step_time(i, dt)
        port._track_step_time(i, dt)
    assert dataclasses.asdict(port.stragglers) == dataclasses.asdict(ref.stragglers)
    assert port.stragglers.count == len(seen) > 0


# --------------------------------------------------------------------------- #
# Launchers
# --------------------------------------------------------------------------- #


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    assert train.main(["--arch", "falcon-mamba-7b", "--smoke", "--steps", "3",
                       "--seq-len", "16", "--batch", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps on cpu" in out and "tokens/s" in out
    assert PSTORE.latest_step(str(tmp_path)) == 3


def test_dryrun_launcher_runs_at_smoke(tmp_path, capsys):
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", "falcon-mamba-7b", "--smoke", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "dry-run complete: 4 cells extracted, 0 skipped, 0 failed" in out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"falcon-mamba-smoke__{s}__1x1.json" for s in
                           ("train_4k", "prefill_32k", "decode_32k", "long_500k"))
    assert dryrun.main(["--list", "--arch", "chatglm3-6b"]) == 0
    assert "SKIP" in capsys.readouterr().out

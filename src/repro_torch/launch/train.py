"""Training launcher.

The JAX package's ``repro/launch/train.py``: arch config -> mesh +
sharding variant -> sharded train state -> fault-tolerant ``Trainer``
(async checkpoints, restart, straggler monitor) -> step-indexed data
pipeline.  Under ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) each rank joins the
process group (NCCL on the card, Gloo on the CPU) and drives one card;
``--mesh auto`` takes the largest (data, model) grid of the world with a
model axis of at most 16, ``pod`` / ``multipod`` the production meshes.
Alone (no such environment) it runs on ``--device``: the card (the
default) or the CPU, unsharded as the JAX launcher is on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --smoke \\
      --steps 50 --seq-len 64 --batch 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \\
      --steps 4 --seq-len 448 --batch 4
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch chatglm3-6b \\
      --smoke --variant fsdp
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch import configs as C
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig


def maybe_init_distributed() -> bool:
    """Join the process group the launcher's environment describes (no-op
    alone); True when there is one."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        MESH.init_world()
        return True
    return False


def pick_mesh(mesh: str):
    """(mesh or None, multi_pod) over the world: None for one rank."""
    n = MESH.world_size()
    if mesh == "pod":
        return MESH.make_production_mesh(multi_pod=False), False
    if mesh == "multipod":
        return MESH.make_production_mesh(multi_pod=True), True
    if n == 1:
        return None, False
    # auto: largest (data, model) grid that fits the world
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0)
    return MESH.make_mesh((n // model, model), ("data", "model")), False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="chatglm3-6b", choices=C.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mesh", choices=("auto", "pod", "multipod"), default="auto")
    ap.add_argument("--variant", choices=SH.SHARDING_VARIANTS, default="zero1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    distributed = maybe_init_distributed()
    device = args.device
    if distributed and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    elif distributed:
        device = "cpu"
    mesh, multi_pod = pick_mesh(args.mesh) if distributed else (None, False)
    sc = SH.ShardingConfig(variant=args.variant, multi_pod=multi_pod)
    cfg = C.get_config(args.arch, smoke=args.smoke)
    oc = adamw.OptimizerConfig(peak_lr=args.peak_lr,
                               warmup_steps=max(args.steps // 10, 1),
                               total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir, accum=args.accum)
    dc = DataConfig(seq_len=args.seq_len, global_batch=args.batch, seed=args.seed)
    trainer = Trainer(cfg, tc, dc, oc, seed=args.seed, device=device,
                      mesh=mesh, sharding=sc if mesh is not None else None)
    out = trainer.run()
    losses = [m["loss"] for m in out["metrics"]]
    times = [m["step_time_s"] for m in out["metrics"]]
    tokens = args.batch * args.seq_len
    print(f"done: {out['steps']} steps on {trainer.device}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, last step {times[-1]:.3f} s "
          f"({tokens / times[-1]:.1f} tokens/s), {out['restarts']} restarts, "
          f"{out['straggler_events']} stragglers"
          + (f", on a {MESH.mesh_name(mesh)} mesh [{args.variant}]" if mesh else ""))
    if distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

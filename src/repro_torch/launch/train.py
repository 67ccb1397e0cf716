"""Training launcher.

The JAX package's ``repro/launch/train.py`` on one device: arch config ->
fault-tolerant ``Trainer`` (async checkpoints, restart, straggler monitor)
-> step-indexed data pipeline.  There is no distributed init and no mesh;
``--device`` picks the card (the default) or the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --smoke \\
      --steps 50 --seq-len 64 --batch 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \\
      --steps 4 --seq-len 448 --batch 4
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch import configs as C
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="chatglm3-6b", choices=C.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
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

    cfg = C.get_config(args.arch, smoke=args.smoke)
    oc = adamw.OptimizerConfig(peak_lr=args.peak_lr,
                               warmup_steps=max(args.steps // 10, 1),
                               total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir, accum=args.accum)
    dc = DataConfig(seq_len=args.seq_len, global_batch=args.batch, seed=args.seed)
    trainer = Trainer(cfg, tc, dc, oc, seed=args.seed, device=args.device)
    out = trainer.run()
    losses = [m["loss"] for m in out["metrics"]]
    times = [m["step_time_s"] for m in out["metrics"]]
    tokens = args.batch * args.seq_len
    print(f"done: {out['steps']} steps on {trainer.device}, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, last step {times[-1]:.3f} s "
          f"({tokens / times[-1]:.1f} tokens/s), {out['restarts']} restarts, "
          f"{out['straggler_events']} stragglers")
    return 0


if __name__ == "__main__":
    sys.exit(main())

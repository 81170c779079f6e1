"""Training launcher.

The port of ``repro/launch/train.py``, with the reference's flags and
``--device`` (default ``cuda``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --steps 20 [--device cpu]

Trains the architecture's (smoke) config on the synthetic stream through
the fault-tolerant ``Trainer``: float32 masters, the compute dtype's
casts, remat, the flash kernel on the card, AdamW and atomic
checkpoints in ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.synthetic import DataConfig
from repro_torch.models.transformer import TrainModel
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="inject a crash (fault-tolerance demos)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = TrainModel(cfg, device=args.device, init=False)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps, weight_decay=0.0)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.global_batch)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_async=args.ckpt_async, ckpt_dir=args.ckpt_dir)
    trainer = Trainer(model, opt_cfg, data_cfg, tcfg, device=args.device)
    params, opt, losses = trainer.run(crash_at_step=args.crash_at_step)
    if losses:
        print(f"steps={len(losses)} first_loss={losses[0]:.4f} "
              f"last_loss={losses[-1]:.4f} stragglers={trainer.stragglers}")
    else:
        print(f"steps=0 (restored at step {args.steps}: nothing left)")
    return losses


if __name__ == "__main__":
    main()

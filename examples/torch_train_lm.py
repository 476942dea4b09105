"""Train an LM end to end on the PyTorch port: data pipeline -> train step
-> AdamW -> checkpointing -> straggler watch.

Default is a ~10M-param model for a few hundred steps; pass --full for
the ~100M configuration (same code path, more FLOPs).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300       # the card
    PYTHONPATH=src python examples/torch_train_lm.py --steps 40 --device cpu
"""
import argparse
import math
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.train.trainer import Trainer, TrainerConfig, init_train_state

SMALL = ModelConfig(name="lm-10m", family="dense", num_layers=4, d_model=256,
                    num_heads=8, num_kv_heads=4, head_dim=32, d_ff=1024,
                    vocab_size=8192, scan_layers=False, remat="nothing")
FULL = ModelConfig(name="lm-100m", family="dense", num_layers=10, d_model=640,
                   num_heads=10, num_kv_heads=5, head_dim=64, d_ff=2560,
                   vocab_size=32000, scan_layers=True, remat="dots")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = FULL if args.full else SMALL
    model = build_model(cfg, device=args.device)
    n = sum(math.prod(v.shape) for v in model.init_shapes().values())
    print(f"model {cfg.name}: {n / 1e6:.1f}M params")
    tcfg = TrainerConfig(peak_lr=1e-3, warmup_steps=max(10, args.steps // 20),
                         total_steps=args.steps)
    state = init_train_state(
        model, torch.Generator(device=model.device).manual_seed(0), tcfg)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(model, tcfg,
                          checkpointer=Checkpointer(ckpt_dir, keep=2),
                          log_every=20)
        state, history = trainer.fit(state, data.iterator(), args.steps,
                                     checkpoint_every=100)
        trainer.checkpointer.wait()
        print(f"checkpoints kept: {trainer.checkpointer.steps()}")

    losses = [h["loss"] for h in history]
    print(f"loss: first10 {np.mean(losses[:10]):.4f} -> "
          f"last10 {np.mean(losses[-10:]):.4f}")
    if trainer.watch.events:
        print(f"straggler events: {len(trainer.watch.events)}")
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "loss did not improve"
    print("OK")


if __name__ == "__main__":
    main()

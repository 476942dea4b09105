"""LR schedules — the port of ``repro/optim/schedule.py``."""
from __future__ import annotations

import numpy as np
import torch


def cosine_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                       final_ratio: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_ratio * peak_lr`` at ``total_steps``.  The schedule
    takes a step (an int or a 0-d tensor) and returns a 0-d fp32 tensor
    on the step's device, computed in fp32 as the reference does."""
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        progress = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps),
            0.0, 1.0)
        cos = final_ratio + (1 - final_ratio) * 0.5 * (
            1 + torch.cos(np.pi * progress))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return schedule

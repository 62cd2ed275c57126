"""LR schedules, evaluated op by op in float32 on the host, as the
reference evaluates them on a traced step."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """``lr(step)`` -> a 0-dim float32 CPU tensor: linear warmup to
    ``peak_lr``, then a cosine decay to ``min_ratio * peak_lr``.  Python
    constants round to float32 where the reference's weak types do."""
    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
        warm = s * peak_lr / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = torch.cos(prog * math.pi) + 1
        cos = cos * ((1 - min_ratio) * 0.5) + min_ratio
        return torch.where(s < warmup_steps, warm, cos * peak_lr)
    return lr

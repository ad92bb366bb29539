"""LR schedules, the port of ``repro.optim.schedule``: pure functions of
step (DERIVABLE: never checkpointed).  ``WarmupCosine`` computes in f32
on the CPU in the reference's order of operations and returns a 0-d f32
tensor there; the train step hands it to the update as a scalar."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class WarmupCosine:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    final_frac: float = 0.1

    def __call__(self, step) -> torch.Tensor:
        s = torch.as_tensor(step).to("cpu", torch.float32)
        warm = self.peak_lr * s / max(self.warmup_steps, 1)
        prog = torch.clamp((s - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0, 1)
        cos = self.final_frac + (1 - self.final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < self.warmup_steps, warm, self.peak_lr * cos)

"""Learning-rate schedules, the reference's ``optim/schedule.py``: linear
warmup then cosine decay to ``final_frac`` of the peak, and a constant.
Each takes the int32 step tensor and returns an fp32 0-d tensor, computed
at fp32 in the reference's order, as its jitted train step computes it:
XLA turns the divisions by the constant step counts into multiplies by
their rounded reciprocals (ROADMAP F4's rewrite), and so does this.  The
cosine is the correctly rounded cosine of the fp32 angle (taken at f64);
XLA's fp32 cosine differs from it in the last bit at some angles (and
torch's fp32 cosine at more), so the decay is the reference's within a few
fp32 ulps and the warmup bit for bit."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s * (1.0 / max(warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps)
                           * (1.0 / max(total_steps - warmup_steps, 1)), 0, 1)
        angle = math.pi * prog
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(angle.double()).to(torch.float32))
        return peak_lr * torch.where(s < warmup_steps, warm, cos)

    return f


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)

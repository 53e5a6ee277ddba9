"""Learning-rate schedules: ``step`` (an int or an integer tensor) -> a
0-dim float32 tensor on the CPU.

``paper_halving_schedule`` is the paper's recipe: eta starts at 2^-3,
halves after the first 2 epochs, then every 4 epochs, floored at 2^-7.
"""
from __future__ import annotations

import math

import torch


def paper_halving_schedule(steps_per_epoch: int):
    def lr(step):
        epoch = torch.as_tensor(step) // steps_per_epoch
        halvings = torch.where(epoch < 2, 0, 1 + (epoch - 2) // 4)
        exp = torch.clamp(3 + halvings, 3, 7)
        return torch.pow(torch.tensor(2.0), -exp.to(torch.float32))
    return lr


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.0):
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(1, warmup)
        prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr


def constant_schedule(v: float):
    return lambda step: torch.tensor(v, dtype=torch.float32)

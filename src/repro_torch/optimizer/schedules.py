"""LR schedules: cosine and MiniCPM's Warmup-Stable-Decay (WSD)
(counterpart of ``repro/optimizer/schedules.py``).

WSD (arXiv:2404.06395): linear warmup → long stable plateau → short
(~10%) decay, here the linear-decay variant.  Each schedule maps a step
(an int) to a Python float, computed in double precision; the
reference's values are float32."""

from __future__ import annotations

import math


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * 0.5 * (1 + math.cos(math.pi * frac))
    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor: float = 0.1):
    decay_start = int(total * (1 - decay_frac))

    def lr(step) -> float:
        step = float(step)
        if step >= decay_start:
            frac = min(max((step - decay_start)
                           / max(total - decay_start, 1), 0.0), 1.0)
            return base_lr * (1 - (1 - floor) * frac)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        return base_lr
    return lr

"""Learning-rate schedules as step -> lr callables (twin of
``repro/optim/schedules.py``). The step is a Python int and the rate a
Python float, which the optimizers apply to f32 tensors as its f32
value."""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    """From lr at step 0 down a half cosine to final_frac·lr at
    ``total_steps``, then flat."""
    def f(step):
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to lr over ``warmup_steps`` steps (lr·(step+1)/warmup),
    then ``cosine_decay`` over the remaining steps."""
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        if step < warmup_steps:
            return lr * (step + 1) / max(warmup_steps, 1)
        return decay(step - warmup_steps)
    return f

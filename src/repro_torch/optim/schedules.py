"""Learning-rate schedules as step -> lr callables (twin of
``repro/optim/schedules.py``; only ``constant`` is ported so far)."""

from __future__ import annotations


def constant(lr: float):
    return lambda step: lr

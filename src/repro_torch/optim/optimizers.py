"""Functional optimizers (twin of ``repro/optim/optimizers.py``).

``Optimizer.update(grads, state, params)`` returns *updates to add to the
params* and the next state; grads, params and updates are dicts of tensors
keyed by parameter name. Only ``sgd`` is ported so far (the FEMNIST run's
optimizer); momentum, Adam, AdaGrad and Adafactor wait in the ROADMAP.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

Schedule = Callable[[int], float]
Tensors = Dict[str, torch.Tensor]


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]
    name: str = "opt"


def sgd(lr) -> Optimizer:
    """Plain SGD: update = −lr(step)·g, computed in f32 and cast back."""
    sched = _as_schedule(lr)

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        del params
        step = state["step"]
        # the f32 tensor times a Python float multiplies by lr rounded to
        # f32, as the reference's jnp.asarray(lr, float32) does
        upd = {k: (g.float() * -sched(step)).to(g.dtype)
               for k, g in grads.items()}
        return upd, {"step": step + 1}

    return Optimizer(init, update, "sgd")

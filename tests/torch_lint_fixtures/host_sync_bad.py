"""Seeded host-sync violations for the port's lint (SEED markers give the
expected rule and line). Never imported — parsed by
tests/test_torch_lint.py only, under a ``src/repro_torch/core/``
pseudo-path (the raw-timing rule fires on hot paths only)."""
import time

import torch
from torch import nn

from repro_torch.core.fedlite import make_train_step


class Head(nn.Module):
    def forward(self, x: torch.Tensor):
        scale = self._scale(x)
        return x * scale

    def _scale(self, x):
        return float(x.abs().max())  # SEED: host-sync-in-step


class Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clamp(-1, 1)

    @staticmethod
    def backward(ctx, g):
        if g.isfinite().all().item():  # SEED: host-sync-in-step
            return g
        return torch.zeros_like(g)


def train(model, opt, state, batches):
    step = make_train_step(model, opt)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(metrics["loss"].cpu())  # SEED: host-sync-in-loop
        lam = float(metrics.get("lam", 0.0))  # SEED: host-sync-in-loop
        print(metrics)  # SEED: raw-timing-in-hot-path
    return state, losses, lam


def submit_all(scheduler, results):
    def on_done(update):
        results.append(update.tolist())  # SEED: host-sync-in-callback

    t0 = time.perf_counter()  # SEED: raw-timing-in-hot-path
    scheduler.run(execute=on_done)
    return t0

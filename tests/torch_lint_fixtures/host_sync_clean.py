"""Clean counterpart of host_sync_bad.py: shapes and dtypes are host
metadata, Python scalars are not tensors, the loop keeps its outputs on
the card and copies them once, and a reviewed sync is suppressed."""
import torch
from torch import nn

from repro_torch.core.fedlite import make_train_step


class Head(nn.Module):
    def __init__(self, eps: float):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, groups: int = 1):
        n = int(x.shape[0])
        wide = bool(x.dtype == torch.bfloat16)
        return x.reshape(n // groups, -1) * float(self.eps) + wide


class Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clamp(-1, 1)

    @staticmethod
    def backward(ctx, g):
        return g


def train(model, opt, state, batches):
    step = make_train_step(model, opt)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(metrics["loss"])
    return state, torch.stack(losses).cpu()


def report(model, opt, state, batches):
    step = make_train_step(model, opt)
    for b in batches:
        state, metrics = step(state, b)
        # the user asked for a line per step
        loss = float(metrics["loss"])  # fedlint: disable=host-sync-in-loop
        print(loss)  # fedlint: disable=raw-timing-in-hot-path
    return state

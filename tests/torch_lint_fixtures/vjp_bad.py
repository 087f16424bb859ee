"""Seeded autograd.Function contract violations. Never imported."""
import torch


class NotStatic(torch.autograd.Function):
    def forward(ctx, x):  # SEED: autograd-staticmethod
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2


class NoBackward(torch.autograd.Function):  # SEED: autograd-missing-backward
    @staticmethod
    def forward(ctx, x):
        return x + 1


class ShortGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        return x * lam, (x * x).sum()

    @staticmethod
    def backward(ctx, g):  # SEED: autograd-bwd-arity
        return g, None


class LongReturn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2, None, None  # SEED: autograd-bwd-return-arity

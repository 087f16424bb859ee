"""autograd.Function classes that keep the contract. Never imported."""
import torch


class Correction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, lam, cfg):
        ctx.save_for_backward(z)
        return z * 2, (z * z).sum()

    @staticmethod
    def backward(ctx, g, _g_metric):
        (z,) = ctx.saved_tensors
        return g + z, None, None


class Carry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, state):
        return (z, *state)

    @staticmethod
    def backward(ctx, g, *_state):
        return g, None


class SetupContext(torch.autograd.Function):
    @staticmethod
    def forward(x, k):
        return x * k

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.k = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None

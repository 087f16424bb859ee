"""Input rounding of a product, for the reference and its control.

``"float32"`` and ``"bfloat16"`` leave a product's inputs as they are. The
control's precisions round them first, as the card's lower-precision
products do, and accumulate in f32:

  * ``"tf32"``: each f32 input to 10 mantissa bits, to nearest (TF32);
  * ``"fp8"``: each input to float8 e4m3 under one scale per tensor (its
    largest magnitude to 448), and back.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    xi = x.float().contiguous().view(torch.int32)
    return ((xi + 0x1000) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    scale = xf.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale


class _Rounded(torch.autograd.Function):
    """The rounded input in the forward pass; the gradient passes
    straight through, so the backward products see the rounded values
    they saved."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundedProduct(torch.autograd.Function):
    """x @ w with both inputs rounded; the backward rounds them again
    rather than saving the rounded copies, so a product of a large weight
    holds no second copy of it."""

    @staticmethod
    def forward(ctx, x, w, fn):
        ctx.save_for_backward(x, w)
        ctx.fn = fn
        return fn(x) @ fn(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g @ ctx.fn(w).transpose(-1, -2)
        gw = ctx.fn(x).reshape(-1, x.shape[-1]).transpose(0, 1) \
            @ g.reshape(-1, g.shape[-1])
        return gx, gw.reshape(w.shape), None


def product(precision: str):
    """``x @ w`` (w 2-D) with the inputs rounded as ``precision`` does."""
    fn = {"float32": None, "bfloat16": None, "tf32": round_tf32,
          "fp8": round_fp8}[precision]
    if fn is None:
        return torch.matmul
    return lambda x, w: _RoundedProduct.apply(x, w, fn)


def rounder(precision: str):
    """The input rounding of ``precision``: a function of a tensor."""
    fn = {"float32": None, "bfloat16": None, "tf32": round_tf32,
          "fp8": round_fp8}[precision]
    if fn is None:
        return lambda x: x
    return lambda x: _Rounded.apply(x, fn)

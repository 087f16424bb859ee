"""FedLite's gradient-corrected quantization layer (paper §4.2, eq. 5).

Twin of ``repro/core/correction.py``. The forward pass runs the grouped PQ
and emits z̃; the backward pass adds λ·(z − z̃) to the incoming gradient:

    g̃_z  =  ∂h/∂z̃  +  λ·(z − z̃)                                   (eq. 5)

λ = 0 is the straight-through estimator. The reference's ``jax.custom_vjp``
becomes a ``torch.autograd.Function``. K-means runs once per forward and
backward: the forward saves the residual its fused encode produced, and the
backward reuses it.

z is (C, n, d), one PQ problem set per client (see ``core/quantizer.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.quantizer import PQConfig, quantize


class _QuantizeWithCorrection(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, lam, cfg):
        qb = quantize(z, cfg)
        lam = lam.float() if torch.is_tensor(lam) else \
            torch.full((), lam, dtype=torch.float32, device=z.device)
        ctx.save_for_backward(qb.residual, lam)
        ctx.mark_non_differentiable(qb.distortion)
        return qb.dequantized, qb.distortion

    @staticmethod
    def backward(ctx, g, _g_distortion):
        residual, lam = ctx.saved_tensors
        # eq. (5); λ and the config get no gradient, nor does the distortion
        # (a metric): its cotangent is dropped
        return g + lam.to(g.dtype) * residual.to(g.dtype), None, None


def quantize_with_correction_stats(z: torch.Tensor, lam, cfg: PQConfig):
    """(z̃ with the eq.-5 backward, per-client distortion (C,)).

    ``lam`` is a Python float or a 0-dim tensor, so a scheduled λ works."""
    return _QuantizeWithCorrection.apply(z, lam, cfg)


def quantize_with_correction(z: torch.Tensor, lam,
                             cfg: PQConfig) -> torch.Tensor:
    """z̃ with the eq.-5 backward."""
    return quantize_with_correction_stats(z, lam, cfg)[0]

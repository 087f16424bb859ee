"""FedLite's gradient-corrected quantization layer (paper §4.2, eq. 5).

Twin of ``repro/core/correction.py``. The forward pass runs the grouped PQ
and emits z̃; the backward pass adds λ·(z − z̃) to the incoming gradient:

    g̃_z  =  ∂h/∂z̃  +  λ·(z − z̃)                                   (eq. 5)

λ = 0 is the straight-through estimator. The reference's ``jax.custom_vjp``
becomes a ``torch.autograd.Function``. K-means runs once per forward and
backward: the forward saves the residual its fused encode produced, and the
backward reuses it.

z is (C, n, d), one PQ problem set per client (see ``core/quantizer.py``).
The direction-agnostic hooks (any codec, the downlink, and the
state-carrying uplink) live in ``core/compressors.py``.
"""

from __future__ import annotations

import torch

from typing import Optional

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


class _QuantizeDownlink(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, cfg):
        ctx.cfg = cfg
        return z.view_as(z)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, ctx.cfg).dequantized.to(g.dtype), None


def quantize_downlink(z: torch.Tensor, cfg: PQConfig) -> torch.Tensor:
    """The downlink compressed by the grouped PQ: identity forward; the
    backward pass quantizes the activation cotangent (C, n, d), per client,
    before it reaches the client. ``core/compressors.compress_downlink``
    is the general form (any codec)."""
    return _QuantizeDownlink.apply(z, cfg)


def quantize_with_stats(z: torch.Tensor, lam, cfg: PQConfig,
                        generator: Optional[torch.Generator] = None):
    """``quantize_with_correction`` plus non-differentiable stats for
    logging: the per-client distortion (C,), and the message bits and
    compression ratio of one client's n vectors. The seeding stays
    deterministic: ``generator`` is not used, as the reference ignores its
    key."""
    del generator
    z_tilde, distortion = quantize_with_correction_stats(z, lam, cfg)
    n, d = z.shape[1], z.shape[-1]
    return z_tilde, {
        "pq_distortion": distortion,
        "pq_message_bits": cfg.message_bits(n, d),
        "pq_compression_ratio": cfg.compression_ratio(n, d),
    }

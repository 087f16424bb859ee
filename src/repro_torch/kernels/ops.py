"""Public wrappers around the kernels (twin of ``repro/kernels/ops.py``).

They take any L and pad the codebook to a multiple of 8 centroids, masked
by ``lmask`` so that a padded centroid never wins (it scores ``NEG``), as
the reference's ``_pad_centroids`` does. Rows need no padding: the CUDA
kernels mask their ragged last tile themselves, and rows that the caller
pads (``core.kmeans.lloyd`` pads to a chunk multiple) carry weight 0.

Every input has a leading problem axis P (clients x codebook groups): the
reference vmaps one problem per call, the kernels take all of them in one
launch.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lloyd_update import lloyd_update_kernel
from repro_torch.kernels.pq_quantize import pq_quantize_kernel


def _pad_centroids(c: torch.Tensor, lane: int = 8):
    """(P, L, D) -> ((P, L_pad, D) f32 contiguous, lmask (L_pad,) f32)."""
    l = c.shape[1]
    pad = (-l) % lane
    lmask = (torch.arange(l + pad, device=c.device) < l).float()
    cp = torch.nn.functional.pad(c.float(), (0, 0, 0, pad))
    return cp.contiguous(), lmask


def pq_quantize(x: torch.Tensor, centroids: torch.Tensor):
    """Fused assign + dequantize + residual.

    x (P, N, D) f32; centroids (P, L, D). Returns (z̃ (P, N, D) x.dtype,
    residual (P, N, D) f32, codes (P, N) int32)."""
    cp, lmask = _pad_centroids(centroids)
    return pq_quantize_kernel(x.contiguous(), cp, lmask)


def lloyd_update(x: torch.Tensor, centroids: torch.Tensor,
                 weights: Optional[torch.Tensor] = None):
    """One Lloyd iteration's statistics in one sweep over x.

    x (P, N, D) f32; centroids (P, L, D); weights (P, N) (padding rows
    carry 0; None = all 1). Returns (dsums (P, L, D) f32 = Σ onehot·(x −
    c_old), counts (P, L) f32)."""
    l = centroids.shape[1]
    if weights is None:
        weights = torch.ones(x.shape[:2], device=x.device)
    cp, lmask = _pad_centroids(centroids)
    dsums, counts = lloyd_update_kernel(x.contiguous(),
                                        weights.float().contiguous(), cp,
                                        lmask)
    return dsums[:, :l], counts[:, :l]

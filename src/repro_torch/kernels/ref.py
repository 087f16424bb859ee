"""Plain PyTorch versions of the kernels (twin of ``repro/kernels/ref.py``).

The CPU tests run these, the ``"torch"`` quantizer backend runs them on any
device, and ``chip_smoke.py`` holds each CUDA kernel against them on the
card. They carry a leading problem axis: ``x`` is ``(..., N, D)``,
``centroids`` ``(..., L, D)``, ``weights`` ``(..., N)``; ``lmask`` is one
``(L,)`` mask shared by every problem (1.0 = valid centroid).

Assignment is written in the score form the kernels compute,
``argmax_l (2·x·c_l − ‖c_l‖²)`` -- the argmin of ``‖x − c_l‖²`` without
the constant ``‖x‖²`` -- with masked centroids scored ``NEG`` so that they
never win, and ties going to the first index, as ``jnp.argmax`` and
``torch.argmax`` both do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def _gather_rows(c: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """c[..., codes[..., i], :] for a (..., L, D) codebook and (..., N) codes."""
    idx = codes.unsqueeze(-1).expand(*codes.shape, c.shape[-1])
    return torch.gather(c, -2, idx)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor,
                      lmask: torch.Tensor):
    """codes (..., N) int64 + clamped squared distances (..., N) f32."""
    xf = x.float()
    cf = centroids.float()
    scores = 2.0 * (xf @ cf.transpose(-1, -2)) \
        - (cf * cf).sum(-1).unsqueeze(-2)
    scores = torch.where(lmask.to(scores.device) > 0, scores, NEG)
    codes = scores.argmax(-1)
    best = scores.amax(-1)
    return codes, ((xf * xf).sum(-1) - best).clamp_min(0.0)


def near_ties(x: torch.Tensor, centroids: torch.Tensor, lmask: torch.Tensor,
              rtol: float = 1e-5) -> torch.Tensor:
    """Rows (..., N) whose best two scores differ by <= rtol·(1 + |best|):
    there a kernel's FMA order may pick either code."""
    cf = centroids.float()
    scores = 2.0 * (x.float() @ cf.transpose(-1, -2)) \
        - (cf * cf).sum(-1).unsqueeze(-2)
    scores = torch.where(lmask.to(scores.device) > 0, scores, NEG)
    top = scores.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) <= rtol * (1 + top[..., 0].abs())


def pq_quantize_ref(x: torch.Tensor, centroids: torch.Tensor,
                    lmask: torch.Tensor):
    """(z̃ in x.dtype, residual x − z̃ in f32, codes int32)."""
    codes, _ = kmeans_assign_ref(x, centroids, lmask)
    zt = _gather_rows(centroids.float(), codes)
    resid = x.float() - zt
    return zt.to(x.dtype), resid, codes.to(torch.int32)


def lloyd_update_ref(x: torch.Tensor, weights: torch.Tensor,
                     centroids: torch.Tensor, lmask: torch.Tensor):
    """One Lloyd iteration's statistics, deviation-accumulated:
    dsums[l] = Σ_i w_i·1[codes_i = l]·(x_i − c_l), counts[l] = Σ_i w_i·1[..]."""
    codes, _ = kmeans_assign_ref(x, centroids, lmask)
    cf = centroids.float()
    onehot = F.one_hot(codes, cf.shape[-2]).float() \
        * weights.float().unsqueeze(-1)
    delta = x.float() - _gather_rows(cf, codes)   # exact 0 on exact cover
    return onehot.transpose(-1, -2) @ delta, onehot.sum(-2)

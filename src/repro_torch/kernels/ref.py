"""Plain PyTorch versions of the kernels (twin of ``repro/kernels/ref.py``).

The CPU tests run these, the ``"torch"`` backends run them on any device,
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They carry a leading problem axis: ``x`` is ``(..., N, D)``,
``centroids`` ``(..., L, D)``, ``weights`` ``(..., N)``; ``lmask`` is one
``(L,)`` mask shared by every problem (1.0 = valid centroid; None = every
centroid valid), and ``weights`` may be None (every weight 1). The scalar
quantizer and the packers take ``(P, N)`` values or codes, one range or
one stream of words per problem. Flash attention takes the kernel's
``(B·H, S, hd)`` layout.

Assignment is written in the score form the kernels compute,
``argmax_l (2·x·c_l − ‖c_l‖²)`` -- the argmin of ``‖x − c_l‖²`` without
the constant ``‖x‖²`` -- with masked centroids scored ``NEG`` so that they
never win, and ties going to the first index, as ``jnp.argmax`` and
``torch.argmax`` both do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30


def _gather_rows(c: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """c[..., codes[..., i], :] for a (..., L, D) codebook and (..., N) codes."""
    idx = codes.unsqueeze(-1).expand(*codes.shape, c.shape[-1])
    return torch.gather(c, -2, idx)


def _scores(xf: torch.Tensor, centroids: torch.Tensor,
            lmask: Optional[torch.Tensor]) -> torch.Tensor:
    """2·x·c_l − ‖c_l‖² (..., N, L), masked centroids scored NEG."""
    cf = centroids.float()
    scores = 2.0 * (xf @ cf.transpose(-1, -2)) \
        - (cf * cf).sum(-1).unsqueeze(-2)
    if lmask is None:
        return scores
    return torch.where(lmask.to(scores.device) > 0, scores, NEG)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor,
                      lmask: Optional[torch.Tensor] = None):
    """codes (..., N) int64 + clamped squared distances (..., N) f32."""
    xf = x.float()
    scores = _scores(xf, centroids, lmask)
    codes = scores.argmax(-1)
    best = scores.amax(-1)
    return codes, ((xf * xf).sum(-1) - best).clamp_min(0.0)


def near_ties(x: torch.Tensor, centroids: torch.Tensor,
              lmask: Optional[torch.Tensor] = None,
              rtol: float = 1e-5) -> torch.Tensor:
    """Rows (..., N) whose best two scores differ by <= rtol·(1 + |best|):
    there a kernel's FMA order may pick either code."""
    scores = _scores(x.float(), centroids, lmask)
    top = scores.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) <= rtol * (1 + top[..., 0].abs())


def pq_quantize_ref(x: torch.Tensor, centroids: torch.Tensor,
                    lmask: Optional[torch.Tensor] = None):
    """(z̃ in x.dtype, residual x − z̃ in f32, codes int32)."""
    codes, _ = kmeans_assign_ref(x, centroids, lmask)
    zt = _gather_rows(centroids.float(), codes)
    resid = x.float() - zt
    return zt.to(x.dtype), resid, codes.to(torch.int32)


def scalar_quantize_ref(x: torch.Tensor, lo: torch.Tensor,
                        scale: torch.Tensor, bits: int):
    """Uniform b-bit quantize + dequantize of P problems, each with its own
    range: x (P, N) f32, lo and scale (P,) f32.

    codes = clip(round((x − lo)/scale), 0, 2^b − 1) with half-to-even
    rounding (int32); recon = lo + codes·scale (f32), a multiply and then an
    add, each rounded on its own, as the reference's jnp formula."""
    levels = float((1 << bits) - 1)
    lo_ = lo.float().unsqueeze(-1)
    scale_ = scale.float().unsqueeze(-1)
    codes = torch.round((x.float() - lo_) / scale_).clamp(0.0, levels)
    return codes.to(torch.int32), lo_ + codes * scale_


def _check_pack_bits(bits: int) -> int:
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(f"packing needs bits in {{1, 2, 4, 8, 16}}, got "
                         f"{bits}")
    return 32 // bits


def pack_codes_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack P streams of codes (P, N) at ``bits`` bits each into
    little-endian 32-bit words, code j of a word at bits [j·b, (j+1)·b);
    each stream is padded with 0 to whole words. Returns (P, ⌈N·b/32⌉)
    int32 holding the words' bit patterns. A code keeps its low ``bits``
    bits, as the wire's LSB-first bit stream does."""
    per_word = _check_pack_bits(bits)
    p, n = codes.shape
    words = -(-n // per_word)
    c = F.pad(codes.long() & ((1 << bits) - 1), (0, words * per_word - n))
    shifts = torch.arange(per_word, device=codes.device) * bits
    w = (c.reshape(p, words, per_word) << shifts).sum(-1)   # disjoint bits
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def unpack_codes_ref(words: torch.Tensor, count: int,
                     bits: int) -> torch.Tensor:
    """Inverse of ``pack_codes_ref``: (P, W) words -> (P, count) int32."""
    per_word = _check_pack_bits(bits)
    p = words.shape[0]
    shifts = torch.arange(per_word, device=words.device) * bits
    w = words.long() & 0xFFFFFFFF
    codes = (w.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)
    return codes.reshape(p, -1)[:, :count].to(torch.int32)


def lloyd_update_ref(x: torch.Tensor, weights: Optional[torch.Tensor],
                     centroids: torch.Tensor,
                     lmask: Optional[torch.Tensor] = None):
    """One Lloyd iteration's statistics, deviation-accumulated:
    dsums[l] = Σ_i w_i·1[codes_i = l]·(x_i − c_l), counts[l] = Σ_i w_i·1[..]."""
    codes, _ = kmeans_assign_ref(x, centroids, lmask)
    cf = centroids.float()
    onehot = F.one_hot(codes, cf.shape[-2]).float()
    if weights is not None:
        onehot = onehot * weights.float().unsqueeze(-1)
    delta = x.float() - _gather_rows(cf, codes)   # exact 0 on exact cover
    return onehot.transpose(-1, -2) @ delta, onehot.sum(-2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        num_q_heads: int, num_kv_heads: int, scale: float,
                        window=None) -> torch.Tensor:
    """Causal GQA attention at positions 0..S−1, optionally windowed.

    q (B·H, S, hd), k and v (B·Kv, S, hd); query row bh reads KV row
    ``(bh // H)·Kv + (bh % H) // G`` with G = H / Kv. Scores, softmax and
    P·V are f32 throughout; a score is kept iff qpos ≥ kpos and (window is
    None or qpos − kpos < window), else it is ``NEG``. Returns
    (B·H, S, hd) in ``q.dtype``. Any S: the mask is by index."""
    bh, s, _ = q.shape
    h, kv = num_q_heads, num_kv_heads
    rows = torch.arange(bh, device=q.device)
    kv_rows = (rows // h) * kv + (rows % h) // (h // kv)
    kf, vf = k.float()[kv_rows], v.float()[kv_rows]
    scores = (q.float() @ kf.transpose(-1, -2)) * scale
    pos = torch.arange(s, device=q.device)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= (pos[:, None] - pos[None, :]) < window
    scores = torch.where(keep, scores, NEG)
    return (torch.softmax(scores, -1) @ vf).to(q.dtype)

"""Public wrappers around the kernels (twin of ``repro/kernels/ops.py``).

The k-means wrappers (``kmeans_assign``, ``pq_quantize``,
``lloyd_update``) take any L and hand the codebook to the kernels as it
is, with no mask: unlike the reference's ``_pad_centroids``, the kernels
need no padded codebook (``_pad_centroids`` stays for callers that build
a masked one to test the kernels' mask). Rows need no padding either: the
CUDA kernels mask their ragged last tile themselves, and ``lloyd_update``
without weights reads none. ``kmeans_assign``, ``pq_quantize``,
``lloyd_update`` and ``scalar_quantize`` read x in f32 or bf16 as it comes,
with no f32 copy (on the card, other float dtypes are upcast to f32 first).

Every input has a leading problem axis P (clients x codebook groups for
k-means, clients for scalar quantization and packing): the reference
vmaps one problem per call, the kernels take all of them in one launch.
``flash_attention`` takes the reference's (B·H, S, hd) layout and
``flash_attention_strided`` the projections' (B, S, H, hd) views, both at
any S: the kernel masks its ragged last tile, so no padded copy is made.

The kernels take raw pointers, so every wrapper refuses a DTensor: under
a mesh the models hand them each rank's local block (``sharding/ctx.
local``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                 flash_attention_kernel)
from repro_torch.kernels.kmeans_assign import kmeans_assign_kernel
from repro_torch.kernels.lloyd_update import lloyd_update_kernel
from repro_torch.kernels.pq_quantize import pq_quantize_kernel
from repro_torch.kernels.scalar_quant import (pack_codes_kernel,
                                              scalar_quantize_kernel,
                                              unpack_codes_kernel)


def _pad_centroids(c: torch.Tensor, lane: int = 8):
    """(P, L, D) -> ((P, L_pad, D) f32 contiguous, lmask (L_pad,) f32)."""
    l = c.shape[1]
    pad = (-l) % lane
    lmask = (torch.arange(l + pad, device=c.device) < l).float()
    cp = torch.nn.functional.pad(c.float(), (0, 0, 0, pad))
    return cp.contiguous(), lmask


def _local(name: str, *ts: Optional[torch.Tensor]) -> None:
    """Raise on a DTensor: a kernel reads one device's memory, and a
    DTensor's pointer is not its local block's."""
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{name}: got a DTensor; run the kernel on the local "
                        f"shards (sharding.ctx.local)")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as the streaming kernels read it: f32 or bf16, contiguous (the
    plain versions on the CPU take any float dtype)."""
    if x.is_cuda and x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return x.contiguous()


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid and squared distance of every row.

    x (P, N, D) f32 or bf16, read as it is (no f32 copy); centroids
    (P, L, D). Returns (codes (P, N) int32, sqdist (P, N) f32 =
    max(‖x‖² − best score, 0))."""
    _local("kmeans_assign", x, centroids)
    return kmeans_assign_kernel(_rows(x), centroids.float().contiguous())


def pq_quantize(x: torch.Tensor, centroids: torch.Tensor):
    """Fused assign + dequantize + residual.

    x (P, N, D) f32 or bf16; centroids (P, L, D). Returns (z̃ (P, N, D)
    x.dtype, residual (P, N, D) f32, codes (P, N) int32)."""
    _local("pq_quantize", x, centroids)
    return pq_quantize_kernel(_rows(x), centroids.float().contiguous())


def lloyd_update(x: torch.Tensor, centroids: torch.Tensor,
                 weights: Optional[torch.Tensor] = None):
    """One Lloyd iteration's statistics in one sweep over x.

    x (P, N, D) f32 or bf16; centroids (P, L, D); weights (P, N) (padding
    rows carry 0; None = all 1, and no weights are read). Returns (dsums
    (P, L, D) f32 = Σ onehot·(x − c_old), counts (P, L) f32)."""
    _local("lloyd_update", x, centroids, weights)
    if weights is not None:
        weights = weights.float().contiguous()
    return lloyd_update_kernel(_rows(x), weights,
                               centroids.float().contiguous())


def scalar_quantize(x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                    bits: int):
    """Fused uniform b-bit quantize + dequantize, one range per problem.

    x (P, N) any float dtype, f32 and bf16 read as they are (no f32 copy);
    lo and scale (P,). Returns (codes (P, N) int32 in [0, 2^bits), recon
    (P, N) f32)."""
    _local("scalar_quantize", x, lo, scale)
    return scalar_quantize_kernel(_rows(x), lo.float().contiguous(),
                                  scale.float().contiguous(), bits)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack each problem's codes (P, N) at ``bits`` in {1, 2, 4, 8, 16} bits
    into little-endian 32-bit words: (P, ⌈N·bits/32⌉) int32 bit patterns,
    byte for byte the wire's LSB-first stream of each problem."""
    _local("pack_codes", codes)
    return pack_codes_kernel(codes.to(torch.int32).contiguous(), bits)


def unpack_codes(words: torch.Tensor, count: int, bits: int) -> torch.Tensor:
    """Inverse of ``pack_codes``: (P, W) words -> (P, count) int32 codes."""
    _local("unpack_codes", words)
    return unpack_codes_kernel(words.to(torch.int32).contiguous(), count,
                               bits)


def _forward_only(*ts: torch.Tensor) -> None:
    """The flash kernel has no backward pass (nor has the TPU kernel), and
    a silent wrong gradient is worse than an error."""
    if any(t.requires_grad for t in ts):
        raise ValueError("flash_attention: forward only; an input requires "
                         "grad (use models.attention.row_block_attention "
                         "for training)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_q_heads: int, num_kv_heads: int, scale: float,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA attention at positions 0..S−1, forward only.

    q (B·H, S, hd), k and v (B·Kv, S, hd), f32 or bf16; returns (B·H, S,
    hd) in q.dtype. Raises on an input that requires grad."""
    _local("flash_attention", q, k, v)
    _forward_only(q, k, v)
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), num_q_heads=num_q_heads,
                                  num_kv_heads=num_kv_heads, scale=scale,
                                  window=window)


def flash_attention_strided(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float,
                            window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` on the projections' layout, without copies:
    q (B, S, H, hd), k and v (B, S, Kv, hd) views with the head dim
    contiguous; returns (B, S, H, hd) in q.dtype. Raises on an input that
    requires grad."""
    _local("flash_attention", q, k, v)
    _forward_only(q, k, v)
    return flash_attention_bshd(q, k, v, scale=scale, window=window)

"""CUDA kernel: causal grouped-query flash attention (forward only).

Twin of ``repro/kernels/flash_attention.py`` (the Pallas ``_flash_kernel``).
The kernel is ``csrc/flash_attention.cu``; its plain version is
``ref.flash_attention_ref``. Both compute, for query row bh of q
(B·H, S, hd) against KV row ``(bh // H)·Kv + (bh % H) // G`` of k and v
(B·Kv, S, hd), causal attention at positions 0..S−1 with an optional
sliding window, in f32, returning q's dtype (f32 or bf16).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. The kernel takes any S (it masks the
ragged last tile itself) and hd <= 128. Its online softmax sums in another
order than the plain version's softmax, so the two agree to f32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HD = 128

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float] \
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def check_attention_inputs(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, num_q_heads: int,
                           num_kv_heads: int) -> None:
    """What the kernel takes: q (B·H, S, hd) and k, v (B·Kv, S, hd), one
    dtype (f32 or bf16), contiguous, on one CUDA device, hd <= 128."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: takes f32 or bf16, got "
                         f"{q.dtype}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous() or t.dim() != 3:
            raise ValueError(f"flash_attention: q, k and v must be "
                             f"contiguous 3-d {q.dtype} tensors on "
                             f"{q.device}; got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    h, kv = num_q_heads, num_kv_heads
    bh, s, hd = q.shape
    if h < 1 or kv < 1 or h % kv or bh % h \
            or k.shape != (bh // h * kv, s, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"H={h}, Kv={kv}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_attention: the kernel takes hd <= {MAX_HD}, "
                         f"got {hd}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, num_q_heads: int,
                           num_kv_heads: int, scale: float,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B·H, S, hd), k and v (B·Kv, S, hd) -> (B·H, S, hd) in q.dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, num_q_heads=num_q_heads,
                                       num_kv_heads=num_kv_heads,
                                       scale=scale, window=window)
    check_attention_inputs(q, k, v, num_q_heads, num_kv_heads)
    bh, s, hd = q.shape
    lib = _build.load("flash_attention", "flash_attention_launch", _ARGTYPES)
    out = torch.empty_like(q)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, hd,
        num_q_heads, num_kv_heads, scale, 0 if window is None else window,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{rc}")
    _build.count("flash_attention")
    return out

"""CUDA kernel: causal grouped-query flash attention (forward only).

Twin of ``repro/kernels/flash_attention.py`` (the Pallas ``_flash_kernel``).
The kernel is ``csrc/flash_attention.cu``; its plain version is
``ref.flash_attention_ref``. Both compute, for query row bh of q
(B·H, S, hd) against KV row ``(bh // H)·Kv + (bh % H) // G`` of k and v
(B·Kv, S, hd), causal attention at positions 0..S−1 with an optional
sliding window, in f32, returning q's dtype (f32 or bf16).

Two entries: ``flash_attention_kernel`` takes the reference's
(B·H, S, hd) layout; ``flash_attention_bshd`` (the strided entry) takes
the projections' (B, S, H, hd) and (B, S, Kv, hd) views and returns
(B, S, H, hd), with no transposing copy: the kernel reads every operand
through its batch, head and sequence strides.

The kernel has two instances, picked by ``flash_route(dtype, hd)``:
``tensor_core`` (bf16 with hd a multiple of 16: wgmma products, P rounded
to bf16 before P·V as the reference's model path rounds it) and
``cuda_core`` (f32, keeping the reference's f32 numerics, and bf16 at
other hd). Both count their launches as ``flash_attention``.

On a CPU tensor the wrappers compute the plain version; on a CUDA tensor
they launch the kernel or raise. The kernel takes any S (it masks the
ragged last tile itself) and hd <= 128. Its online softmax sums in another
order than the plain version's softmax, so the two agree to f32 rounding
(and, on the tensor-core route, to P's bf16 rounding).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

MAX_HD = 128

_HEAD = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_float, ctypes.c_int]
_STRIDES = [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
_TC_ARGTYPES = _HEAD + _STRIDES
_CC_ARGTYPES = _HEAD + [ctypes.c_int] + _STRIDES


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel instance for a dtype and head dim: ``"tensor_core"`` for
    bf16 with hd a multiple of 16 (at most 128), else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and hd % 16 == 0 and 1 <= hd <= MAX_HD:
        return "tensor_core"
    return "cuda_core"


def check_attention_inputs(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor) -> None:
    """What the kernel takes: q and o (B, H, S, hd), k and v (B, Kv, S, hd)
    views of one dtype (f32 or bf16) on one CUDA device, the head dim
    contiguous, hd <= 128, H a multiple of Kv; on the tensor-core route
    every stride a multiple of 8 elements and every pointer 16-byte
    aligned (what its TMA tensor maps take)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: takes f32 or bf16, got "
                         f"{q.dtype}")
    for t in (q, k, v, o):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4 \
                or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: q, k, v and the output must "
                             f"be {q.dtype} on {q.device} with the head dim "
                             f"contiguous; got {t.dtype} {tuple(t.shape)} "
                             f"strides {t.stride()} on {t.device}")
    b, h, s, hd = q.shape
    kv = k.shape[1]
    if kv < 1 or h % kv or k.shape != (b, kv, s, hd) \
            or v.shape != k.shape or o.shape != q.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(o.shape)} do not fit (B, H, S, hd) and "
                         f"(B, Kv, S, hd) with H a multiple of Kv")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_attention: the kernel takes hd <= {MAX_HD}, "
                         f"got {hd}")
    if flash_route(q.dtype, hd) == "tensor_core":
        for t in (q, k, v, o):
            if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
                raise ValueError(f"flash_attention: the tensor-core route "
                                 f"needs strides that are multiples of 8 and "
                                 f"16-byte aligned pointers; got strides "
                                 f"{t.stride()}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, scale: float, window: Optional[int]) -> None:
    """Launch the kernel on (B, H, S, hd) / (B, Kv, S, hd) views."""
    check_attention_inputs(q, k, v, o)
    b, h, s, hd = q.shape
    kv = k.shape[1]
    strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, hd,
            h, kv, scale, 0 if window is None else window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if flash_route(q.dtype, hd) == "tensor_core":
        lib = _build.load("flash_attention", "flash_attention_tc_launch",
                          _TC_ARGTYPES)
        rc = lib.flash_attention_tc_launch(*head, *strides, stream)
    else:
        lib = _build.load("flash_attention", "flash_attention_cc_launch",
                          _CC_ARGTYPES)
        rc = lib.flash_attention_cc_launch(
            *head, int(q.dtype == torch.bfloat16), *strides, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{rc}")
    _build.count("flash_attention")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, num_q_heads: int,
                           num_kv_heads: int, scale: float,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B·H, S, hd), k and v (B·Kv, S, hd) -> (B·H, S, hd) in q.dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, num_q_heads=num_q_heads,
                                       num_kv_heads=num_kv_heads,
                                       scale=scale, window=window)
    h, kv = num_q_heads, num_kv_heads
    if q.dim() != 3 or h < 1 or q.shape[0] % h or k.dim() != 3 \
            or k.shape[0] != q.shape[0] // h * kv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} do not fit H={h}, Kv={kv}")
    b = q.shape[0] // h
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.unflatten(0, (b, h)), k.unflatten(0, (b, kv)),
            v.unflatten(0, (b, kv)), out.unflatten(0, (b, h)), scale, window)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: float,
                         window: Optional[int] = None) -> torch.Tensor:
    """The strided entry: q (B, S, H, hd), k and v (B, S, Kv, hd) views
    with the head dim contiguous -> (B, S, H, hd) in q.dtype, contiguous.

    On the card the kernel reads the views in place and writes the
    (B, S, H, hd) output directly. On the CPU it computes the plain
    version on the (B·H, S, hd) copies, through the same permutes."""
    bsz, s, h, hd = q.shape
    kv = k.shape[2]
    if q.device.type == "cpu":
        out = ref.flash_attention_ref(
            *(t.transpose(1, 2).reshape(bsz * t.shape[2], s, hd)
              for t in (q, k, v)),
            num_q_heads=h, num_kv_heads=kv, scale=scale, window=window)
        return out.reshape(bsz, h, s, hd).transpose(1, 2).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            out.transpose(1, 2), scale, window)
    return out

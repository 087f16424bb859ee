"""CUDA kernels: the Mamba-2 SSD chunked scan, forward and backward.

Replaces no TPU kernel: the reference's scan (``repro/models/ssm.py``) is
jnp that XLA fuses. The kernels are ``csrc/ssd_scan.cu`` (one launcher a
direction); the plain version is ``ref.ssd_scan_ref``, and
``ops.ssd_scan`` routes between the two. ``ssd_scan_kernel`` launches
the kernels or raises.

What the kernels take (``refusal``, which ``check`` raises on): x (B, S,
H, 64) bf16, contiguous; dt (B, S, H) and A (H,) f32, contiguous; B and C
(B, S, N) bf16 with N 64 or 128, a unit last stride, one layout between
them, batch and position strides that are multiples of 8 and 16-byte
aligned data (the two halves of one (B, S, 2N) tensor qualify); a chunk
that divides S, a multiple of 16 from 16 to 256; h0 None or (B, H, 64,
N), taken in f32. They return y (B, S, H, 64) bf16 and the final state
(B, H, 64, N) f32.

Autograd (``SSDScan``): the forward saves its inputs, the in-chunk
cumulative decay, C·Bᵀ (and its transpose) and the state entering each
chunk, (B, S/chunk, H, 64, N) f32; the backward launches the backward
kernels on them and returns dx, ddt, dA, dB, dC and dh0. No chunk is
recomputed under autograd, so the caller needs no checkpoint around the
scan.

Launch counts (``_build``): ``ssd_scan`` once a forward, ``ssd_scan_bwd``
once a backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIM = 64            # P the kernels take
STATE_SIZES = (64, 128)  # N they take
MAX_CHUNK = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each launcher's arguments (the stream, last, is added by _build.launch)
_FWD = [_P] * 12 + [_I] * 5 + [_L] * 2
_BWD = [_P] * 24 + [_I] * 5 + [_L] * 2


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def refusal(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
            h0: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why the kernels do not take these inputs, or None where they do:
    the one test of what they read (``check`` raises on it,
    ``ops.ssd_scan_route`` routes on it). Reads shapes, dtypes, strides
    and addresses only, so it runs on any device."""
    if xh.dim() != 4 or xh.shape[-1] != HEAD_DIM:
        return f"x must be (B, S, H, {HEAD_DIM}), got {tuple(xh.shape)}"
    B, S, H, _ = xh.shape
    if xh.dtype != torch.bfloat16 or not xh.is_contiguous() \
            or not _aligned(xh):
        return (f"x must be contiguous aligned bf16, got {xh.dtype} "
                f"strides {xh.stride()}")
    for name, t, shape in (("dt", dt, (B, S, H)), ("A", A, (H,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or not _aligned(t):
            return (f"{name} must be contiguous aligned f32 {shape}, got "
                    f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    for name, t in (("B", Bm), ("C", Cm)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (B, S, N) \
                or N not in STATE_SIZES:
            return (f"{name} must be bf16 (B, S, N) with N in "
                    f"{STATE_SIZES}, got {t.dtype} {tuple(t.shape)}")
        if t.stride(-1) != 1 or t.stride() != Bm.stride() \
                or t.stride(0) % 8 or t.stride(1) % 8 or not _aligned(t):
            return (f"{name}'s strides {t.stride()} (B's {Bm.stride()}): "
                    f"a unit last stride, B's layout, multiples of 8, "
                    f"aligned")
    if chunk % 16 or not 16 <= chunk <= MAX_CHUNK or S % chunk:
        return (f"chunk {chunk} must be a multiple of 16 up to {MAX_CHUNK} "
                f"that divides S = {S}")
    if h0 is not None and tuple(h0.shape) != (B, H, HEAD_DIM, N):
        return f"h0 must be {(B, H, HEAD_DIM, N)}, got {tuple(h0.shape)}"
    if any(t.device != xh.device for t in (dt, A, Bm, Cm)) \
            or h0 is not None and h0.device != xh.device:
        return "the inputs lie on different devices"
    return None


def check(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
          Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
          h0: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError on inputs the kernels do not take (``refusal``)."""
    why = refusal(xh, dt, A, Bm, Cm, chunk, h0)
    if why is not None:
        raise ValueError(f"ssd_scan: {why}")


def _forward(xh, dt, A, Bm, Cm, h0, chunk):
    B, S, H, P = xh.shape
    N, nc = Bm.shape[-1], S // chunk
    f32 = dict(device=xh.device, dtype=torch.float32)
    cum = torch.empty((B, H, nc, chunk), **f32)
    cb = torch.empty((B, nc, chunk, chunk), **f32)
    cbt = torch.empty_like(cb)
    states = torch.empty((B, nc, H, P, N), **f32)
    hlast = torch.empty((B, H, P, N), **f32)
    y = torch.empty_like(xh)
    _build.launch("ssd_scan", "ssd_fwd_launch", _FWD, xh, dt, A, Bm, Cm, h0,
                  cum, cb, cbt, states, hlast, y, B, S, H, N, chunk,
                  Bm.stride(0), Bm.stride(1))
    _build.count("ssd_scan")
    return y, hlast, (cum, cb, cbt, states)


def _backward(xh, dt, A, Bm, Cm, cum, cb, cbt, states, dy, dhlast, chunk):
    B, S, H, P = xh.shape
    N, nc = Bm.shape[-1], S // chunk
    f32 = dict(device=xh.device, dtype=torch.float32)
    G = torch.empty_like(states)
    t4 = torch.empty((B, nc, H), **f32)
    dapart = torch.empty_like(t4)
    dc_inter = torch.empty((B, S, N), **f32)
    db_inter = torch.empty_like(dc_inter)
    dcb, dcbt = torch.empty_like(cb), torch.empty_like(cb)
    dh0 = torch.empty((B, H, P, N), **f32)
    dx, ddt, dA = torch.empty_like(xh), torch.empty_like(dt), \
        torch.empty_like(A)
    dB = torch.empty((B, S, N), device=xh.device, dtype=torch.bfloat16)
    dC = torch.empty_like(dB)
    _build.launch("ssd_scan", "ssd_bwd_launch", _BWD, xh, dt, A, Bm, Cm, cum,
                  cb, cbt, states, dy, dhlast, G, t4, dc_inter, db_inter,
                  dcb, dcbt, dh0, dx, ddt, dapart, dA, dB, dC, B, S, H, N,
                  chunk, Bm.stride(0), Bm.stride(1))
    _build.count("ssd_scan_bwd")
    return dx, ddt, dA, dB, dC, dh0


class SSDScan(torch.autograd.Function):
    """The kernels under autograd: (x, dt, A, B, C, h0 f32 or None, chunk)
    -> (y, final state)."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm, h0, chunk):
        y, hlast, saved = _forward(xh, dt, A, Bm, Cm, h0, chunk)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.save_for_backward(xh, dt, A, Bm, Cm, *saved)
        ctx.set_materialize_grads(False)
        return y, hlast

    @staticmethod
    def backward(ctx, dy, dhlast):
        xh, dt, A, Bm, Cm, cum, cb, cbt, states = ctx.saved_tensors
        dy = torch.zeros_like(xh) if dy is None else \
            dy.to(xh.dtype).contiguous()
        dy = dy if _aligned(dy) else dy.clone()
        if dhlast is not None:
            dhlast = dhlast.to(torch.float32).contiguous()
        dx, ddt, dA, dB, dC, dh0 = _backward(
            xh, dt, A, Bm, Cm, cum, cb, cbt, states, dy, dhlast, ctx.chunk)
        return dx, ddt, dA, dB, dC, dh0 if ctx.has_h0 else None, None


def ssd_scan_kernel(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``models/ssm.ssd_scan``'s arguments on the kernels:
    (y, final state). Raises on a tensor off the card and on inputs they
    do not take (``refusal``)."""
    if xh.device.type != "cuda":
        raise ValueError(f"ssd_scan: needs a CUDA tensor, got {xh.device}")
    check(xh, dt, A, Bm, Cm, chunk, h0)
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
        h0 = h0 if _aligned(h0) else h0.clone()
    return SSDScan.apply(xh, dt, A, Bm, Cm, h0, chunk)

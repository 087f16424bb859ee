"""CUDA kernels: the MoE layer's dispatch and combine, each the other's
backward.

Replaces no TPU kernel: the reference's dispatch and combine
(``repro/models/moe.py``) are jnp scatters and gathers that XLA fuses.
The kernels are ``csrc/moe_dispatch.cu``; the plain versions are
``ref.moe_dispatch_ref`` and ``ref.moe_combine_ref`` (one choice at a
time, through dump rows), and ``ops.moe_dispatch`` / ``ops.moe_combine``
route between the two. ``moe_dispatch_kernel`` and ``moe_combine_kernel``
launch the kernels or raise.

What the kernels take (``check`` raises on the rest): rows of D
values in bf16 or f32 with D a multiple of 8 (bf16) or 4 (f32), so that
every row is 16-byte aligned; dest (G, Ng, k) int64 and keep (G, Ng, k)
bool, as ``models/moe.dispatch_slots`` makes them; gate_w (G, Ng, k) f32;
G up to 65535, k up to 1024, Ng·k and the slots a group under 2^31. The
rows are made contiguous and aligned here. The dump rows of the plain
version do not exist on this route: a dropped pair (keep false) moves
nothing.

Autograd: ``MoeDispatch`` (forward the slot gather, backward the token
reduce) saves dest and keep; ``MoeCombine`` (forward the token reduce,
backward the slot gather with the gate's gradient) saves dest, keep,
gate_w and the experts' output, which is alive anyway. The combine's
output and the experts' output gradient are bitwise the plain version's;
x's and gate_w's gradients are summed in f32 and rounded once.

Launch counts (``_build``): ``moe_dispatch`` and ``moe_combine`` once a
forward, ``moe_dispatch_bwd`` and ``moe_combine_bwd`` once a backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_GROUPS = 65535
MAX_K = 1024
_INT_MAX = 2 ** 31 - 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SHAPE = [_I, _L, _I, _L, _I, _I]     # G, Ng, k, slots, D, bf16
# each launcher's arguments (the stream, last, is added by _build.launch)
_DISPATCH = [_P] * 5 + _SHAPE
_DISPATCH_BWD = [_P] * 4 + _SHAPE
_COMBINE = [_P] * 5 + _SHAPE
_COMBINE_BWD = [_P] * 8 + _SHAPE


def check(rows: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
          slots: Optional[int] = None) -> None:
    """Raise ValueError on inputs the kernels do not take: the one test of
    what they read (``ops.moe_route`` sends every CUDA tensor to the
    kernels). ``rows`` is x (G, Ng, D) or the experts' output (G, H, C,
    D); ``slots`` the slots a group (H·C). Reads shapes and dtypes only,
    so it runs on any device."""
    def refuse(why):
        raise ValueError(f"moe_dispatch: {why}")
    if rows.dtype not in (torch.bfloat16, torch.float32):
        refuse(f"rows must be bf16 or f32, got {rows.dtype}")
    D = rows.shape[-1]
    lanes = 16 // rows.element_size()
    if D < 1 or D % lanes:
        refuse(f"D = {D} must be a multiple of {lanes} ({rows.dtype}: "
               f"16-byte rows)")
    if dest.dim() != 3 or dest.dtype != torch.int64:
        refuse(f"dest must be int64 (G, Ng, k), got {dest.dtype} "
               f"{tuple(dest.shape)}")
    G, Ng, k = dest.shape
    if keep.dtype != torch.bool or keep.shape != dest.shape:
        refuse(f"keep must be bool {tuple(dest.shape)}, got {keep.dtype} "
               f"{tuple(keep.shape)}")
    if rows.shape[0] != G or not 1 <= G <= MAX_GROUPS:
        refuse(f"{G} groups (rows {tuple(rows.shape)}): 1 to {MAX_GROUPS}")
    if not 1 <= k <= MAX_K or Ng * k > _INT_MAX:
        refuse(f"k = {k} (1 to {MAX_K}) and Ng·k = {Ng * k} (under 2^31)")
    if slots is not None and slots > _INT_MAX:
        refuse(f"{slots} slots a group: under 2^31")
    if rows.device != dest.device or keep.device != dest.device:
        refuse("the inputs lie on different devices")


def _on_card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got {t.device}")


def _ready(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, its data 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shape(dest: torch.Tensor, slots: int, rows: torch.Tensor):
    G, Ng, k = dest.shape
    return G, Ng, k, slots, rows.shape[-1], int(rows.dtype == torch.bfloat16)


def _dispatch(xg, dest, keep, slots):
    out = xg.new_empty((xg.shape[0], slots, xg.shape[-1]))
    src = torch.empty((xg.shape[0], slots), device=xg.device,
                      dtype=torch.int32)
    _build.launch("moe_dispatch", "moe_dispatch_launch", _DISPATCH, xg,
                  dest, keep, src, out, *_shape(dest, slots, xg))
    _build.count("moe_dispatch")
    return out


def _dispatch_bwd(dout, dest, keep):
    G, Ng, _ = dest.shape
    dx = dout.new_empty((G, Ng, dout.shape[-1]))
    _build.launch("moe_dispatch", "moe_dispatch_bwd_launch", _DISPATCH_BWD,
                  dout, dest, keep, dx, *_shape(dest, dout.shape[1], dout))
    _build.count("moe_dispatch_bwd")
    return dx


def _combine(obuf, dest, keep, gate_w):
    G, Ng, _ = dest.shape
    y = obuf.new_empty((G, Ng, obuf.shape[-1]))
    _build.launch("moe_dispatch", "moe_combine_launch", _COMBINE, obuf, dest,
                  keep, gate_w, y, *_shape(dest, obuf.shape[1], obuf))
    _build.count("moe_combine")
    return y


def _combine_bwd(dy, obuf, dest, keep, gate_w):
    slots = obuf.shape[1]
    src = torch.empty((obuf.shape[0], slots), device=obuf.device,
                      dtype=torch.int32)
    dobuf = torch.empty_like(obuf)
    dgate = torch.empty_like(gate_w)
    _build.launch("moe_dispatch", "moe_combine_bwd_launch", _COMBINE_BWD, dy,
                  obuf, dest, keep, gate_w, src, dobuf, dgate,
                  *_shape(dest, slots, obuf))
    _build.count("moe_combine_bwd")
    return dobuf, dgate


class MoeDispatch(torch.autograd.Function):
    """(x (G, Ng, D), dest, keep, slots) -> the expert buffer (G, slots,
    D): each kept pair's x row at its slot, zeros at the empty slots."""

    @staticmethod
    def forward(ctx, xg, dest, keep, slots):
        ctx.save_for_backward(dest, keep)
        ctx.set_materialize_grads(False)
        return _dispatch(xg, dest, keep, slots)

    @staticmethod
    def backward(ctx, dout):
        if dout is None:
            return None, None, None, None
        dest, keep = ctx.saved_tensors
        return _dispatch_bwd(_ready(dout), dest, keep), None, None, None


class MoeCombine(torch.autograd.Function):
    """(the experts' output (G, slots, D), dest, keep, gate_w) -> y (G, Ng,
    D): each token's kept rows weighted by its gates, in choice order."""

    @staticmethod
    def forward(ctx, obuf, dest, keep, gate_w):
        ctx.save_for_backward(obuf, dest, keep, gate_w)
        ctx.set_materialize_grads(False)
        return _combine(obuf, dest, keep, gate_w)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        obuf, dest, keep, gate_w = ctx.saved_tensors
        dobuf, dgate = _combine_bwd(_ready(dy.to(obuf.dtype)), obuf, dest,
                                    keep, gate_w)
        return dobuf, None, None, dgate


def moe_dispatch_kernel(xg: torch.Tensor, dest: torch.Tensor,
                        keep: torch.Tensor, slots: int) -> torch.Tensor:
    """The expert buffer (G, slots, D) of x (G, Ng, D) on the kernels.
    Raises on a tensor off the card and on inputs they do not take
    (``check``)."""
    _on_card("moe_dispatch", xg)
    check(xg, dest, keep, slots)
    return MoeDispatch.apply(_ready(xg), dest.contiguous(), keep.contiguous(),
                             slots)


def moe_combine_kernel(obuf: torch.Tensor, dest: torch.Tensor,
                       keep: torch.Tensor,
                       gate_w: torch.Tensor) -> torch.Tensor:
    """y (G, Ng, D) from the experts' output (G, slots, D) on the kernels.
    Raises on a tensor off the card and on inputs they do not take
    (``check``; gate_w f32 as dest)."""
    _on_card("moe_combine", obuf)
    check(obuf, dest, keep, obuf.shape[1])
    if gate_w.dtype != torch.float32 or gate_w.shape != dest.shape \
            or gate_w.device != dest.device:
        raise ValueError(f"moe_combine: gate_w must be f32 "
                         f"{tuple(dest.shape)}, got {gate_w.dtype} "
                         f"{tuple(gate_w.shape)}")
    return MoeCombine.apply(_ready(obuf), dest.contiguous(), keep.contiguous(),
                            gate_w.contiguous())

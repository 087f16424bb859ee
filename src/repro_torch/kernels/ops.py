"""Public wrappers around the kernels (twin of ``repro/kernels/ops.py``).

This module alone chooses between a kernel and its plain version
(``kernels/ref``): every wrapper takes the kernel for a CUDA tensor and
the plain version for any other (``use_kernel``), and the callers that
name a backend (``"torch"``, ``"cuda"`` or ``"auto"``, ``BACKENDS``) ask
``use_kernel`` which one to call. ``"torch"`` runs the plain version on
any device, ``"auto"`` resolves by device, and ``"cuda"`` has no
fallback: a tensor off the card raises. The ``*_kernel`` entries in the
kernel modules launch or raise, whatever the device.

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
``adafactor_update`` takes one optimizer leaf in the reference's layout.
``ssd_scan`` takes ``models/ssm.ssd_scan``'s arguments and routes them
itself (``ssd_scan_route``): the kernels where they take the inputs, the
plain chunk loop for the rest.
``moe_dispatch`` and ``moe_combine`` take ``models/moe.apply_moe``'s
buffers and route them themselves (``moe_route``): the kernels for a CUDA
tensor, which raise on what they do not take, the plain version through
dump rows on the CPU.
``flash_attention`` takes the reference's (B·H, S, hd) layout and
``flash_attention_strided`` the projections' (B, S, H, hd) views, both at
any S: the kernel masks its ragged last tile, so no padded copy is made.

The kernels take raw pointers, so every wrapper refuses a DTensor: under
a mesh the models hand them each rank's local block (``sharding/ctx.
local``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.adafactor import (adafactor_update_kernel,
                                           adafactor_update_sharded,
                                           aligned)
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bshd,
                                                 flash_attention_kernel)
from repro_torch.kernels.kmeans_assign import kmeans_assign_kernel
from repro_torch.kernels.lloyd_update import lloyd_update_kernel
from repro_torch.kernels.moe_dispatch import (moe_combine_kernel,
                                              moe_dispatch_kernel)
from repro_torch.kernels.pq_quantize import pq_quantize_kernel
from repro_torch.kernels.scalar_quant import (pack_codes_kernel,
                                              scalar_quantize_kernel,
                                              unpack_codes_kernel)
from repro_torch.kernels.ssd_scan import refusal, ssd_scan_kernel

BACKENDS = ("torch", "cuda", "auto")


def check_backend(name: str) -> None:
    """Raise on a backend name that is not one of ``BACKENDS``."""
    if name not in BACKENDS:
        raise ValueError(f"backend={name!r} not one of {BACKENDS}")


def resolve_backend(name: str, device: torch.device) -> str:
    """``name`` checked and, if ``"auto"``, resolved for tensors on
    ``device``: ``"cuda"`` on a CUDA device, ``"torch"`` on any other."""
    check_backend(name)
    if name != "auto":
        return name
    return "cuda" if device.type == "cuda" else "torch"


def use_kernel(t: torch.Tensor, backend: str = "auto") -> bool:
    """Whether a call on t under ``backend`` runs the kernel (True) or its
    plain version (False). No fallback: ``"cuda"`` raises on a tensor off
    the card."""
    if resolve_backend(backend, t.device) == "torch":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"quantizer backend 'cuda' runs CUDA tensors only; "
                         f"got a tensor on {t.device} (use 'torch' or "
                         f"'auto')")
    return True


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
    args = _rows(x), centroids.float().contiguous()
    if use_kernel(x):
        return kmeans_assign_kernel(*args)
    codes, sqdist = ref.kmeans_assign_ref(*args)
    return codes.to(torch.int32), sqdist


def pq_quantize(x: torch.Tensor, centroids: torch.Tensor):
    """Fused assign + dequantize + residual.

    x (P, N, D) f32 or bf16; centroids (P, L, D). Returns (z̃ (P, N, D)
    x.dtype, residual (P, N, D) f32, codes (P, N) int32)."""
    _local("pq_quantize", x, centroids)
    args = _rows(x), centroids.float().contiguous()
    return pq_quantize_kernel(*args) if use_kernel(x) \
        else ref.pq_quantize_ref(*args)


def lloyd_update(x: torch.Tensor, centroids: torch.Tensor,
                 weights: Optional[torch.Tensor] = None):
    """One Lloyd iteration's statistics in one sweep over x.

    x (P, N, D) f32 or bf16; centroids (P, L, D); weights (P, N) (padding
    rows carry 0; None = all 1, and no weights are read). Returns (dsums
    (P, L, D) f32 = Σ onehot·(x − c_old), counts (P, L) f32)."""
    _local("lloyd_update", x, centroids, weights)
    if weights is not None:
        weights = weights.float().contiguous()
    args = _rows(x), weights, centroids.float().contiguous()
    return lloyd_update_kernel(*args) if use_kernel(x) \
        else ref.lloyd_update_ref(*args)


def scalar_quantize(x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor,
                    bits: int):
    """Fused uniform b-bit quantize + dequantize, one range per problem.

    x (P, N) any float dtype, f32 and bf16 read as they are (no f32 copy);
    lo and scale (P,). Returns (codes (P, N) int32 in [0, 2^bits), recon
    (P, N) f32)."""
    _local("scalar_quantize", x, lo, scale)
    args = (_rows(x), lo.float().contiguous(), scale.float().contiguous(),
            bits)
    return scalar_quantize_kernel(*args) if use_kernel(x) \
        else ref.scalar_quantize_ref(*args)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack each problem's codes (P, N) at ``bits`` in {1, 2, 4, 8, 16} bits
    into little-endian 32-bit words: (P, ⌈N·bits/32⌉) int32 bit patterns,
    byte for byte the wire's LSB-first stream of each problem."""
    _local("pack_codes", codes)
    args = codes.to(torch.int32).contiguous(), bits
    return pack_codes_kernel(*args) if use_kernel(codes) \
        else ref.pack_codes_ref(*args)


def unpack_codes(words: torch.Tensor, count: int, bits: int) -> torch.Tensor:
    """Inverse of ``pack_codes``: (P, W) words -> (P, count) int32 codes."""
    _local("unpack_codes", words)
    args = words.to(torch.int32).contiguous(), count, bits
    return unpack_codes_kernel(*args) if use_kernel(words) \
        else ref.unpack_codes_ref(*args)


def adafactor_update(g: torch.Tensor, v: Dict[str, torch.Tensor], *,
                     beta: float, one_minus: float, lr: float, eps: float,
                     clip: float):
    """One leaf's Adafactor update (see ``kernels/adafactor.py``).

    g in the reference's layout, f32 or bf16 on the card; v its second
    moment (``{"row", "col"}`` or ``{"full"}``, f32). Returns (the update
    −lr·u in g's dtype, the new v). A view is copied to a contiguous,
    aligned tensor first. Unlike the other kernels it takes a DTensor: the
    kernel runs on the local blocks of one on the card, adding its sums
    over the mesh; one on the CPU (the dry runs on a fake process group)
    takes the plain version."""
    kw = dict(beta=beta, one_minus=one_minus, lr=lr, eps=eps, clip=clip)
    if isinstance(g, DTensor):
        if use_kernel(g.to_local()):
            return adafactor_update_sharded(g, v, **kw)
        return ref.adafactor_update_ref(g, v, **kw)
    _local("adafactor_update", *v.values())
    args = aligned(g), {k: t.contiguous() for k, t in v.items()}
    return adafactor_update_kernel(*args, **kw) if use_kernel(g) \
        else ref.adafactor_update_ref(*args, **kw)


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
    fn = flash_attention_kernel if use_kernel(q) \
        else ref.flash_attention_ref
    return fn(q.contiguous(), k.contiguous(), v.contiguous(),
              num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
              scale=scale, window=window)


def flash_attention_strided(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, scale: float,
                            window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` on the projections' layout, without copies:
    q (B, S, H, hd), k and v (B, S, Kv, hd) views with the head dim
    contiguous; returns (B, S, H, hd) in q.dtype. Raises on an input that
    requires grad."""
    _local("flash_attention", q, k, v)
    _forward_only(q, k, v)
    fn = flash_attention_bshd if use_kernel(q) \
        else ref.flash_attention_bshd_ref
    return fn(q, k, v, scale=scale, window=window)


def ssd_scan_route(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None) -> str:
    """Which route ``ssd_scan`` takes: "kernel" for a CUDA x whose inputs
    the kernels take (``kernels/ssd_scan.refusal``: x, B and C in bf16, dt
    and A in f32, as ``cfg.ssm_decay_f32`` makes them; head dim 64; state
    64 or 128; a chunk that is a multiple of 16 up to 256 and divides the
    sequence; the layout ``apply_ssm`` gives them), else "plain": the CPU,
    a decay in the stream's dtype (the twin's rounding, kept as the
    reference has it), f32 streams (bf16 operands would be a lower
    precision than the configuration's) and an undivided sequence."""
    return "kernel" if use_kernel(xh) and refusal(
        xh, dt, A, Bm, Cm, chunk, h0) is None else "plain"


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None):
    """The chunked SSD scan (``models/ssm.ssd_scan``): (y, final state),
    on the route ``ssd_scan_route`` names. No fallback: the kernel route
    launches the kernels or raises."""
    _local("ssd_scan", xh, dt, A, Bm, Cm, h0)
    if ssd_scan_route(xh, dt, A, Bm, Cm, chunk, h0) == "kernel":
        return ssd_scan_kernel(xh, dt, A, Bm, Cm, chunk, h0)
    return ref.ssd_scan_ref(xh, dt, A, Bm, Cm, chunk, h0)


def moe_route(rows: torch.Tensor) -> str:
    """Which route ``moe_dispatch`` and ``moe_combine`` take: "kernel" for
    a CUDA ``rows`` (x or the experts' output), else "plain". No fallback
    on the card: the kernels raise on inputs they do not take
    (``kernels/moe_dispatch.check``: bf16 or f32, D a multiple of 8 or
    4)."""
    return "kernel" if use_kernel(rows) else "plain"


def moe_dispatch(xg: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                 held: int, capacity: int, dump: int) -> torch.Tensor:
    """The expert buffer (G, held, capacity, D) of x (G, Ng, D): each kept
    pair's row at its slot ``dest``, zeros elsewhere; on the route
    ``moe_route`` names. ``dump`` is the plain route's dump rows past the
    slots, where ``dest`` sends the dropped pairs; the kernels move no
    dropped pair."""
    _local("moe_dispatch", xg, dest, keep)
    if moe_route(xg) == "plain":
        return ref.moe_dispatch_ref(xg, dest, held, capacity, dump)
    G, _, D = xg.shape
    return moe_dispatch_kernel(xg, dest, keep, held * capacity).reshape(
        G, held, capacity, D)


def moe_combine(out_buf: torch.Tensor, dest: torch.Tensor,
                gate_w: torch.Tensor, keep: torch.Tensor,
                dump: int) -> torch.Tensor:
    """y (G, Ng, D) from the experts' output (G, H, C, D): each token's
    kept rows weighted by its gates (f32, rounded to the output's dtype)
    and added in choice order, on the route ``moe_route`` names; the
    kernel route's y is bitwise the plain route's."""
    _local("moe_combine", out_buf, dest, gate_w, keep)
    if moe_route(out_buf) == "plain":
        return ref.moe_combine_ref(out_buf, dest, gate_w, keep, dump)
    G, H, C, D = out_buf.shape
    return moe_combine_kernel(out_buf.reshape(G, H * C, D), dest, keep,
                              gate_w)

"""CUDA kernels: uniform b-bit scalar quantization and b-bit code packing.

Twin of ``repro/kernels/scalar_quant.py`` (the Pallas ``_quantize_kernel``,
``_pack_kernel`` and ``_unpack_kernel``). The kernels are
``csrc/scalar_quant.cu``; their plain versions ``ref.scalar_quantize_ref``,
``ref.pack_codes_ref`` and ``ref.unpack_codes_ref``. Every input has a
leading problem axis P (one per client), each problem with its own
``lo``/``scale``, and packs into its own stream of words.

``scalar_quantize`` reads x in f32 or bf16 as it comes (the kernel
upcasts in registers, exactly), on one of two routes picked by
``scalar_route``: ``vec`` (every problem's values start aligned for
4-value loads: a persistent grid, 4 values per load, 16-byte stores) and
``scalar`` (ragged N, misaligned views: one value per thread per step).

On a CPU tensor a wrapper computes the plain version; on a CUDA tensor it
launches the kernel or raises. The kernels compute the plain versions'
arithmetic bit for bit: codes and recon of ``scalar_quantize`` (on both
routes), and the words of ``pack_codes``, are equal, not close.

Words are returned as int32 tensors holding the uint32 bit patterns
(``words.numpy().view(np.uint32)`` gives the unsigned words; their
little-endian bytes are the wire's LSB-first code stream).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.lloyd_update import d8_blocks, occupancy, device_sms

VEC_THREADS = 256   # vec route: threads per block
VEC_TILE = 4 * VEC_THREADS   # vec route: values a block takes per step

_P, _I = ctypes.c_void_p, ctypes.c_int
_QUANTIZE_ARGTYPES = [_P] * 5 + [_I] * 6 + [_P]
_PACK_ARGTYPES = [_P] * 2 + [_I] * 4 + [_P]


def _check(name: str, dtypes, *tensors: torch.Tensor) -> None:
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {first.device}")
    if first.dim() != 2:
        raise ValueError(f"{name}: takes (P, N) tensors, got "
                         f"{tuple(first.shape)}")
    if first.dtype not in dtypes or not first.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous tensor of "
                         f"{' or '.join(map(str, dtypes))}, got "
                         f"{first.dtype} (contiguous="
                         f"{first.is_contiguous()})")
    for t in tensors[1:]:
        if t.device != first.device or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != first.shape[:1]:
            raise ValueError(f"{name}: lo and scale must be contiguous f32 "
                             f"({first.shape[0]},) tensors on "
                             f"{first.device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")


def scalar_route(x: torch.Tensor) -> str:
    """``"vec"`` where every problem's row of x starts aligned for loads of
    4 values (x's address a multiple of 4·itemsize, N a multiple of 4);
    ``"scalar"`` otherwise."""
    if x.data_ptr() % (4 * x.element_size()) == 0 and x.shape[-1] % 4 == 0:
        return "vec"
    return "scalar"


def vec_grid(x: torch.Tensor) -> int:
    """Blocks per problem of a vec launch on x's card: ``d8_blocks``'s
    persistent grid with tiles of ``VEC_TILE`` values, one tile a block at
    least."""
    p, n = x.shape
    dev, sms = device_sms(x)
    per_sm = occupancy("scalar_quant", "scalar_quantize_vec_occupancy", dev,
                       int(x.dtype == torch.bfloat16))
    return d8_blocks(p, n, sms, per_sm, VEC_TILE, 1)


def scalar_quantize_kernel(x: torch.Tensor, lo: torch.Tensor,
                           scale: torch.Tensor, bits: int,
                           route: Optional[str] = None):
    """x (P, N) f32 or bf16, lo and scale (P,) f32, 1 <= bits <= 16;
    ``route`` ``"scalar"`` takes that route on any x, None the one that
    ``scalar_route`` picks.

    Returns (codes (P, N) int32, recon (P, N) f32)."""
    if route not in (None, "scalar"):
        raise ValueError(f"scalar_quantize: route {route!r} is not None or "
                         f"'scalar'")
    if x.device.type == "cpu":
        return ref.scalar_quantize_ref(x, lo, scale, bits)
    _check("scalar_quantize", (torch.float32, torch.bfloat16), x, lo, scale)
    if not 1 <= bits <= 16:
        raise ValueError(f"scalar_quantize: bits={bits} not in [1, 16]")
    vec = route is None and scalar_route(x) == "vec"
    blocks = vec_grid(x) if vec else 0
    p, n = x.shape
    lib = _build.load("scalar_quant", "scalar_quantize_launch",
                      _QUANTIZE_ARGTYPES)
    codes = torch.empty((p, n), device=x.device, dtype=torch.int32)
    recon = torch.empty((p, n), device=x.device, dtype=torch.float32)
    _raise_on("scalar_quantize", lib.scalar_quantize_launch(
        x.data_ptr(), lo.data_ptr(), scale.data_ptr(), codes.data_ptr(),
        recon.data_ptr(), p, n, bits, int(vec),
        int(x.dtype == torch.bfloat16), blocks, _stream(x)))
    _build.count("scalar_quantize")
    return codes, recon


def pack_codes_kernel(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes (P, N) int32 -> words (P, ⌈N·bits/32⌉) int32 bit patterns."""
    if codes.device.type == "cpu":
        return ref.pack_codes_ref(codes, bits)
    _check("pack_codes", (torch.int32,), codes)
    per_word = ref._check_pack_bits(bits)
    p, n = codes.shape
    nwords = -(-n // per_word)
    lib = _build.load("scalar_quant", "pack_codes_launch", _PACK_ARGTYPES)
    words = torch.empty((p, nwords), device=codes.device, dtype=torch.int32)
    _raise_on("pack_codes", lib.pack_codes_launch(
        codes.data_ptr(), words.data_ptr(), p, n, nwords, bits,
        _stream(codes)))
    _build.count("pack_codes")
    return words


def unpack_codes_kernel(words: torch.Tensor, count: int,
                        bits: int) -> torch.Tensor:
    """words (P, W) int32 bit patterns -> codes (P, count) int32."""
    if words.device.type == "cpu":
        return ref.unpack_codes_ref(words, count, bits)
    _check("unpack_codes", (torch.int32,), words)
    per_word = ref._check_pack_bits(bits)
    p, nwords = words.shape
    if count > nwords * per_word:
        raise ValueError(f"unpack_codes: {nwords} words hold at most "
                         f"{nwords * per_word} codes, not {count}")
    lib = _build.load("scalar_quant", "unpack_codes_launch", _PACK_ARGTYPES)
    codes = torch.empty((p, count), device=words.device, dtype=torch.int32)
    _raise_on("unpack_codes", lib.unpack_codes_launch(
        words.data_ptr(), codes.data_ptr(), p, count, nwords, bits,
        _stream(words)))
    _build.count("unpack_codes")
    return codes

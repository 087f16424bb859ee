"""CUDA kernel: fused PQ encode (assign + gather + residual in one read).

Twin of ``repro/kernels/pq_quantize.py`` (the Pallas ``_fused_kernel``).
The kernel is ``csrc/pq_quantize.cu``; its plain version is
``ref.pq_quantize_ref``. For each of P problems and each row it returns the
code (int32), z̃ = c[code] in x's dtype (f32 or bf16, rounded to nearest
even) and the residual x − c[code] in f32, from one read of x. The
centroid mask is optional (None: every centroid valid).

Two routes, picked by ``pq_route``: ``d8`` (D = 8, L in ``D8_L``, x
16-byte aligned: persistent blocks stream whole rows into registers and
write each row with 16-byte stores) and ``generic`` (any D <= 64, any L,
any alignment: the codebook streamed through shared memory in tiles of
``TILE_L`` centroids).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. Wherever kernel and plain version pick
the same code, z̃ and the residual are bitwise equal.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.lloyd_update import (D8_THREADS, ROUTE_IDS, _ptr,
                                              check_cuda_inputs, d8_grid,
                                              d8_rows)

D8_TILE = 2 * D8_THREADS   # d8 route: rows per tile, 2 per thread
D8_MIN_TILES = 8   # d8 route: tiles a block takes at least (PERF.md)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def pq_route(x: torch.Tensor, num_centroids: int) -> str:
    """``"d8"`` where ``lloyd_update.d8_rows``, else ``"generic"``."""
    return "d8" if d8_rows(x, num_centroids) else "generic"


def pq_quantize_kernel(x: torch.Tensor, centroids: torch.Tensor,
                       lmask: Optional[torch.Tensor] = None):
    """x (P, N, D) f32 or bf16, centroids (P, L, D), lmask (L,) or None.

    Returns (z̃ (P, N, D) in x.dtype, residual (P, N, D) f32,
    codes (P, N) int32)."""
    if x.device.type == "cpu":
        return ref.pq_quantize_ref(x, centroids, lmask)
    check_cuda_inputs("pq_quantize", x, centroids, lmask)
    p, n, d = x.shape
    l = centroids.shape[1]
    route = pq_route(x, l)
    blocks = d8_grid("pq_quantize", "pq_quantize_d8_occupancy", x, l,
                     D8_TILE, D8_MIN_TILES) if route == "d8" else 0
    lib = _build.load("pq_quantize", "pq_quantize_launch", _ARGTYPES)
    zt = torch.empty_like(x)
    resid = torch.empty(x.shape, device=x.device, dtype=torch.float32)
    codes = torch.empty((p, n), device=x.device, dtype=torch.int32)
    rc = lib.pq_quantize_launch(
        x.data_ptr(), centroids.data_ptr(), _ptr(lmask), zt.data_ptr(),
        resid.data_ptr(), codes.data_ptr(), p, n, l, d, ROUTE_IDS[route],
        int(x.dtype == torch.bfloat16), D8_TILE, blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pq_quantize: launch failed with CUDA error {rc}")
    _build.count("pq_quantize")
    return zt, resid, codes

"""CUDA kernel: fused PQ encode (assign + gather + residual in one read).

Twin of ``repro/kernels/pq_quantize.py`` (the Pallas ``_fused_kernel``).
The kernel is ``csrc/pq_quantize.cu``; its plain version is
``ref.pq_quantize_ref``. For each of P problems and each row it returns the
code (int32), z̃ = c[code] and the residual x − z̃ (both f32).

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. Wherever kernel and plain version pick
the same code, z̃ and the residual are bitwise equal.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.lloyd_update import check_cuda_inputs

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pq_quantize_kernel(x: torch.Tensor, centroids: torch.Tensor,
                       lmask: torch.Tensor):
    """x (P, N, D), centroids (P, L, D), lmask (L,).

    Returns (z̃ (P, N, D) in x.dtype, residual (P, N, D) f32,
    codes (P, N) int32)."""
    if x.device.type == "cpu":
        return ref.pq_quantize_ref(x, centroids, lmask)
    check_cuda_inputs("pq_quantize", x, centroids, lmask)
    p, n, d = x.shape
    l = centroids.shape[1]
    lib = _build.load("pq_quantize", "pq_quantize_launch", _ARGTYPES)
    zt = torch.empty_like(x)
    resid = torch.empty_like(x)
    codes = torch.empty((p, n), device=x.device, dtype=torch.int32)
    rc = lib.pq_quantize_launch(
        x.data_ptr(), centroids.data_ptr(), lmask.data_ptr(), zt.data_ptr(),
        resid.data_ptr(), codes.data_ptr(), p, n, l, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pq_quantize: launch failed with CUDA error {rc}")
    _build.count("pq_quantize")
    return zt, resid, codes

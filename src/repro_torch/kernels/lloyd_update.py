"""CUDA kernel: one Lloyd iteration's statistics (assign + deviation sums).

Twin of ``repro/kernels/lloyd_update.py`` (the Pallas ``_update_kernel``).
The kernel is ``csrc/lloyd_update.cu``; its plain version is
``ref.lloyd_update_ref``. Both compute, for each of P problems,

    codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)    over valid centroids
    dsums[l]  = Σ_i w_i·1[codes_i = l]·(x_i − c_l)
    counts[l] = Σ_i w_i·1[codes_i = l]

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises. The kernel adds each problem's per-block
partial sums in a fixed order (no atomics), so it is bitwise reproducible
from run to run; its sums are taken in another order than the plain
version's, so the two agree to f32 rounding (exactly on ``counts`` of 0/1
weights, and on the exact-cover and empty-cluster fixed points).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

ROWS_PER_BLOCK = 1024   # 4 tiles of 256 rows per block (see the .cu file)
MAX_D = 64
MAX_L = 64

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def check_cuda_inputs(name: str, x: torch.Tensor, centroids: torch.Tensor,
                      lmask: torch.Tensor, *others: torch.Tensor) -> None:
    """What the CUDA kernels take: f32, contiguous, on one CUDA device,
    x (P, N, D) with centroids (P, L, D) and lmask (L,), D and L bounded."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {x.device}")
    for t in (x, centroids, lmask, *others):
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be a contiguous f32 "
                             f"tensor on {x.device}; got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")
    p, _, d = x.shape
    if centroids.dim() != 3 or centroids.shape[0] != p \
            or centroids.shape[2] != d or lmask.shape != centroids.shape[1:2]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, centroids "
                         f"{tuple(centroids.shape)}, lmask "
                         f"{tuple(lmask.shape)} do not match")
    if d > MAX_D or centroids.shape[1] > MAX_L:
        raise ValueError(f"{name}: the kernel takes D <= {MAX_D} and "
                         f"L <= {MAX_L}; got D={d}, L={centroids.shape[1]}")


def lloyd_update_kernel(x: torch.Tensor, weights: torch.Tensor,
                        centroids: torch.Tensor, lmask: torch.Tensor):
    """x (P, N, D), weights (P, N), centroids (P, L, D), lmask (L,).

    Returns (dsums (P, L, D) f32, counts (P, L) f32)."""
    if x.device.type == "cpu":
        return ref.lloyd_update_ref(x, weights, centroids, lmask)
    check_cuda_inputs("lloyd_update", x, centroids, lmask, weights)
    p, n, d = x.shape
    l = centroids.shape[1]
    if weights.shape != (p, n):
        raise ValueError(f"lloyd_update: weights {tuple(weights.shape)} "
                         f"!= {(p, n)}")
    lib = _build.load("lloyd_update", "lloyd_update_launch", _ARGTYPES)
    nblocks = -(-n // ROWS_PER_BLOCK)
    partials = torch.empty((p, nblocks, l * (d + 1)), device=x.device,
                           dtype=torch.float32)
    dsums = torch.empty((p, l, d), device=x.device, dtype=torch.float32)
    counts = torch.empty((p, l), device=x.device, dtype=torch.float32)
    rc = lib.lloyd_update_launch(
        x.data_ptr(), weights.data_ptr(), centroids.data_ptr(),
        lmask.data_ptr(), partials.data_ptr(), dsums.data_ptr(),
        counts.data_ptr(), p, n, l, d, ROWS_PER_BLOCK, nblocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lloyd_update: launch failed with CUDA error "
                           f"{rc}")
    _build.count("lloyd_update")
    return dsums, counts


def lloyd_update_in_kernel_order(x: torch.Tensor, weights: torch.Tensor,
                                 centroids: torch.Tensor, lmask: torch.Tensor,
                                 rows_per_block: int = ROWS_PER_BLOCK):
    """The plain version, summed in the kernel's order: each block of
    ``rows_per_block`` rows adds its rows one at a time in row order, then a
    problem's block partials are added in block order. For 0/1 weights
    every term is exact, so in f32 this gives the kernel's dsums and counts
    bit for bit, given the same codes."""
    codes, _ = ref.kmeans_assign_ref(x, centroids, lmask)
    cf = centroids.float()
    onehot = torch.nn.functional.one_hot(codes, cf.shape[-2]).float() \
        * weights.float().unsqueeze(-1)                        # (P, N, L)
    delta = x.float() - ref._gather_rows(cf, codes)            # (P, N, D)
    terms = torch.cat([onehot.unsqueeze(-1) * delta.unsqueeze(-2),
                       onehot.unsqueeze(-1)], -1)              # (P, N, L, D+1)
    p, n = terms.shape[:2]
    nblocks = -(-n // rows_per_block)
    terms = torch.nn.functional.pad(
        terms, (0, 0, 0, 0, 0, nblocks * rows_per_block - n)
    ).reshape(p, nblocks, rows_per_block, *terms.shape[2:])
    part = torch.zeros_like(terms[:, :, 0])
    for r in range(rows_per_block):
        part = part + terms[:, :, r]
    total = torch.zeros_like(part[:, 0])
    for b in range(nblocks):
        total = total + part[:, b]
    return total[..., :-1], total[..., -1]

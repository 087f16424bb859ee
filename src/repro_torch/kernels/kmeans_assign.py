"""CUDA kernel: k-means assignment with squared distances.

Twin of ``repro/kernels/kmeans_assign.py`` (the Pallas ``_assign_kernel``).
The kernel is ``csrc/kmeans_assign.cu``; its plain version is
``ref.kmeans_assign_ref``. For each of P problems and each row it returns

    codes[i]  = argmax_l (2·x_i·c_l − ‖c_l‖²)       over valid centroids
    sqdist[i] = max(‖x_i‖² − max_l (2·x_i·c_l − ‖c_l‖²), 0)

x is f32 or bf16, read in its own dtype (the kernel upcasts in registers,
exactly), so a bf16 x gives bitwise its f32 upcast's codes and distances.

Two routes, picked by ``assign_route``: ``d8`` (no mask and what
``lloyd_update.d8_rows`` takes: D = 8, L in ``D8_L``, x 16-byte aligned;
persistent blocks stream whole rows into registers) and ``generic`` (any
D, any L, a mask, any alignment: the codebook streamed through shared
memory in tiles of ``TILE_L`` centroids, the rows in chunks of ``D_TILE``
dims). Both give the same codes and distances bit for bit.

The wrapper launches the kernel or raises, a CPU tensor included
(``ops.kmeans_assign`` takes the plain version there). The kernel takes its codes from the same
routine as ``lloyd_update`` and ``pq_quantize`` (``csrc/assign.cuh``); it
agrees with the plain version but for near-ties, where the FMA order may
pick the other code, and its distances to f32 rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lloyd_update import (D8_TILE, ROUTE_IDS,
                                              check_cuda_inputs, d8_grid,
                                              d8_rows)

D8_MIN_TILES = 1   # d8 route: tiles a block takes at least (PERF.md)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8


def assign_route(x: torch.Tensor, num_centroids: int,
                 lmask: Optional[torch.Tensor]) -> str:
    """``"d8"`` where no mask is given (the d8 instances read none) and
    ``lloyd_update.d8_rows``, else ``"generic"``."""
    return "d8" if lmask is None and d8_rows(x, num_centroids) \
        else "generic"


def kmeans_assign_kernel(x: torch.Tensor, centroids: torch.Tensor,
                         lmask: Optional[torch.Tensor] = None):
    """x (P, N, D) f32 or bf16, centroids (P, L, D), lmask (L,) or None
    (every centroid valid).

    Returns (codes (P, N) int32, sqdist (P, N) f32)."""
    check_cuda_inputs("kmeans_assign", x, centroids, lmask)
    p, n, d = x.shape
    l = centroids.shape[1]
    route = assign_route(x, l, lmask)
    blocks = d8_grid("kmeans_assign", "kmeans_assign_d8_occupancy", x, l,
                     D8_TILE, D8_MIN_TILES) if route == "d8" else 0
    codes = torch.empty((p, n), device=x.device, dtype=torch.int32)
    sqdist = torch.empty((p, n), device=x.device, dtype=torch.float32)
    _build.launch("kmeans_assign", "kmeans_assign_launch", _ARGTYPES, x,
                  centroids, lmask, codes, sqdist, p, n, l, d,
                  ROUTE_IDS[route], int(x.dtype == torch.bfloat16), D8_TILE,
                  blocks)
    _build.count("kmeans_assign")
    return codes, sqdist

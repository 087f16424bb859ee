"""Batched Lloyd k-means for the quantizer (twin of ``repro/core/kmeans.py``).

The reference runs one k-means problem per call and ``jax.vmap``s it over
codebook groups and clients. Here every function takes a leading problem
axis P = clients·R natively, so one kernel launch serves all problems:
points ``x`` are (P, N, D), codebooks (P, L, D).

Backend registry
----------------
  * ``"torch"`` -- plain PyTorch ops on any device (twin of ``"jnp"``).
  * ``"cuda"``  -- the hand-written CUDA kernels in ``repro_torch.kernels``
                   (twin of ``"pallas"``); CUDA tensors only, it raises on
                   any other device.
  * ``"auto"``  -- ``"cuda"`` for CUDA tensors, ``"torch"`` otherwise.

A backend bundles the two primitives the quantizer runs:

  * ``update(x, weights, cents) -> (dsums, counts)`` -- one Lloyd
    iteration's deviation-accumulated statistics.
  * ``encode(x, cents) -> (z̃, residual, codes)`` -- the fused final pass.

Numerics (as in the reference): the centroid update accumulates deviations
from the current centroid, ``c_new = c_old + Σ onehot·(x − c_old) / count``,
so a cluster that exactly covers its points is a fixed point in f32, and a
cluster with count 0 keeps its centroid exactly. Rows padded to a chunk
multiple carry weight 0.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops, ref


class Backend(NamedTuple):
    """A quantizer compute backend (see module docstring)."""
    name: str
    update: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    encode: Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _all_valid(c: torch.Tensor) -> torch.Tensor:
    return torch.ones(c.shape[-2], device=c.device)


def _update_torch(x, weights, cents):
    return ref.lloyd_update_ref(x, weights, cents, _all_valid(cents))


def _encode_torch(x, cents):
    return ref.pq_quantize_ref(x, cents, _all_valid(cents))


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"quantizer backend 'cuda' runs CUDA tensors only; "
                         f"got a tensor on {x.device} (use 'torch' or "
                         f"'auto')")


def _update_cuda(x, weights, cents):
    _require_cuda(x)
    return ops.lloyd_update(x, cents, weights)


def _encode_cuda(x, cents):
    _require_cuda(x)
    return ops.pq_quantize(x, cents)


_REGISTRY: Dict[str, Backend] = {
    "torch": Backend("torch", _update_torch, _encode_torch),
    "cuda": Backend("cuda", _update_cuda, _encode_cuda),
}


def available_backends() -> Tuple[str, ...]:
    return tuple(_REGISTRY) + ("auto",)


def resolve_backend(name: str, device: torch.device) -> str:
    """Resolve ``"auto"`` for tensors on ``device``."""
    if name == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return name


def get_backend(name: str, device: torch.device) -> Backend:
    resolved = resolve_backend(name, device)
    try:
        return _REGISTRY[resolved]
    except KeyError:
        raise ValueError(
            f"unknown quantizer backend {name!r} (resolved {resolved!r}); "
            f"registered: {sorted(_REGISTRY)}") from None


# ---------------------------------------------------------------------------
# Lloyd iterations
# ---------------------------------------------------------------------------

def _init_centroids(x: torch.Tensor, num_clusters: int) -> torch.Tensor:
    """Deterministic farthest-point seeding on a strided subsample, per
    problem. x (P, N, D) f32 -> (P, L, D). The reference's keyed
    (kmeans++) seeding draws from ``jax.random`` and is not ported."""
    p, n, d = x.shape
    L = num_clusters
    m = min(n, max(4 * L, 256))
    xs = x[:, ::max(n // m, 1)][:, :m]
    rows = torch.arange(p, device=x.device)
    cents = torch.zeros((p, L, d), dtype=x.dtype, device=x.device)
    cents[:, 0] = xs[:, 0]
    mind = (xs - xs[:, :1]).square().sum(-1)
    for l in range(1, L):
        c = xs[rows, mind.argmax(-1)]         # first maximum, as jnp.argmax
        cents[:, l] = c
        mind = torch.minimum(mind, (xs - c[:, None]).square().sum(-1))
    return cents


def batched_lloyd(x: torch.Tensor, num_clusters: int, num_iters: int = 8, *,
                  chunk: int = 4096, backend: str = "auto") -> torch.Tensor:
    """Lloyd iterations over P problems from farthest-point seeds:
    x (P, N, D) -> f32 (P, L, D)."""
    x = x.float()
    p, n, _ = x.shape
    L = num_clusters
    b = get_backend(backend, x.device)
    # pad N up to a multiple of chunk, as the reference's scan tiles do;
    # padded rows carry zero weight
    chunk = min(chunk, max(n, 1))
    n_pad = (-n) % chunk
    x_pad = torch.nn.functional.pad(x, (0, 0, 0, n_pad))
    weights = (torch.arange(n + n_pad, device=x.device) < n).float() \
        .expand(p, -1).contiguous()

    cents = _init_centroids(x, L)
    for _ in range(num_iters):
        dsums, counts = b.update(x_pad, weights, cents)
        # empty clusters keep their previous centroid
        cnt = counts.unsqueeze(-1)
        cents = cents + torch.where(cnt > 0, dsums / cnt.clamp_min(1.0), 0.0)
    return cents


def lloyd(x: torch.Tensor, num_clusters: int, num_iters: int = 8, *,
          chunk: int = 4096, backend: str = "auto") -> torch.Tensor:
    """One problem: x (N, D) -> f32 centroids (L, D)."""
    return batched_lloyd(x[None], num_clusters, num_iters, chunk=chunk,
                         backend=backend)[0]

"""Batched Lloyd k-means for the quantizer (twin of ``repro/core/kmeans.py``).

The reference runs one k-means problem per call and ``jax.vmap``s it over
codebook groups and clients. Here every function takes a leading problem
axis P = clients·R natively, so one kernel launch serves all problems:
points ``x`` are (P, N, D), codebooks (P, L, D).

Backends (``"torch"``, ``"cuda"``, ``"auto"``; ``kernels/ops.BACKENDS``):
``ops.use_kernel`` says whether a call takes the CUDA kernels (twin of
``"pallas"``) or their plain versions in ``kernels/ref`` (twin of
``"jnp"``). Three primitives run: ``lloyd_update`` (one Lloyd iteration's
deviation-accumulated statistics), ``pq_quantize`` (the quantizer's fused
final pass) and ``kmeans_assign`` (``batched_kmeans``' codes and
distortion).

Warm start: ``lloyd`` / ``batched_lloyd`` / ``kmeans`` take
``init_centroids`` to resume from a previous round's codebooks instead of
seeding (``core/quantizer.QuantizerState`` builds on it). Seeding is
farthest-point without a generator and kmeans++ (D² sampling) with one;
an explicit ``torch.Generator`` on the points' device replaces the
reference's PRNG key (the two draw different numbers).

Numerics (as in the reference): the centroid update accumulates deviations
from the current centroid, ``c_new = c_old + Σ onehot·(x − c_old) / count``,
so a cluster that exactly covers its points is a fixed point in f32, and a
cluster with count 0 keeps its centroid exactly. On the plain versions
the rows are padded to a chunk multiple, as the reference's scan tiles
them, and the padded rows carry weight 0; on the kernels nothing is
padded and no weights are built (the kernels mask their ragged last
tile), and x is read in its own dtype (f32 or bf16; the kernels upcast in
registers, exactly).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch.kernels import ops, ref


class KMeansResult(NamedTuple):
    centroids: torch.Tensor   # (..., L, D) in x.dtype
    codes: torch.Tensor       # (..., N) int32
    distortion: torch.Tensor  # (...) mean squared error per point (f32)


# ---------------------------------------------------------------------------
# Lloyd iterations
# ---------------------------------------------------------------------------

def _init_centroids(x: torch.Tensor, num_clusters: int,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Seeds on a strided subsample, per problem: x (P, N, D) -> f32
    (P, L, D) (the subsample is upcast; bf16 -> f32 is exact). Without a
    generator, deterministic farthest-point (each next seed the first
    point farthest from the seeds so far); with one,
    kmeans++: each next seed drawn with probability ∝ its squared distance
    to the seeds so far (floored at 1e-30, as the reference's logits)."""
    p, n, d = x.shape
    L = num_clusters
    m = min(n, max(4 * L, 256))
    xs = x[:, ::max(n // m, 1)][:, :m].float()
    rows = torch.arange(p, device=x.device)
    cents = torch.zeros((p, L, d), dtype=torch.float32, device=x.device)
    cents[:, 0] = xs[:, 0]
    mind = (xs - xs[:, :1]).square().sum(-1)
    for l in range(1, L):
        if generator is None:
            idx = mind.argmax(-1)             # first maximum, as jnp.argmax
        else:
            idx = torch.multinomial(mind.clamp_min(1e-30), 1,
                                    generator=generator)[:, 0]
        c = xs[rows, idx]
        cents[:, l] = c
        mind = torch.minimum(mind, (xs - c[:, None]).square().sum(-1))
    return cents


def batched_lloyd(x: torch.Tensor, num_clusters: int, num_iters: int = 8, *,
                  generator: Optional[torch.Generator] = None,
                  chunk: int = 4096, backend: str = "auto",
                  init_centroids: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Lloyd iterations over P problems: x (P, N, D) -> f32 (P, L, D).

    ``init_centroids`` (P, L, D) warm-starts them from a previous round's
    codebooks instead of seeding; ``num_iters=0`` then returns the
    initializer unchanged (in f32). The centroids and their update are
    f32 whatever x's dtype."""
    p, n, d = x.shape
    L = num_clusters
    kernel = ops.use_kernel(x, backend)
    with obs.span("kmeans.lloyd", cat="kmeans"):
        if init_centroids is not None:
            cents = init_centroids.float()
            if cents.shape != (p, L, d):
                raise ValueError(f"init_centroids {tuple(cents.shape)} != "
                                 f"{(p, L, d)}")
        else:
            with obs.span("kmeans.seed", cat="kmeans"):
                cents = _init_centroids(x, L, generator)
        if num_iters == 0:
            return cents
        if kernel:
            weights = None
        else:
            # pad N up to a multiple of chunk, as the reference's scan
            # tiles do; padded rows carry zero weight
            x = x.float()
            chunk = min(chunk, max(n, 1))
            n_pad = (-n) % chunk
            x = torch.nn.functional.pad(x, (0, 0, 0, n_pad))
            weights = (torch.arange(n + n_pad, device=x.device) < n) \
                .float().expand(p, -1).contiguous()
        for _ in range(num_iters):
            dsums, counts = ops.lloyd_update(x, cents) if kernel \
                else ref.lloyd_update_ref(x, weights, cents)
            # empty clusters keep their previous centroid
            cnt = counts.unsqueeze(-1)
            cents = cents + torch.where(cnt > 0, dsums / cnt.clamp_min(1.0),
                                        0.0)
        return cents


def lloyd(x: torch.Tensor, num_clusters: int, num_iters: int = 8, *,
          generator: Optional[torch.Generator] = None, chunk: int = 4096,
          backend: str = "auto",
          init_centroids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One problem: x (N, D) -> f32 centroids (L, D); ``init_centroids``
    (L, D) warm-starts it."""
    init = None if init_centroids is None else init_centroids[None]
    return batched_lloyd(x[None], num_clusters, num_iters,
                         generator=generator, chunk=chunk, backend=backend,
                         init_centroids=init)[0]


def batched_kmeans(x: torch.Tensor, num_clusters: int, num_iters: int = 8,
                   *, generator: Optional[torch.Generator] = None,
                   chunk: int = 4096, backend: str = "auto",
                   init_centroids: Optional[torch.Tensor] = None
                   ) -> KMeansResult:
    """Lloyd's algorithm with a fixed iteration count on P problems.

    x (P, N, D), computed in f32 whatever its dtype; on the kernels an f32
    or bf16 x is read as it is, with no f32 copy (the kernels upcast in
    registers, exactly), so a bf16 x gives bitwise its f32 upcast's result.
    Returns ``KMeansResult(centroids (P, L, D) in x.dtype, codes (P, N)
    int32, distortion (P,))``: the codes and the mean squared distance per
    point come from ``kmeans_assign`` (one launch on the kernels)."""
    cents = batched_lloyd(x, num_clusters, num_iters, generator=generator,
                          chunk=chunk, backend=backend,
                          init_centroids=init_centroids)
    if ops.use_kernel(x, backend):
        codes, sqdist = ops.kmeans_assign(x, cents)
    else:
        codes, sqdist = ref.kmeans_assign_ref(x, cents)
        codes = codes.to(torch.int32)
    distortion = sqdist.sum(-1) / max(x.shape[1], 1)
    return KMeansResult(cents.to(x.dtype), codes, distortion)


def kmeans(x: torch.Tensor, num_clusters: int, num_iters: int = 8, *,
           generator: Optional[torch.Generator] = None, chunk: int = 4096,
           backend: str = "auto",
           init_centroids: Optional[torch.Tensor] = None) -> KMeansResult:
    """One problem: x (N, D) -> ``KMeansResult`` with centroids (L, D),
    codes (N,) and a scalar distortion."""
    init = None if init_centroids is None else init_centroids[None]
    res = batched_kmeans(x[None], num_clusters, num_iters,
                         generator=generator, chunk=chunk, backend=backend,
                         init_centroids=init)
    return KMeansResult(*(t[0] for t in res))

"""FedLite's grouped product quantizer (twin of ``repro/core/quantizer.py``).

Each activation vector of width d is cut into q subvectors of d/q values;
subvector positions are stacked into R groups (group r holds positions
[r·q/R, (r+1)·q/R)), and each group is clustered into L centroids. The
message is the codebooks plus one ⌈log2 L⌉-bit code per subvector.

Clients: ``quantize`` takes z as (C, n, d) -- C clients of n vectors each,
every client with its own codebooks. The reference vmaps over clients;
here the C·R groups are the leading problem axis of one batched Lloyd run
and of one encode, so each Lloyd iteration and the final encode are one
kernel launch whatever C and R are.

Backends (``PQConfig.backend``): ``"auto"`` (the CUDA kernels for CUDA
tensors, plain PyTorch otherwise), ``"cuda"`` or ``"torch"``; see
``kernels/ops.py``.

Cross-round codebook warm start: ``QuantizerState`` carries each client's
f32 codebooks and a round counter. A cold round (no state) seeds and runs
``kmeans_iters`` Lloyd iterations; a warm round (``quantize_stateful`` with
a prior state) resumes from the codebooks and runs
``PQConfig.effective_warm_iters`` (default ``kmeans_iters // 2``).
A ``torch.Generator`` makes the cold seeding kmeans++ instead of
farthest-point.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import kmeans as _km
from repro_torch.kernels import ops, ref


def bits_per_code(num_clusters: int) -> int:
    """Packed index width b = ceil(log2 L); a single cluster needs no codes."""
    return 0 if num_clusters <= 1 else \
        max(math.ceil(math.log2(num_clusters)), 1)


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Static quantizer hyperparameters."""
    num_subvectors: int          # q -- subvectors per activation vector
    num_clusters: int            # L -- centroids per group
    num_groups: int = 1          # R -- codebook groups (paper default 1)
    kmeans_iters: int = 8
    phi_bits: int = 64           # float width used for *accounting*
    kmeans_chunk: int = 4096
    backend: str = "auto"        # "torch" | "cuda" | "auto"
    warm_iters: Optional[int] = None  # Lloyd iterations on warm rounds
    #                                   (None = kmeans_iters // 2)

    def __post_init__(self):
        if self.num_subvectors % self.num_groups != 0:
            raise ValueError(f"q={self.num_subvectors} must be divisible by "
                             f"R={self.num_groups}")
        if self.num_clusters < 1:
            raise ValueError("L must be >= 1")
        ops.check_backend(self.backend)
        if self.warm_iters is not None and self.warm_iters < 0:
            raise ValueError(f"warm_iters={self.warm_iters} must be >= 0")

    @property
    def q(self) -> int:
        return self.num_subvectors

    @property
    def r(self) -> int:
        return self.num_groups

    @property
    def l(self) -> int:
        return self.num_clusters

    @property
    def effective_warm_iters(self) -> int:
        """Lloyd iterations on a warm-started round."""
        return self.kmeans_iters // 2 if self.warm_iters is None \
            else self.warm_iters

    def subvector_dim(self, d: int) -> int:
        if d % self.num_subvectors != 0:
            raise ValueError(f"d={d} not divisible by q={self.num_subvectors}")
        return d // self.num_subvectors

    @property
    def bits_per_code(self) -> int:
        return bits_per_code(self.num_clusters)

    def codebook_shape(self, d: int) -> tuple:
        """(R, L, d/q) -- the centroid tensor one client's uplink carries."""
        return (self.num_groups, self.num_clusters, self.subvector_dim(d))

    def num_codes(self, n: int) -> int:
        return n * self.num_subvectors

    # ---- communication accounting (paper §4.1) -------------------------
    def codebook_bits(self, d: int, phi_bits: Optional[int] = None) -> int:
        phi = self.phi_bits if phi_bits is None else phi_bits
        return phi * self.subvector_dim(d) * self.num_clusters \
            * self.num_groups

    def codes_bits(self, n: int) -> int:
        return self.num_codes(n) * self.bits_per_code

    def message_bits(self, n: int, d: int,
                     phi_bits: Optional[int] = None) -> int:
        return self.codebook_bits(d, phi_bits) + self.codes_bits(n)

    def uncompressed_bits(self, n: int, d: int,
                          phi_bits: Optional[int] = None) -> int:
        phi = self.phi_bits if phi_bits is None else phi_bits
        return phi * d * n

    def compression_ratio(self, n: int, d: int,
                          phi_bits: Optional[int] = None) -> float:
        return self.uncompressed_bits(n, d, phi_bits) / \
            max(self.message_bits(n, d, phi_bits), 1)


class QuantizedBatch(NamedTuple):
    """Per-client results; the leading axis of every field is the client."""
    dequantized: torch.Tensor   # (C, n, d) -- z̃, z.dtype
    codes: torch.Tensor         # (C, R, q/R·n) int32
    codebooks: torch.Tensor     # (C, R, L, d/q) z.dtype
    distortion: torch.Tensor    # (C,) mean ‖z − z̃‖² per vector (f32 sums)
    residual: torch.Tensor      # (C, n, d) z − z̃ in z.dtype


class QuantizerState(NamedTuple):
    """Cross-round quantizer carry, per client: the last round's codebooks
    (kept in f32, the Lloyd dtype) and how many quantizes contributed to
    them."""
    codebooks: torch.Tensor     # (C, R, L, d/q) f32
    rounds: torch.Tensor        # (C,) int32


def init_quantizer_state(qb: QuantizedBatch) -> QuantizerState:
    """Bootstrap a warm-start state from a cold round's output."""
    c = qb.codebooks.shape[0]
    return QuantizerState(
        codebooks=qb.codebooks.float(),
        rounds=torch.ones((c,), dtype=torch.int32,
                          device=qb.codebooks.device))


def _to_groups(z: torch.Tensor, cfg: PQConfig) -> torch.Tensor:
    """(C, n, d) -> (C·R, (q/R)·n, d/q): group r of client c holds
    subvector positions [r·q/R, (r+1)·q/R) of that client's n vectors,
    position-major, row for row as the reference lays them out."""
    c, n, d = z.shape
    dsub = cfg.subvector_dim(d)
    sub = z.reshape(c, n, cfg.q, dsub).transpose(1, 2)    # (C, q, n, dsub)
    return sub.reshape(c * cfg.r, (cfg.q // cfg.r) * n, dsub).contiguous()


def _from_groups(groups: torch.Tensor, c: int, n: int, d: int,
                 cfg: PQConfig) -> torch.Tensor:
    dsub = cfg.subvector_dim(d)
    sub = groups.reshape(c, cfg.q, n, dsub).transpose(1, 2)
    return sub.reshape(c, n, d)


def quantize(z: torch.Tensor, cfg: PQConfig,
             generator: Optional[torch.Generator] = None, *,
             state: Optional[QuantizerState] = None) -> QuantizedBatch:
    """Quantize C clients' activations with the grouped PQ scheme.

    z: (C, n, d), any float dtype; each client gets its own R codebooks.
    Lloyd runs exactly once; the final z̃ + residual + codes come from one
    fused encode, so the gradient correction reuses the residual instead of
    recomputing it.

    ``state`` (a previous round's ``QuantizerState``) switches Lloyd to the
    warm start: no seeding, and ``cfg.effective_warm_iters`` iterations
    from ``state.codebooks``. ``generator`` seeds a cold round by kmeans++.
    """
    c, n, d = z.shape
    # grouped in the cut's own dtype where the kernels read it (f32, bf16:
    # they upcast in registers, exactly); Lloyd's centroids are f32
    zg = z if z.dtype in (torch.float32, torch.bfloat16) else z.float()
    groups = _to_groups(zg, cfg)                         # (C·R, M, dsub)
    if state is None:
        cents = _km.batched_lloyd(groups, cfg.num_clusters, cfg.kmeans_iters,
                                  generator=generator,
                                  chunk=cfg.kmeans_chunk,
                                  backend=cfg.backend)
    else:
        init = state.codebooks.reshape(c * cfg.r, cfg.num_clusters, -1)
        cents = _km.batched_lloyd(groups, cfg.num_clusters,
                                  cfg.effective_warm_iters,
                                  chunk=cfg.kmeans_chunk,
                                  backend=cfg.backend, init_centroids=init)
    recon, resid, codes = ops.pq_quantize(groups, cents) \
        if ops.use_kernel(groups, cfg.backend) \
        else ref.pq_quantize_ref(groups, cents)
    z_tilde = _from_groups(recon, c, n, d, cfg).to(z.dtype)
    # the residual is kept in z.dtype (the correction saves it for the
    # backward pass); the distortion is summed in f32 first
    residual = _from_groups(resid, c, n, d, cfg).to(z.dtype)
    per_vec = resid.reshape(c, -1).square().sum(-1) / max(n, 1)
    return QuantizedBatch(
        z_tilde, codes.reshape(c, cfg.r, -1),
        cents.reshape(c, cfg.r, cfg.num_clusters, -1).to(z.dtype), per_vec,
        residual)


def quantize_stateful(z: torch.Tensor, cfg: PQConfig,
                      state: Optional[QuantizerState] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[QuantizedBatch, QuantizerState]:
    """Warm-start-aware quantize: (batch, next round's state).

    ``state=None`` runs the cold round and bootstraps the state (rounds 1);
    a prior state runs the warm round and counts it."""
    qb = quantize(z, cfg, generator, state=state)
    rounds = torch.zeros((z.shape[0],), dtype=torch.int32,
                         device=z.device) if state is None else state.rounds
    return qb, QuantizerState(codebooks=qb.codebooks.float(),
                              rounds=rounds + 1)


def quantization_error(z: torch.Tensor, cfg: PQConfig) -> torch.Tensor:
    """Mean relative quantization error ‖z − z̃‖/‖z‖ over each client's
    vectors (for Fig. 3): z (C, n, d) -> (C,)."""
    resid = quantize(z, cfg).residual.float()
    num = torch.linalg.vector_norm(resid, dim=-1)
    den = torch.linalg.vector_norm(z.float(), dim=-1).clamp_min(1e-12)
    return (num / den).mean(-1)


def vanilla_kmeans_config(num_clusters: int, **kw) -> PQConfig:
    """q = 1: quantize whole vectors (the paper's 'K-means' baseline)."""
    return PQConfig(num_subvectors=1, num_clusters=num_clusters,
                    num_groups=1, **kw)


def vanilla_pq_config(num_subvectors: int, num_clusters: int,
                      **kw) -> PQConfig:
    """R = q: per-position codebooks (the paper's 'vanilla PQ' baseline)."""
    return PQConfig(num_subvectors=num_subvectors, num_clusters=num_clusters,
                    num_groups=num_subvectors, **kw)

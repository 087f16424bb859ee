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
``core/kmeans.py``. Codebook warm start across rounds (``QuantizerState``)
and keyed seeding are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import kmeans as _km


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

    def __post_init__(self):
        if self.num_subvectors % self.num_groups != 0:
            raise ValueError(f"q={self.num_subvectors} must be divisible by "
                             f"R={self.num_groups}")
        if self.num_clusters < 1:
            raise ValueError("L must be >= 1")
        if self.backend not in _km.available_backends():
            raise ValueError(f"backend={self.backend!r} not one of "
                             f"{_km.available_backends()}")

    @property
    def q(self) -> int:
        return self.num_subvectors

    @property
    def r(self) -> int:
        return self.num_groups

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


def quantize(z: torch.Tensor, cfg: PQConfig) -> QuantizedBatch:
    """Quantize C clients' activations with the grouped PQ scheme.

    z: (C, n, d), any float dtype; each client gets its own R codebooks.
    Lloyd runs exactly once; the final z̃ + residual + codes come from one
    fused encode, so the gradient correction reuses the residual instead of
    recomputing it.
    """
    c, n, d = z.shape
    groups = _to_groups(z.float(), cfg)                  # (C·R, M, dsub)
    cents = _km.batched_lloyd(groups, cfg.num_clusters, cfg.kmeans_iters,
                              chunk=cfg.kmeans_chunk, backend=cfg.backend)
    enc = _km.get_backend(cfg.backend, z.device).encode
    recon, resid, codes = enc(groups, cents)
    z_tilde = _from_groups(recon, c, n, d, cfg).to(z.dtype)
    # the residual is kept in z.dtype (the correction saves it for the
    # backward pass); the distortion is summed in f32 first
    residual = _from_groups(resid, c, n, d, cfg).to(z.dtype)
    per_vec = resid.reshape(c, -1).square().sum(-1) / max(n, 1)
    return QuantizedBatch(
        z_tilde, codes.reshape(c, cfg.r, -1),
        cents.reshape(c, cfg.r, cfg.num_clusters, -1).to(z.dtype), per_vec,
        residual)

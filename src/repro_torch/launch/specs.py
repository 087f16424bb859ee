"""The default FedLite quantizer of the big archs and ``make_model`` for
every family (twin of the first part of ``repro/launch/specs.py``; its
ShapeDtypeStruct and mesh specs go with the mesh executor, ROADMAP
A13)."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compressors import make_compressor
from repro_torch.core.quantizer import PQConfig
from repro_torch.models.transformer import TransformerLM


def default_pq(cfg: ArchConfig, *, subvector_dim: int = 8,
               clusters: int = 16, iters: int = 4) -> PQConfig:
    """Paper-faithful defaults scaled to d_model: subvectors of dim 8 (the
    paper's FEMNIST best ratio uses d/q = 8), R=1, L=16. The encode backend
    comes from the arch config ("auto": the CUDA kernels for CUDA tensors,
    plain PyTorch otherwise); ``cfg.pq_warm_iters`` sets the warm-started
    Lloyd budget (None = kmeans_iters // 2)."""
    q = cfg.d_model // subvector_dim
    return PQConfig(num_subvectors=q, num_clusters=clusters, num_groups=1,
                    kmeans_iters=iters, kmeans_chunk=4096,
                    backend=cfg.pq_backend, warm_iters=cfg.pq_warm_iters)


def make_model(cfg: ArchConfig, *, with_pq: bool = True,
               lam: float = 1e-4) -> TransformerLM:
    """Build the split LM with the arch's per-direction cut codecs.

    ``cfg.uplink_compressor`` -- "pq" keeps the paper's grouped PQ fast path
    (``with_pq=False`` or "none" disables it: SplitFed); any other spec is
    parsed by ``core/compressors.make_compressor``.
    ``cfg.downlink_compressor`` installs a codec on the server->client
    gradient message ("none": the dense baseline)."""
    pq = default_pq(cfg) if with_pq and cfg.uplink_compressor == "pq" \
        else None
    spec_pq = default_pq(cfg) if with_pq else None
    uplink = None if cfg.uplink_compressor in ("pq", "none") \
        else make_compressor(cfg.uplink_compressor, pq=spec_pq)
    downlink = None if cfg.downlink_compressor == "none" \
        else make_compressor(cfg.downlink_compressor, pq=spec_pq)
    return TransformerLM(cfg, pq=pq, lam=lam, uplink_compressor=uplink,
                         downlink_compressor=downlink)

"""The default FedLite quantizer of the big archs, ``make_model`` for
every family, and the sharded stand-ins of the dry run (twin of
``repro/launch/specs.py``).

The reference's ``ShapeDtypeStruct``s with a ``NamedSharding`` become
DTensors over ``FakeTensor`` locals: abstract and sharded, with no device
allocation. They are built inside the ambient ``FakeTensorMode`` (the dry
run's, whose tensors they then trace with), or a fresh one. Every
sharding is guarded by divisibility (a dim that does not divide the mesh
axis falls back to the next candidate or to replication), so one spec
builder serves every (arch × input shape × mesh) combination.
``distribute_batch`` and ``distribute_caches`` lay real tensors out with
the same specs, for the launchers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.compressors import make_compressor
from repro_torch.core.fedlite import TrainState, flat_params, nest_like
from repro_torch.core.quantizer import PQConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.ctx import (BATCH, P, filter_spec, mesh_shape,
                                      to_placements)
from repro_torch.sharding.rules import inference_param_specs, param_specs


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


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

def _axis_size(mesh: DeviceMesh, entry) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    shape = mesh_shape(mesh)
    return math.prod(shape[n] for n in names if n in shape)


def _fit(mesh: DeviceMesh, shape: Tuple[int, ...], *candidates: P) -> P:
    """First candidate spec whose sharded dims all divide; else
    replicated."""
    for spec in candidates:
        spec_f = filter_spec(spec, mesh)
        entries = list(spec_f) + [None] * (len(shape) - len(spec_f))
        if all(d % _axis_size(mesh, e) == 0 for d, e in zip(shape, entries)):
            return spec_f
    return P()


@contextlib.contextmanager
def _fake():
    """The ambient ``FakeTensorMode``, or a fresh one."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) \
            is not None:
        yield
    else:
        with FakeTensorMode():
            yield


def abstract(mesh: DeviceMesh, shape, dtype: torch.dtype, spec: P, *,
             device="cpu") -> DTensor:
    """A DTensor of global ``shape`` laid out by ``spec`` over ``mesh``,
    its local block a ``FakeTensor`` (no memory)."""
    shape = tuple(shape)
    placements = to_placements(spec, mesh, len(shape))
    local = list(shape)
    coord = mesh.get_coordinate()
    for m, pl in enumerate(placements):   # torch.chunk's blocks, in order
        if isinstance(pl, Shard):
            n, c = mesh.size(m), coord[m]
            chunk = -(-local[pl.dim] // n)
            local[pl.dim] = max(0, min(local[pl.dim], (c + 1) * chunk)
                                - c * chunk)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    with _fake():
        t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _struct(mesh, shape, dtype, *candidates: P, device="cpu") -> DTensor:
    return abstract(mesh, shape, dtype, _fit(mesh, tuple(shape), *candidates),
                    device=device)


# ---------------------------------------------------------------------------
# model inputs per input-shape
# ---------------------------------------------------------------------------

def _batch_specs(cfg: ArchConfig, shape: InputShape, *,
                 with_labels: bool = True):
    """{name: (global shape, dtype, candidate spec)} of a batch."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int64
    out = {}
    if cfg.family == "vlm":
        S_vis = int(S * cfg.vision_tokens_frac) // 16 * 16
        out["tokens"] = ((B, S - S_vis), tok, P(BATCH, None))
        out["vision_embeds"] = ((B, S_vis, cfg.vision_embed_dim),
                                torch.float32, P(BATCH, None, None))
        out["positions"] = ((3, B, S), torch.int32, P(None, BATCH, None))
        if with_labels:
            out["labels"] = ((B, S), tok, P(BATCH, None))
    elif cfg.num_codebooks > 1:
        out["tokens"] = ((B, cfg.num_codebooks, S), tok,
                         P(BATCH, None, None))
        if with_labels:
            out["labels"] = out["tokens"]
    else:
        out["tokens"] = ((B, S), tok, P(BATCH, None))
        if with_labels:
            out["labels"] = ((B, S), tok, P(BATCH, None))
    return out


def input_specs(cfg: ArchConfig, shape: InputShape, mesh: DeviceMesh,
                *, with_labels: bool = True,
                device="cpu") -> Dict[str, DTensor]:
    """Abstract batch for (arch, input shape): tokens/labels (+
    modality)."""
    with _fake():
        return {k: _struct(mesh, shp, dt, spec, device=device)
                for k, (shp, dt, spec) in _batch_specs(
                    cfg, shape, with_labels=with_labels).items()}


def decode_token_specs(cfg: ArchConfig, shape: InputShape,
                       mesh: DeviceMesh, *, device="cpu") -> DTensor:
    B = shape.global_batch
    if cfg.num_codebooks > 1:
        return _struct(mesh, (B, cfg.num_codebooks, 1), torch.int64,
                       P(BATCH, None, None), device=device)
    return _struct(mesh, (B, 1), torch.int64, P(BATCH, None),
                   device=device)


def distribute_batch(batch: Mapping[str, torch.Tensor],
                     mesh: DeviceMesh) -> Dict[str, DTensor]:
    """A batch (the same on every rank) laid out as ``input_specs`` lays
    it: rows over the batch axes (M-RoPE positions on their dim 1)."""
    def spec(k, t):
        lead = (None,) if k == "positions" else ()
        return _fit(mesh, tuple(t.shape), P(*lead, BATCH))
    return {k: distribute_tensor(t, mesh, to_placements(spec(k, t), mesh))
            for k, t in batch.items()}


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------

def cache_spec_tree(model: TransformerLM, batch_size: int, max_len: int,
                    mesh: DeviceMesh, *, seq_shard_budget: int = 4 << 30):
    """(cache shapes on the meta device, their specs).

    Adaptive policy: batch-only sharding when the whole cache fits
    ``seq_shard_budget`` bytes/device (no collectives on the decode cache
    update); otherwise the cache-seq dim is additionally sharded over
    "model". SSM states are head-sharded. Unlike the reference, whose
    ``/conv`` rule misses the B/C stream's ``conv_bc`` tail (left
    replicated), that tail's rows follow the batch: the SSM block writes
    each rank's rows in place."""
    shapes = model.init_caches(batch_size, max_len, device="meta")
    return shapes, _cache_specs(shapes, batch_size, mesh, seq_shard_budget)


def _cache_specs(caches, batch_size: int, mesh: DeviceMesh, budget: int):
    batch_shards = _axis_size(mesh, BATCH)
    leaves = flat_params(caches)
    total = sum(t.numel() * t.element_size() for t in leaves.values())
    per_dev_batch_only = total / max(batch_shards, 1) \
        if batch_size % max(batch_shards, 1) == 0 else float("inf")
    prefer_batch_only = per_dev_batch_only <= budget

    def spec_of(path: str, t: torch.Tensor) -> P:
        shp = tuple(t.shape[1:])  # strip the stacked periods dim
        if path.endswith("/pos"):
            return P()
        if path.endswith("/k") or path.endswith("/v"):
            if prefer_batch_only:
                base = _fit(mesh, shp,
                            P(BATCH, None, None, None),
                            P(BATCH, "model", None, None),
                            P(None, ("data", "model"), None, None),
                            P(None, "data", None, None))
            else:
                base = _fit(mesh, shp,
                            P(BATCH, "model", None, None),
                            P(BATCH, None, "model", None),
                            P(BATCH, None, None, None),
                            P(None, ("data", "model"), None, None),
                            P(None, "data", None, None))
        elif path.endswith("/h"):
            base = _fit(mesh, shp,
                        P(BATCH, "model", None, None),
                        P(BATCH, None, None, None),
                        P(None, "model", None, None))
        elif path.endswith("/conv"):
            base = _fit(mesh, shp,
                        P(BATCH, None, "model"),
                        P(BATCH, None, None),
                        P(None, None, "model"))
        elif path.endswith("/conv_bc"):
            base = _fit(mesh, shp, P(BATCH, None, None))
        else:
            base = P()
        return P(None, *base)

    return nest_like(caches, {k: spec_of("/" + k, t)
                              for k, t in leaves.items()})


def cache_specs(model: TransformerLM, batch_size: int, max_len: int,
                mesh: DeviceMesh, *, seq_shard_budget: int = 4 << 30,
                device="cpu"):
    """Abstract caches with shardings (``cache_spec_tree``'s policy)."""
    shapes, specs = cache_spec_tree(model, batch_size, max_len, mesh,
                                    seq_shard_budget=seq_shard_budget)
    flat = flat_params(specs)
    with _fake():
        return nest_like(shapes, {
            k: abstract(mesh, t.shape, t.dtype, flat[k], device=device)
            for k, t in flat_params(shapes).items()})


def distribute_caches(caches, batch_size: int, mesh: DeviceMesh, *,
                      seq_shard_budget: int = 4 << 30):
    """Real caches (``model.init_caches(batch_size, ...)``, the same on
    every rank) laid out by ``cache_spec_tree``'s policy."""
    flat = flat_params(_cache_specs(caches, batch_size, mesh,
                                    seq_shard_budget))
    return nest_like(caches, {k: distribute_tensor(
        t, mesh, to_placements(flat[k], mesh))
        for k, t in flat_params(caches).items()})


# ---------------------------------------------------------------------------
# train-state specs
# ---------------------------------------------------------------------------

def state_specs(model: TransformerLM, optimizer, mesh: DeviceMesh, *,
                inference: bool = False, device="cpu") -> TrainState:
    """Abstract TrainState: params laid out by the rules (``inference=True``
    uses the serving layout, the FSDP dim folded into TP -- see
    ``sharding/rules.inference_spec``), and the optimizer state the
    optimizer's ``init`` makes from them (each moment in its param's
    layout, as the reference's rules give it)."""
    shapes = model.init(None, "meta")
    specs = inference_param_specs(shapes, mesh) if inference \
        else param_specs(shapes, mesh)
    flat_specs = flat_params(specs)
    with _fake():
        params = nest_like(shapes, {
            k: abstract(mesh, t.shape, t.dtype, flat_specs[k], device=device)
            for k, t in flat_params(shapes).items()})
        opt_state = optimizer.init(flat_params(params))
    return TrainState(params=params, opt_state=opt_state, step=0)

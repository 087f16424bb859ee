"""The paper's FEMNIST CNN (twin of ``repro/models/paper_models.py``).

Client: Conv(32, 3x3) + ReLU + Conv(64, 3x3) + ReLU + MaxPool(2) + Flatten,
so the cut activation has d = 12·12·64 = 9216 (the paper's d). Server:
Dense(128) + ReLU + Dense(62). The grouped PQ with the eq.-5 corrected
backward runs at the cut, with per-client codebooks when ``client_batch``
splits the batch; a ``downlink_compressor`` squeezes the server->client
gradient in the backward pass, and a ``CutState`` carries the codebooks
(warm start) and error-feedback memory from one step to the next.

Layouts: the public batch keeps the reference's NHWC images; the
convolutions run in PyTorch's NCHW, and the cut is flattened in NHWC order,
as the reference flattens it. Without that permute the 8-value subvectors
of the cut would be different vectors and PQ parity would break. Parameter
names mirror the reference's keys (``client.conv1_w``, ...); convolution
weights are OIHW here (HWIO there), dense weights stay (in, out) and are
applied as ``acts @ W``. ``from_jax_params`` converts reference params.

The SO Tag MLP and SO NWP LSTM are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.compressors import (CutCompressor, CutState,
                                          PQCompressor, compress_downlink,
                                          compress_downlink_keyed,
                                          compress_with_correction_carry,
                                          make_compressor)
from repro_torch.core.correction import quantize_with_correction_stats
from repro_torch.core.quantizer import PQConfig


def _maybe_quantize(x: torch.Tensor, pq: Optional[PQConfig], lam,
                    quantize: bool, client_batch: int = 0,
                    lam_override=None,
                    downlink: Optional[CutCompressor] = None, *,
                    key: Optional[torch.Generator] = None,
                    cut_state: Optional[CutState] = None):
    """Apply the cut-layer codecs per client: the batch is split into
    cohorts of ``client_batch`` examples, each with its own codebooks, when
    ``client_batch`` divides the batch into more than one cohort; otherwise
    the whole batch is one client (as the reference decides).

    ``downlink`` compresses the server->client gradient cotangent in the
    backward pass, after the uplink's codec, so the eq.-5 correction adds
    λ·residual to the compressed cotangent; ``None`` or ``"none"`` leaves
    the backward pass bitwise untouched. ``key``, a ``torch.Generator`` on
    the cut's device, makes a scalarq downlink round stochastically.
    ``cut_state`` switches the uplink to the state-carrying hook (warm
    start, optional error feedback); the new state comes back under
    ``stats["cut_state"]``, with its EF memory in the cut's (B, d) layout."""
    if lam_override is not None:
        lam = lam_override
    has_dl = quantize and downlink is not None and downlink.name != "none"
    if not quantize or (pq is None and not has_dl):
        return x, {}
    b = x.shape[0]
    per_client = bool(client_batch and b % client_batch == 0
                      and b > client_batch)
    clients = b // client_batch if per_client else 1
    zt = x.reshape(clients, b // clients, x.shape[-1])
    stats = {}
    if pq is not None:
        if cut_state is not None:
            if cut_state.ef_memory is not None and \
                    cut_state.ef_memory.shape == x.shape:
                cut_state = cut_state._replace(
                    ef_memory=cut_state.ef_memory.reshape(zt.shape))
            zt, dist, new_state = compress_with_correction_carry(
                zt, lam, cut_state, PQCompressor(pq))
            if new_state.ef_memory is not None:
                new_state = new_state._replace(
                    ef_memory=new_state.ef_memory.reshape(x.shape))
            stats["cut_state"] = new_state
        else:
            zt, dist = quantize_with_correction_stats(zt, lam, pq)
        stats.update({
            "pq_distortion": dist.mean(),
            "pq_compression_ratio": float(pq.compression_ratio(
                b, x.shape[-1])),
        })
    if has_dl:
        zt = compress_downlink(zt, downlink) if key is None \
            else compress_downlink_keyed(zt, key, downlink)
    return zt.reshape(x.shape), stats


class FemnistCNN(nn.Module):
    """28x28x1 -> 62 classes; cut after the flatten (d = 9216).

    ``forward(batch)`` returns (cross-entropy loss, metrics) -- the
    reference's ``loss`` -- so ``torch.func.functional_call`` drives it
    from a dict of parameters in ``core.fedlite.make_train_step``."""

    cut_dim = 9216  # 12*12*64

    def __init__(self, num_classes: int = 62, pq: Optional[PQConfig] = None,
                 lam: float = 0.0, client_batch: int = 0,
                 downlink_compressor=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        """``downlink_compressor`` is a ``CutCompressor`` or a spec string
        (``core/compressors.make_compressor``; a bare ``"pq"`` wraps
        ``pq``)."""
        super().__init__()
        self.num_classes = num_classes
        self.pq = pq
        self.lam = lam
        self.client_batch = client_batch
        self.downlink_compressor = make_compressor(downlink_compressor,
                                                   pq=pq)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def he(shape, fan):
            return nn.Parameter((torch.randn(shape, generator=gen)
                                 * math.sqrt(2.0 / fan)).to(device))

        def zeros(n):
            return nn.Parameter(torch.zeros(n, device=device))

        self.client = nn.ParameterDict({
            "conv1_w": he((32, 1, 3, 3), 9), "conv1_b": zeros(32),
            "conv2_w": he((64, 32, 3, 3), 9 * 32), "conv2_b": zeros(64),
        })
        self.server = nn.ParameterDict({
            "dense1_w": he((self.cut_dim, 128), self.cut_dim),
            "dense1_b": zeros(128),
            "dense2_w": he((128, num_classes), 128),
            "dense2_b": zeros(num_classes),
        })

    def client_forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 28, 28, 1) NHWC images -> (B, 9216) cut, NHWC-flattened."""
        cp = self.client
        x = images.permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(x, cp["conv1_w"], cp["conv1_b"]))
        x = F.relu(F.conv2d(x, cp["conv2_w"], cp["conv2_b"]))
        x = F.max_pool2d(x, 2)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def server_logits(self, acts: torch.Tensor) -> torch.Tensor:
        sp = self.server
        h = F.relu(acts @ sp["dense1_w"] + sp["dense1_b"])
        return h @ sp["dense2_w"] + sp["dense2_b"]

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                quantize: bool = True, lam_override=None,
                key: Optional[torch.Generator] = None,
                cut_state: Optional[CutState] = None):
        acts = self.client_forward(batch["image"])
        acts, stats = _maybe_quantize(acts, self.pq, self.lam, quantize,
                                      self.client_batch, lam_override,
                                      self.downlink_compressor, key=key,
                                      cut_state=cut_state)
        logits = self.server_logits(acts)
        ce = F.cross_entropy(logits, batch["label"])
        return ce, dict(stats, ce=ce.detach())

    @torch.no_grad()
    def accuracy(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Top-1 accuracy of the uncompressed forward pass."""
        logits = self.server_logits(self.client_forward(batch["image"]))
        return (logits.argmax(-1) == batch["label"]).float().mean()


def from_jax_params(params: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> Dict[str, torch.Tensor]:
    """Reference params ({"client": {...}, "server": {...}} of arrays) ->
    this module's state dict: conv weights HWIO -> OIHW, the rest as is."""
    out = {}
    for part, leaves in params.items():
        for name, value in leaves.items():
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if name.startswith("conv") and name.endswith("_w"):
                t = t.permute(3, 2, 0, 1).contiguous()
            out[f"{part}.{name}"] = t
    return out

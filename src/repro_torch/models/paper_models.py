"""The paper's FEMNIST CNN (twin of ``repro/models/paper_models.py``).

Client: Conv(32, 3x3) + ReLU + Conv(64, 3x3) + ReLU + MaxPool(2) + Flatten,
so the cut activation has d = 12·12·64 = 9216 (the paper's d). Server:
Dense(128) + ReLU + Dense(62). The grouped PQ with the eq.-5 corrected
backward runs at the cut, with per-client codebooks when ``client_batch``
splits the batch.

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

from repro_torch.core.correction import quantize_with_correction_stats
from repro_torch.core.quantizer import PQConfig


def _maybe_quantize(x: torch.Tensor, pq: Optional[PQConfig], lam,
                    quantize: bool, client_batch: int = 0,
                    lam_override=None):
    """Apply the cut-layer PQ per client: the batch is split into cohorts of
    ``client_batch`` examples, each clustered with its own codebooks, when
    ``client_batch`` divides the batch into more than one cohort; otherwise
    the whole batch is one client (as the reference decides)."""
    if lam_override is not None:
        lam = lam_override
    if not quantize or pq is None:
        return x, {}
    b = x.shape[0]
    per_client = bool(client_batch and b % client_batch == 0
                      and b > client_batch)
    clients = b // client_batch if per_client else 1
    zt, dist = quantize_with_correction_stats(
        x.reshape(clients, b // clients, x.shape[-1]), lam, pq)
    return zt.reshape(x.shape), {
        "pq_distortion": dist.mean(),
        "pq_compression_ratio": float(pq.compression_ratio(b, x.shape[-1])),
    }


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
        super().__init__()
        if downlink_compressor is not None:
            raise NotImplementedError(
                "downlink compression is not ported yet (ROADMAP A4)")
        self.num_classes = num_classes
        self.pq = pq
        self.lam = lam
        self.client_batch = client_batch
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
                quantize: bool = True, lam_override=None, key=None,
                cut_state=None):
        if key is not None or cut_state is not None:
            raise NotImplementedError(
                "per-step keys and cut state are not ported yet (ROADMAP A4)")
        acts = self.client_forward(batch["image"])
        acts, stats = _maybe_quantize(acts, self.pq, self.lam, quantize,
                                      self.client_batch, lam_override)
        logits = self.server_logits(acts)
        ce = F.cross_entropy(logits, batch["label"])
        return ce, dict(stats, ce=ce.detach())


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

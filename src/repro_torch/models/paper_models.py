"""The paper's three task models (twin of ``repro/models/paper_models.py``),
split as in §5:

  * FEMNIST CNN -- client: Conv(32, 3x3) + ReLU + Conv(64, 3x3) + ReLU +
                   MaxPool(2) + Flatten (the cut has d = 12·12·64 = 9216,
                   the paper's d); server: Dense(128) + ReLU + Dense(62).
  * SO Tag MLP  -- client: Dense(bow 5000 -> 2000) + ReLU (d = 2000);
                   server: Dense(2000 -> 1000 tags), multi-label BCE.
  * SO NWP LSTM -- client: Embedding(vocab, 96) + LSTM(670) + Dense(96)
                   (d = 96 at every one of the 30 positions); server:
                   Dense(96 -> vocab), cross-entropy over labels >= 0.

The grouped PQ with the eq.-5 corrected backward runs at the cut, with
per-client codebooks when ``client_batch`` splits the batch; a
``downlink_compressor`` squeezes the server->client gradient in the
backward pass, and a ``CutState`` carries the codebooks (warm start) and
error-feedback memory from one step to the next.

Each model takes its cut input from the batch under ``input_key``, the
reference's key (``image``, ``bow``, ``tokens``); ``forward(batch)``
returns (loss, metrics), the reference's ``loss``.

Layouts: the public batch keeps the reference's NHWC images; the
convolutions run in PyTorch's NCHW, and the cut is flattened in NHWC order,
as the reference flattens it. Without that permute the 8-value subvectors
of the cut would be different vectors and PQ parity would break. Parameter
names mirror the reference's keys (``client.conv1_w``, ...); convolution
weights are OIHW here (HWIO there); dense, embedding and LSTM weights keep
the reference's (in, out) layout and are applied as ``acts @ W``.
``from_jax_params`` converts reference params.
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
    ``stats["cut_state"]``, with its EF memory in the cut's layout, (B, d)
    or (B, S, d)."""
    if lam_override is not None:
        lam = lam_override
    has_dl = quantize and downlink is not None and downlink.name != "none"
    if not quantize or (pq is None and not has_dl):
        return x, {}
    b, d = x.shape[0], x.shape[-1]
    per_client = bool(client_batch and b % client_batch == 0
                      and b > client_batch)
    clients = b // client_batch if per_client else 1
    # each client's examples, every position of each, are its rows: a
    # (B, S, d) cut gives each client client_batch·S vectors
    zt = x.reshape(clients, -1, d)
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
                x.numel() // d, d)),
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
    input_key = "image"

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
        acts = self.client_forward(batch[self.input_key])
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


def _normal(gen: torch.Generator, shape, scale: float, device):
    return nn.Parameter((torch.randn(shape, generator=gen) * scale)
                        .to(device))


def _zeros(n: int, device):
    return nn.Parameter(torch.zeros(n, device=device))


class SOTagMLP(nn.Module):
    """Bag of words (B, 5000) -> 1000 tags, multi-label; cut after the
    client's dense layer and ReLU (d = 2000)."""

    input_key = "bow"

    def __init__(self, bow_dim: int = 5000, cut_dim: int = 2000,
                 num_tags: int = 1000, pq: Optional[PQConfig] = None,
                 lam: float = 0.0, client_batch: int = 0,
                 downlink_compressor=None, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bow_dim, self.cut_dim, self.num_tags = bow_dim, cut_dim, num_tags
        self.pq = pq
        self.lam = lam
        self.client_batch = client_batch
        self.downlink_compressor = make_compressor(downlink_compressor,
                                                   pq=pq)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        self.client = nn.ParameterDict({
            "dense1_w": _normal(gen, (bow_dim, cut_dim),
                                math.sqrt(1.0 / bow_dim), device),
            "dense1_b": _zeros(cut_dim, device),
        })
        self.server = nn.ParameterDict({
            "dense2_w": _normal(gen, (cut_dim, num_tags),
                                math.sqrt(1.0 / cut_dim), device),
            "dense2_b": _zeros(num_tags, device),
        })

    def client_forward(self, bow: torch.Tensor) -> torch.Tensor:
        cp = self.client
        return F.relu(bow @ cp["dense1_w"] + cp["dense1_b"])

    def server_logits(self, acts: torch.Tensor) -> torch.Tensor:
        return acts @ self.server["dense2_w"] + self.server["dense2_b"]

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                quantize: bool = True, lam_override=None,
                key: Optional[torch.Generator] = None,
                cut_state: Optional[CutState] = None):
        acts = self.client_forward(batch[self.input_key])
        acts, stats = _maybe_quantize(acts, self.pq, self.lam, quantize,
                                      self.client_batch, lam_override,
                                      self.downlink_compressor, key=key,
                                      cut_state=cut_state)
        z = self.server_logits(acts)
        y = batch["tags"].float()                 # (B, num_tags) multi-hot
        # the reference's stable form of the BCE with logits
        bce = (z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
               ).mean()
        return bce, dict(stats, bce=bce.detach())

    @torch.no_grad()
    def recall_at_5(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Mean over examples of (true tags among the top 5 logits) /
        min(#true tags, 5), of the uncompressed forward pass."""
        logits = self.server_logits(self.client_forward(
            batch[self.input_key]))
        top5 = logits.topk(5, dim=-1).indices
        tags = batch["tags"]
        hits = torch.gather(tags, -1, top5).sum(-1)
        denom = tags.sum(-1).clamp_max(5)
        return (hits / denom.clamp_min(1)).mean()


class SONwpLSTM(nn.Module):
    """Next-word prediction over (B, S) tokens; the client embeds, runs the
    LSTM over the S positions and projects each hidden state to the cut
    (B, S, d = 96)."""

    input_key = "tokens"

    def __init__(self, vocab: int = 10_000, embed_dim: int = 96,
                 hidden: int = 670, cut_dim: int = 96,
                 pq: Optional[PQConfig] = None, lam: float = 0.0,
                 client_batch: int = 0, downlink_compressor=None, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vocab, self.embed_dim = vocab, embed_dim
        self.hidden, self.cut_dim = hidden, cut_dim
        self.pq = pq
        self.lam = lam
        self.client_batch = client_batch
        self.downlink_compressor = make_compressor(downlink_compressor,
                                                   pq=pq)
        gen = generator if generator is not None else \
            torch.Generator().manual_seed(0)

        def g(i, o):
            return _normal(gen, (i, o), math.sqrt(1.0 / i), device)

        self.client = nn.ParameterDict({
            "emb_w": _normal(gen, (vocab, embed_dim), 0.02, device),
            "lstm_wx": g(embed_dim, 4 * hidden),
            "lstm_wh": g(hidden, 4 * hidden),
            "lstm_b": _zeros(4 * hidden, device),
            "dense1_w": g(hidden, cut_dim),
            "dense1_b": _zeros(cut_dim, device),
        })
        self.server = nn.ParameterDict({
            "dense2_w": g(cut_dim, vocab),
            "dense2_b": _zeros(vocab, device),
        })

    def client_forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, cut_dim). The reference's cell: gates
        i, f, g, o from one (E+H) -> 4H product (x·Wx + h·Wh + b), the
        forget gate biased by +1, one step per position."""
        cp = self.client
        x = cp["emb_w"][tokens]                   # (B, S, E)
        b, s, _ = x.shape
        h = x.new_zeros((b, self.hidden))
        c = x.new_zeros((b, self.hidden))
        hs = []
        for t in range(s):
            z = x[:, t] @ cp["lstm_wx"] + h @ cp["lstm_wh"] + cp["lstm_b"]
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs, 1) @ cp["dense1_w"] + cp["dense1_b"]

    def server_logits(self, acts: torch.Tensor) -> torch.Tensor:
        return acts @ self.server["dense2_w"] + self.server["dense2_b"]

    def forward(self, batch: Mapping[str, torch.Tensor], *,
                quantize: bool = True, lam_override=None,
                key: Optional[torch.Generator] = None,
                cut_state: Optional[CutState] = None):
        acts = self.client_forward(batch[self.input_key])
        acts, stats = _maybe_quantize(acts, self.pq, self.lam, quantize,
                                      self.client_batch, lam_override,
                                      self.downlink_compressor, key=key,
                                      cut_state=cut_state)
        logits = self.server_logits(acts)
        labels = batch["labels"]                  # (B, S), -1 = ignore
        mask = labels >= 0
        lp = F.log_softmax(logits, -1)
        picked = torch.gather(lp, -1, labels.clamp_min(0).unsqueeze(-1))
        ce = -(picked[..., 0] * mask).sum() / mask.sum().clamp_min(1)
        return ce, dict(stats, ce=ce.detach())

    @torch.no_grad()
    def accuracy(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Next-word accuracy over labels >= 0, uncompressed forward."""
        logits = self.server_logits(self.client_forward(
            batch[self.input_key]))
        labels = batch["labels"]
        mask = labels >= 0
        ok = (logits.argmax(-1) == labels) & mask
        return ok.sum() / mask.sum().clamp_min(1)


def from_jax_params(params: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> Dict[str, torch.Tensor]:
    """Reference params ({"client": {...}, "server": {...}} of arrays) of
    any of the three models -> the module's state dict: conv weights HWIO
    -> OIHW, the rest (dense, embedding, LSTM) as is, (in, out)."""
    out = {}
    for part, leaves in params.items():
        for name, value in leaves.items():
            t = torch.from_numpy(np.array(value, dtype=np.float32))
            if name.startswith("conv") and name.endswith("_w"):
                t = t.permute(3, 2, 0, 1).contiguous()
            out[f"{part}.{name}"] = t
    return out

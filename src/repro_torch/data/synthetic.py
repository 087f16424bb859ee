"""Synthetic FEMNIST-like federated image data (twin of the image part of
``repro/data/synthetic.py``), in numpy.

Class prototypes, per-client Dirichlet(α) class mixtures and client
weights come from ``np.random.default_rng(seed)`` in the reference's order,
so they are bitwise the reference's. The reference draws each batch with
``jax.random``, which numpy cannot reproduce: here batches are drawn from a
``np.random.Generator`` the caller passes, from the same distributions, and
parity tests hand the reference's batches to both packages instead.
The language-model and tag generators are not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view


@dataclasses.dataclass
class FederatedDataset:
    """num_clients client shards;
    sample_batch(client_id, rng, batch) -> {"image", "label"} tensors;
    eval_batch(rng, batch) -> the same, over all classes uniformly."""
    num_clients: int
    client_weights: np.ndarray                    # p_i ∝ n_i
    sample_batch: Callable[[int, np.random.Generator, int],
                           Dict[str, torch.Tensor]]
    eval_batch: Callable[[np.random.Generator, int], Dict[str, torch.Tensor]]


def _dirichlet_partition(rng: np.random.Generator, num_clients: int,
                         num_classes: int, alpha: float) -> np.ndarray:
    """(num_clients, num_classes) class mixture per client."""
    return rng.dirichlet(alpha * np.ones(num_classes), size=num_clients)


def make_federated_image_data(num_clients: int = 64, num_classes: int = 62,
                              alpha: float = 0.5, noise: float = 0.35,
                              seed: int = 0, *,
                              device="cuda") -> FederatedDataset:
    """Images are NHWC (B, 28, 28, 1) f32, labels int64, on ``device``."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(num_classes, 28, 28, 1)).astype(np.float32)
    # smooth prototypes a little so conv nets have local structure to use
    k = np.ones((3, 3)) / 9.0
    for c in range(num_classes):
        padded = np.pad(protos[c, :, :, 0], 1, mode="edge")
        protos[c, :, :, 0] = (sliding_window_view(padded, (3, 3))
                              * k).sum((-1, -2))
    mixtures = _dirichlet_partition(rng, num_clients, num_classes, alpha)
    weights = rng.integers(50, 500, size=num_clients).astype(np.float64)
    weights /= weights.sum()

    def _batch(labels: np.ndarray, r: np.random.Generator):
        imgs = protos[labels] + noise * r.standard_normal(
            (labels.shape[0], 28, 28, 1), dtype=np.float32)
        return {"image": torch.from_numpy(imgs).to(device),
                "label": torch.from_numpy(labels.astype(np.int64)).to(device)}

    def sample(client_id: int, r: np.random.Generator, batch: int):
        p = mixtures[client_id] + 1e-9
        return _batch(r.choice(num_classes, size=batch, p=p / p.sum()), r)

    def eval_batch(r: np.random.Generator, batch: int):
        return _batch(r.integers(0, num_classes, size=batch), r)

    return FederatedDataset(num_clients, weights, sample, eval_batch)

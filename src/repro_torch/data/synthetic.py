"""Synthetic federated datasets (twin of ``repro/data/synthetic.py``): the
offline stand-ins for FEMNIST and StackOverflow (the SO NWP token streams
and the SO Tag bags of words).

The tables of every generator (class prototypes, topic unigram logits and
bigram shifts, topic words and tags, per-client Dirichlet(α) mixtures,
client weights) come from ``np.random.default_rng(seed)`` in the
reference's order, so they are bitwise the reference's. Batches:

  * images: drawn with numpy from the ``np.random.Generator`` the caller
    passes, from the reference's distributions. The reference draws them
    with ``jax.random``, which numpy cannot reproduce, so parity tests hand
    the reference's batches to both packages.
  * language model: numpy in the reference too (``_gen``), so a batch drawn
    from ``np.random.default_rng(s)`` is bitwise the reference's batch for
    a key whose ``_seed_of`` is s.
  * tags: drawn on the dataset's device by a ``torch.Generator`` seeded
    from the ``np.random.Generator`` the caller passes (a cohort's 1000 x
    5000 bags of words are 20 MB: drawn on the host they would be five
    million numpy normals and a pageable copy a round). The reference draws
    them with ``jax.random``; parity tests inject its batches.
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
    sample_batch(client_id, rng, batch, **kw) -> a dict of tensors (the
    keys are the task's: ``image``/``label``, ``tokens``/``labels``,
    ``bow``/``tags``); eval_batch(rng, batch, **kw) -> the same, from the
    uniform mixture. ``rng`` is an ``np.random.Generator``."""
    num_clients: int
    client_weights: np.ndarray                    # p_i ∝ n_i
    sample_batch: Callable[..., Dict[str, torch.Tensor]]
    eval_batch: Callable[..., Dict[str, torch.Tensor]]


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


# ---------------------------------------------------------------------------
# language modeling (SO NWP-like token streams)
# ---------------------------------------------------------------------------

def make_federated_lm_data(num_clients: int = 64, vocab: int = 10_000,
                           num_topics: int = 16, alpha: float = 0.3,
                           seed: int = 0, *,
                           device="cuda") -> FederatedDataset:
    """Per-topic unigram tables + per-client topic mixtures; a first-order
    Markov structure (a topic-dependent bigram shift) gives next-word
    signal. Batches are {"tokens", "labels"}, (B, S) int64 on ``device``;
    labels are the tokens shifted by one, with -1 (ignore) in the last
    position. ``sample(client_id, rng, batch, seq=30)`` draws from
    ``rng`` exactly as the reference's ``_gen`` draws from its
    ``default_rng(_seed_of(key))``."""
    rng = np.random.default_rng(seed)
    topic_logits = rng.normal(scale=2.0, size=(num_topics, vocab)) \
        .astype(np.float32)
    shifts = rng.integers(1, vocab - 1, size=num_topics)
    mixtures = _dirichlet_partition(rng, num_clients, num_topics, alpha)
    weights = rng.integers(50, 500, size=num_clients).astype(np.float64)
    weights /= weights.sum()

    def _gen(r: np.random.Generator, batch: int, seq: int,
             mixture: np.ndarray):
        topics = r.choice(num_topics, p=mixture / mixture.sum(), size=batch)
        logits = topic_logits[topics]                       # (B, V)

        def categorical():
            g = r.gumbel(size=(batch, vocab)).astype(np.float32)
            return np.argmax(logits + g, axis=-1)

        toks = np.empty((batch, seq), np.int64)
        toks[:, 0] = categorical()
        for t in range(1, seq):
            # token_t = (token_{t-1} + shift_topic) % V w.p. .5 else unigram
            markov = (toks[:, t - 1] + shifts[topics]) % vocab
            uni = categorical()
            use_markov = r.random(batch) < 0.5
            toks[:, t] = np.where(use_markov, markov, uni)
        labels = np.concatenate(
            [toks[:, 1:], np.full((batch, 1), -1, np.int64)], axis=1)
        return {"tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labels).to(device)}

    def sample(client_id: int, r: np.random.Generator, batch: int,
               seq: int = 30):
        return _gen(r, batch, seq, mixtures[client_id])

    def eval_batch(r: np.random.Generator, batch: int, seq: int = 30):
        return _gen(r, batch, seq, np.ones(num_topics) / num_topics)

    return FederatedDataset(num_clients, weights, sample, eval_batch)


def make_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                  vocab: int, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Plain random-token batch (B, S) int64 for smoke runs, labels shifted
    by one with -1 last; drawn from ``rng`` (the reference draws from
    ``jax.random``)."""
    toks = rng.integers(0, vocab, size=(batch, seq))
    labels = np.concatenate(
        [toks[:, 1:], np.full((batch, 1), -1, np.int64)], axis=1)
    return {"tokens": torch.from_numpy(toks).to(device),
            "labels": torch.from_numpy(labels).to(device)}


# ---------------------------------------------------------------------------
# tag prediction (SO Tag-like, multi-label bag of words)
# ---------------------------------------------------------------------------

def make_federated_tag_data(num_clients: int = 64, bow_dim: int = 5000,
                            num_tags: int = 1000, num_topics: int = 32,
                            alpha: float = 0.3, seed: int = 0, *,
                            device="cuda") -> FederatedDataset:
    """Each example has a topic from its client's mixture; its bag of words
    is relu(topic words + 0.5·N(0, 1)) (B, bow_dim) f32 and its tags are
    the topic's 12 tags, each dropped with probability 0.25, multi-hot
    (B, num_tags) f32. Batches are drawn on ``device`` (module
    docstring)."""
    rng = np.random.default_rng(seed)
    topic_words = rng.normal(scale=1.0, size=(num_topics, bow_dim)) \
        .astype(np.float32)
    topic_tags = np.zeros((num_topics, num_tags), np.float32)
    for t in range(num_topics):
        topic_tags[t, rng.choice(num_tags, size=12, replace=False)] = 1.0
    mixtures = _dirichlet_partition(rng, num_clients, num_topics, alpha)
    weights = rng.integers(50, 500, size=num_clients).astype(np.float64)
    weights /= weights.sum()
    tw = torch.from_numpy(topic_words).to(device)
    tt = torch.from_numpy(topic_tags).to(device)
    mix = torch.from_numpy(mixtures).to(device)

    def _gen(r: np.random.Generator, batch: int, mixture: torch.Tensor):
        g = torch.Generator(device=tw.device).manual_seed(
            int(r.integers(0, 2 ** 63 - 1)))
        topics = torch.multinomial(mixture + 1e-9, batch, replacement=True,
                                   generator=g)
        bow = torch.relu(tw[topics] + 0.5 * torch.randn(
            (batch, bow_dim), generator=g, device=tw.device))
        drop = torch.rand((batch, num_tags), generator=g,
                          device=tw.device) < 0.25
        return {"bow": bow, "tags": torch.where(drop, 0.0, tt[topics])}

    def sample(client_id: int, r: np.random.Generator, batch: int):
        return _gen(r, batch, mix[client_id])

    def eval_batch(r: np.random.Generator, batch: int):
        return _gen(r, batch, torch.full((num_topics,), 1.0 / num_topics,
                                         dtype=torch.float64,
                                         device=tw.device))

    return FederatedDataset(num_clients, weights, sample, eval_batch)

"""FedLite / SplitFed training step (twin of ``repro/core/fedlite.py``).

One step is a full FedLite iteration (paper Fig. 1): client forward ->
grouped PQ with the gradient-corrected backward -> server forward and
backward -> client backward -> one optimizer update of client and server.
``quantize=False`` is SplitFed, which is exactly mini-batch SGD.

The reference's step is a pure jitted function of a ``TrainState`` pytree;
here the state holds a dict of parameter tensors, the model is driven from
it with ``torch.func.functional_call``, and the step returns a new state
(out of place, as the reference's ``donate=False`` step does). PyTorch runs
eagerly; there is nothing to compile.

``step_key`` (an int seed) makes the model's downlink codec round
stochastically: step s draws from a ``torch.Generator`` on the batch's
device seeded from (seed, s), in place of the reference's
``fold_in(key, s)``. The step's optional third argument, a ``CutState``,
threads the codebook warm start and error-feedback memory from step to
step.

``make_weighted_step`` is the per-contribution staleness-weighted update
(FedBuff) that the trainer's ``AsyncBuffer`` flushes run; ``comm_report``
is the paper's per-client wire-bit accounting. The eval step waits for the
LM's training loss (ROADMAP A15).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import kmeans as _km
from repro_torch.core.quantizer import PQConfig
from repro_torch.core.split import dtype_bits, split_part, tree_bits
from repro_torch.optim import Optimizer

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tensors
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params: Tensors, optimizer: Optimizer) -> "TrainState":
        """Starts from copies of ``params`` (e.g. a module's
        ``named_parameters()``), which the steps never write to."""
        own = {k: v.detach().clone().requires_grad_() for k, v in
               dict(params).items()}
        return cls(params=own, opt_state=optimizer.init(own), step=0)


def step_generator(seed: int, step: int, device: torch.device,
                   client: Optional[int] = None) -> torch.Generator:
    """The generator of step ``step`` under base seed ``seed``, on
    ``device``: seeded from the pair through numpy's ``SeedSequence``, so
    that neighbouring seeds and steps give unrelated streams. ``client``
    (the weighted step's client index) splits the step's stream per
    client, as the reference's ``random.split`` of the step key does."""
    entropy = [seed, step] if client is None else [seed, step, client]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms while open: two
    runs of one step on the same inputs give the same bits, which a
    resumed run needs (without it, FemnistCNN's convolution backward
    differed in the last bits from run to run on an H100). The caller's
    setting is restored on exit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _grads(model: nn.Module, params: Tensors, batch,
           kw: Dict[str, Any]) -> Tuple[torch.Tensor, Dict, Tensors]:
    """One forward pass of ``model`` driven from ``params`` with the
    keywords ``kw``: (detached loss, the model's metrics, d loss / d
    params), each operation deterministic on the card."""
    with _deterministic_cudnn():
        loss, metrics = torch.func.functional_call(model, params, (batch,),
                                                   kw)
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), metrics, dict(zip(params, grads))


def _apply(optimizer: Optimizer, state: TrainState,
           grads: Tensors) -> TrainState:
    """The state after one optimizer update by ``grads``."""
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.params)
    with torch.no_grad():
        params = {k: (p + updates[k]).requires_grad_()
                  for k, p in state.params.items()}
    return TrainState(params, opt_state, state.step + 1)


def make_train_step(model: nn.Module, optimizer: Optimizer, *,
                    quantize: bool = True, microbatches: int = 1,
                    lam_schedule: Optional[Callable] = None,
                    step_key: Optional[int] = None) -> Callable:
    """Build the FedLite (quantize=True) / SplitFed (False) step.

    ``microbatches > 1`` splits the batch along its leading axis into m
    sequential microbatches and averages their gradients (in f32) before
    the one optimizer update. ``lam_schedule(step) -> λ`` overrides the
    model's correction strength per step.

    ``step_key`` (an int) hands the model a per-step ``torch.Generator``
    (``step_generator``) for its cut-layer codecs: today that makes a
    scalarq downlink round stochastically. ``None`` keeps the deterministic
    path.

    The step is ``step(state, batch, cut_state=None) -> (next state,
    metrics)``; metrics holds the model's (detached) metrics of the last
    microbatch and ``loss``. A ``cut_state`` (``core/compressors.CutState``)
    is threaded through the model, and the next one comes back under
    ``metrics["cut_state"]``; it cannot be combined with ``microbatches >
    1``.
    """

    def grads_of(params: Tensors, batch, step: int, cut_state=None):
        lam = None if lam_schedule is None else lam_schedule(step)
        kw = {"quantize": quantize, "lam_override": lam}
        if step_key is not None:
            device = next(iter(batch.values())).device
            kw["key"] = step_generator(step_key, step, device)
        if cut_state is not None:
            kw["cut_state"] = cut_state
        return _grads(model, params, batch, kw)

    def train_step(state: TrainState, batch,
                   cut_state=None) -> Tuple[TrainState, Dict]:
        if microbatches == 1:
            loss, metrics, grads = grads_of(state.params, batch, state.step,
                                            cut_state)
        elif cut_state is not None:
            raise ValueError(
                "cut_state is not supported with microbatches > 1")
        else:
            g_sum = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state.params.items()}
            loss = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                mloss, metrics, g = grads_of(state.params, mb, state.step)
                for k in g_sum:
                    g_sum[k] += g[k].float()
                loss = loss + mloss
            grads = {k: (g_sum[k] / microbatches).to(p.dtype)
                     for k, p in state.params.items()}
            loss = loss / microbatches
        return _apply(optimizer, state, grads), dict(metrics, loss=loss)

    return train_step


def _client_cut(cut_state, c: int):
    """Client ``c``'s slice of a client-major ``CutState``, in the layout
    the model takes for one client: codebooks (1, R, L, d/q), EF (B, d)."""
    q, ef = cut_state.quantizer, cut_state.ef_memory
    if q is not None:
        q = type(q)(*(x[c:c + 1] for x in q))
    return type(cut_state)(quantizer=q,
                           ef_memory=None if ef is None else ef[c])


def _stack_cuts(cuts):
    """Per-client new ``CutState``s back into the client-major layout."""
    first = cuts[0]
    q = None if first.quantizer is None else type(first.quantizer)(
        *(torch.cat(xs) for xs in zip(*(c.quantizer for c in cuts))))
    ef = None if first.ef_memory is None else \
        torch.stack([c.ef_memory for c in cuts])
    return type(first)(quantizer=q, ef_memory=ef)


def make_weighted_step(model: nn.Module, optimizer: Optimizer, *,
                       quantize: bool = True,
                       step_key: Optional[int] = None) -> Callable:
    """Per-contribution staleness-weighted server update (FedBuff, exact).

    ``step(state, batches, weights, cut_state=None)`` takes one batch dict
    per client (a list, in participant order) and a (C,) weight vector;
    each client's gradient is computed on its own and discounted by ITS OWN
    staleness weight before aggregation:

        ĝ = (1/C) Σ_c w_c · g_c          (Nguyen et al. 2022, eq. 4)

    One optimizer update per flush. The reference vmaps the per-client
    gradients; the port's kernels are ctypes ``autograd.Function``s that
    ``torch.func.vmap`` cannot batch through, so the clients run one after
    the other, and ĝ is accumulated in f32 in client order. It is
    therefore allclose to the reference's ``tensordot``, not bitwise.

    ``step_key`` hands client c the generator ``step_generator(step_key,
    step, device, c)``. ``cut_state`` is client-major (codebooks
    (C, R, L, d/q), rounds (C,), EF memory (C, B, d)); the next one comes
    back under ``metrics["cut_state"]`` in the same layout. Metrics are the
    clients' means, plus ``loss`` and ``mean_staleness_weight``.
    """

    def weighted_step(state: TrainState, batches, weights,
                      cut_state=None) -> Tuple[TrainState, Dict]:
        parts = list(batches)
        device = next(iter(parts[0].values())).device
        w = torch.as_tensor(weights, dtype=torch.float32, device=device)
        wc = w / len(parts)
        ghat = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in state.params.items()}
        losses, metrics, cuts = [], [], []
        for c, batch in enumerate(parts):
            kw = {"quantize": quantize}
            if step_key is not None:
                kw["key"] = step_generator(step_key, state.step, device, c)
            if cut_state is not None:
                kw["cut_state"] = _client_cut(cut_state, c)
            loss, m, grads = _grads(model, state.params, batch, kw)
            for k, g in grads.items():
                ghat[k] += wc[c] * g.float()
            m = dict(m)
            if "cut_state" in m:
                cuts.append(m.pop("cut_state"))
            losses.append(loss)
            metrics.append(m)
        grads = {k: ghat[k].to(p.dtype) for k, p in state.params.items()}
        out = {k: torch.stack([m[k] for m in metrics]).mean(0)
               if torch.is_tensor(metrics[0][k])
               else sum(m[k] for m in metrics) / len(metrics)
               for k in metrics[0]}
        out.update(loss=torch.stack(losses).mean(),
                   mean_staleness_weight=w.mean())
        if cuts:
            out["cut_state"] = _stack_cuts(cuts)
        return _apply(optimizer, state, grads), out

    return weighted_step


# ---------------------------------------------------------------------------
# communication accounting (paper Table 1 + §5 worked example)
# ---------------------------------------------------------------------------

def comm_report(model, params, tokens_per_client: int,
                pq: Optional[PQConfig] = None,
                phi_bits: Optional[int] = None) -> Dict[str, Any]:
    """Per-client, per-iteration wire bits for FedAvg / SplitFed / FedLite
    (twin of the reference's ``comm_report``, for a model with a ``cfg``
    such as ``TransformerLM``).

    ``params`` is ``{"client": ..., "server": ...}`` (nested dicts of
    tensors) or a flat dict with ``client.`` / ``server.`` prefixed keys.
    ``tokens_per_client`` is B × activation vectors per example.
    ``phi_bits=None`` counts parameters at their dtypes and activations
    (and the PQ codebooks) at the model's compute dtype; φ = 64 gives the
    paper's §5 numbers. ``pq_backend`` is the backend ``pq.backend``
    resolves to for the params' device (``"cuda"`` / ``"torch"``).
    """
    d = model.cfg.d_model
    pq = pq if pq is not None else model.pq
    act_phi = phi_bits if phi_bits is not None else \
        dtype_bits(getattr(model.cfg, "dtype", "float32"))
    client = split_part(params, "client")
    client_bits = tree_bits(client, phi_bits)
    total_bits = client_bits + tree_bits(split_part(params, "server"),
                                         phi_bits)
    act_bits = act_phi * d * tokens_per_client
    device = client[0].device if client else torch.device("cpu")

    report = {
        "activation_dim": d,
        "tokens_per_client": tokens_per_client,
        "phi_bits": float(act_phi),
        "pq_backend": None if pq is None
        else _km.resolve_backend(pq.backend, device),
        "fedavg_uplink_bits": float(total_bits),
        "splitfed_uplink_bits": float(client_bits + act_bits),
        "splitfed_activation_bits": float(act_bits),
        "downlink_dense_bits": float(act_bits),
    }
    if pq is not None:
        msg = pq.message_bits(tokens_per_client, d, phi_bits=act_phi)
        report.update({
            "fedlite_uplink_bits": float(client_bits + msg),
            "fedlite_activation_bits": float(msg),
            "activation_compression_ratio": act_bits / max(msg, 1),
            "uplink_reduction_vs_splitfed":
                (client_bits + act_bits) / max(client_bits + msg, 1),
            "uplink_reduction_vs_fedavg":
                total_bits / max(client_bits + msg, 1),
        })
    dl = getattr(model, "downlink_compressor", None)
    if dl is not None and dl.name != "none":
        dl_bits = dl.analytic_bits(tokens_per_client, d, phi_bits=act_phi)
        report.update({
            "downlink_compressor": getattr(dl, "spec", dl.name),
            "downlink_bits": float(dl_bits),
            "downlink_compression_ratio": act_bits / max(dl_bits, 1),
        })
    return report

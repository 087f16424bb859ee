"""FedLite / SplitFed training step (twin of ``repro/core/fedlite.py``).

One step is a full FedLite iteration (paper Fig. 1): client forward ->
grouped PQ with the gradient-corrected backward -> server forward and
backward -> client backward -> one optimizer update of client and server.
``quantize=False`` is SplitFed, which is exactly mini-batch SGD.

The reference's step is a pure jitted function of a ``TrainState`` pytree;
here the state holds the parameter tensors, and the step returns a new
state (out of place, as the reference's ``donate=False`` step does).
PyTorch runs eagerly; there is nothing to compile. Two kinds of model
take the steps: an ``nn.Module`` whose forward is its loss (the paper's
models), driven from a flat dict of its named parameters with
``torch.func.functional_call``; and a model with a ``loss(params, batch,
...)`` method over nested dicts of tensors (``TransformerLM``), whose
state keeps the reference's nested layout. Optimizers see the nested
params as one flat dict keyed by '/'-joined paths.

``step_key`` (an int seed) makes the model's downlink codec round
stochastically: step s draws from a ``torch.Generator`` on the batch's
device seeded from (seed, s), in place of the reference's
``fold_in(key, s)``. The step's optional third argument, a ``CutState``,
threads the codebook warm start and error-feedback memory from step to
step.

``make_weighted_step`` is the per-contribution staleness-weighted update
(FedBuff) that the trainer's ``AsyncBuffer`` flushes run;
``make_mesh_step`` the cohort-parallel update of the ``"mesh"`` executor,
one process per shard and one all-reduce per update; ``comm_report``
is the paper's per-client wire-bit accounting. ``make_eval_step`` is the
LM's CE and masked accuracy of the uncompressed forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import kmeans as _km
from repro_torch.core.quantizer import PQConfig
from repro_torch.core.split import dtype_bits, split_part, tree_bits
from repro_torch.optim import Optimizer

Tensors = Dict[str, torch.Tensor]


def flat_params(params: Mapping[str, Any], prefix: str = "") -> Tensors:
    """The tensors of a (possibly nested) dict of params, keyed by
    '/'-joined paths in key order; a flat dict maps to itself."""
    out: Tensors = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nest_like(template: Mapping[str, Any], flat: Tensors,
              prefix: str = "") -> Dict[str, Any]:
    """``flat``'s tensors in ``template``'s nesting (empty dicts kept)."""
    return {k: nest_like(v, flat, f"{prefix}{k}/") if isinstance(v, Mapping)
            else flat[prefix + k] for k, v in template.items()}


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]
    opt_state: Any
    step: int

    @classmethod
    def create(cls, params: Mapping[str, Any],
               optimizer: Optimizer) -> "TrainState":
        """Starts from copies of ``params`` (a module's
        ``named_parameters()``, or a ``TransformerLM``'s nested params),
        which the steps never write to."""
        own = nest_like(params, {k: v.detach().clone().requires_grad_()
                                 for k, v in flat_params(params).items()})
        return cls(params=own, opt_state=optimizer.init(flat_params(own)),
                   step=0)


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


def _grads(model, params: Dict[str, Any], batch, kw: Dict[str, Any],
           scale: Optional[float] = None
           ) -> Tuple[torch.Tensor, Dict, Tensors]:
    """One forward pass of ``model`` driven from ``params`` with the
    keywords ``kw``: (detached loss, the model's metrics, d loss / d
    params as a flat dict), each operation deterministic on the card.
    ``scale`` differentiates ``scale · loss`` instead: the cotangent that
    reaches the cut is scaled, the eq.-5 correction added there is not."""
    flat = flat_params(params)
    with _deterministic_cudnn():
        if isinstance(model, nn.Module):
            loss, metrics = torch.func.functional_call(model, params,
                                                       (batch,), kw)
        else:
            loss, metrics = model.loss(params, batch, **kw)
        # a parameter the loss does not reach (the unused ln2 of an SSM
        # block without an FFN) gets zeros, as under jax.grad
        grads = torch.autograd.grad(loss if scale is None else loss * scale,
                                    list(flat.values()), allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), metrics, dict(zip(flat, grads))


def _apply(optimizer: Optimizer, state: TrainState,
           grads: Tensors) -> TrainState:
    """The state after one optimizer update by ``grads`` (flat)."""
    flat = flat_params(state.params)
    updates, opt_state = optimizer.update(grads, state.opt_state, flat)
    with torch.no_grad():
        params = {k: (p + updates[k]).requires_grad_()
                  for k, p in flat.items()}
    return TrainState(nest_like(state.params, params), opt_state,
                      state.step + 1)


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
                     for k, p in flat_params(state.params).items()}
            loss = 0.0
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                mloss, metrics, g = grads_of(state.params, mb, state.step)
                for k in g_sum:
                    g_sum[k] += g[k].float()
                loss = loss + mloss
            grads = {k: (g_sum[k] / microbatches).to(p.dtype)
                     for k, p in flat_params(state.params).items()}
            loss = loss / microbatches
        return _apply(optimizer, state, grads), dict(metrics, loss=loss)

    return train_step


def _client_cut(cut_state, c: int, stop: Optional[int] = None):
    """Clients ``c`` to ``stop`` (default: client ``c`` alone) of a
    client-major ``CutState``, in the layout the model takes for their
    concatenated batch: codebooks (n, R, L, d/q), EF rows (n·B, d)."""
    stop = c + 1 if stop is None else stop
    q, ef = cut_state.quantizer, cut_state.ef_memory
    if q is not None:
        q = type(q)(*(x[c:stop] for x in q))
    if ef is not None:
        ef = ef[c] if stop == c + 1 else ef[c:stop].flatten(0, 1)
    return type(cut_state)(quantizer=q, ef_memory=ef)


def _split_cut(cut, n: int) -> list:
    """The model's ``CutState`` of n clients' concatenated batch as n
    per-client states (``_client_cut``'s layout for one client)."""
    q, ef = cut.quantizer, cut.ef_memory
    if ef is not None:
        ef = ef.reshape(n, -1, *ef.shape[1:])
    return [type(cut)(
        quantizer=None if q is None else type(q)(*(x[i:i + 1] for x in q)),
        ef_memory=None if ef is None else ef[i]) for i in range(n)]


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
                for k, p in flat_params(state.params).items()}
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
        grads = {k: ghat[k].to(p.dtype)
                 for k, p in flat_params(state.params).items()}
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


def _cut_leaves(cut) -> list:
    """A ``CutState``'s tensors, in a fixed order (absent fields skipped)."""
    q = [] if cut.quantizer is None else list(cut.quantizer)
    return q + ([] if cut.ef_memory is None else [cut.ef_memory])


def _cut_like(template, leaves):
    """``leaves`` (in ``_cut_leaves`` order) in ``template``'s layout."""
    it = iter(leaves)
    q = None if template.quantizer is None else type(template.quantizer)(
        *(next(it) for _ in template.quantizer))
    ef = None if template.ef_memory is None else next(it)
    return type(template)(quantizer=q, ef_memory=ef)


def _gather_cuts(cuts, slots: int, mesh, group):
    """Every slot's ``CutState`` on every rank, from each block's owner.

    Each rank packs its block's states as raw bytes and broadcasts them
    once: a gather that keeps every bit (a sum of zero-filled slices would
    turn -0.0 into +0.0) and that gloo supports on CUDA tensors too."""
    import torch.distributed as dist

    from repro_torch.sharding.ctx import clients_rank, local_slots

    template = cuts[0]
    shapes = [(t.shape, t.dtype, t.numel() * t.element_size())
              for t in _cut_leaves(template)]
    mine = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for cut in cuts for t in _cut_leaves(cut)])
    shards = slots // len(cuts)
    rank = clients_rank(mesh)
    out = []
    for r in range(shards):
        buf = mine if r == rank else torch.empty_like(mine)
        dist.broadcast(buf, src=dist.get_global_rank(group, r), group=group)
        off = 0
        for _ in local_slots(slots, mesh, r):
            leaves = []
            for shape, dtype, nb in shapes:
                leaves.append(buf[off:off + nb].clone().view(dtype)
                              .view(shape))
                off += nb
            out.append(_cut_like(template, leaves))
    return _stack_cuts(out)


def make_mesh_step(model: nn.Module, optimizer: Optimizer, mesh, *,
                   quantize: bool = True, step_key: Optional[int] = None,
                   correction_scope: str = "cohort") -> Callable:
    """Cohort-parallel server update over ``mesh``'s ``clients`` axis
    (twin of the reference's ``make_mesh_step``).

    SPMD: every rank of the mesh calls the step with the same arguments
    and holds the same replicated ``state``. Inputs are client-major:
    ``batches`` one batch dict per client slot, ``weights`` and ``mask``
    one float per slot (host values), ``cut_state`` per client (codebooks
    (C, R, L, d/q), EF memory (C, B, d)). Rank r computes the slots of its
    contiguous block (``sharding.ctx.local_slots``). The f32 weighted
    gradient sum, the masked metric sums beside it, crosses ranks once, as
    one ``all_reduce(SUM)`` of one flat buffer on the ``clients`` group;
    every rank then applies the same optimizer update. Within a rank the
    sums run in a fixed order; across ranks in the backend's order
    (reassociation only).

    ``correction_scope``, as in the reference:

      * ``"cohort"`` (the synchronous policies) -- client c's loss is
        scaled by ``w_c / Σm`` inside differentiation, so the cotangent at
        the cut carries the cohort's 1/(C·B) while the eq.-5 correction
        fires at full λ: the fused stacked step's gradient. A shard whose
        real clients share one weight runs them as ``make_train_step``
        does, as one concatenated batch with its mean loss scaled by
        ``n_local·w / Σm``, when the model clusters per client
        (``model.client_batch``) or does not quantize: each client keeps
        its own codebook, and a world of one computes exactly the stacked
        step, kernel launches included (5 ``lloyd_update`` and 1
        ``pq_quantize`` a FEMNIST round). Otherwise (a cohort-global
        codebook, unequal weights) the shard's clients run one by one.
        A fused shard's float metrics (``pq_compression_ratio``) are those
        of its batch, as on the stacked path, and its codecs draw from
        ``step_generator(step_key, step, device)`` at a world of one, the
        stacked step's, else from the stream of ``client`` = its rank.
      * ``"client"`` (``AsyncBuffer``) -- raw per-client gradients, one
        client after the other, discounted by ``w_c / Σm`` after
        differentiation: ``make_weighted_step``'s update, and its
        generator ``step_generator(step_key, step, device, c)`` for slot c.

    ``mask`` (0/1 per slot) marks real clients: a cohort rarely divides
    the shard count, so callers pad to a multiple of it. A slot with
    ``m = 0`` adds nothing to the gradient, the metric means (``Σ x·m /
    max(Σm, 1)``) or ``mean_staleness_weight``; it is not run at all,
    except that a rank whose block holds no real client runs its first
    slot to learn the metrics' and cut state's layout and adds zeros, so
    that every rank joins the all-reduce with a buffer of one shape.

    With a ``cut_state``, the new per-client states come back under
    ``metrics["cut_state"]`` for every slot, on every rank, bitwise as
    their owner computed them (a padded slot holds a copy of its rank's
    last computed state); the trainer's per-client memories stay
    identical across ranks.
    """
    import torch.distributed as dist

    from repro_torch.sharding.ctx import (CLIENTS_AXIS, clients_rank,
                                          local_slots)

    if CLIENTS_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no "
                         f"{CLIENTS_AXIS!r} axis")
    if correction_scope not in ("cohort", "client"):
        raise ValueError(f"correction_scope={correction_scope!r} must be "
                         "'cohort' or 'client'")
    pre_scale = correction_scope == "cohort"
    per_client_codebooks = not quantize \
        or getattr(model, "pq", None) is None \
        or getattr(model, "client_batch", 0) > 0
    group = mesh.get_group(CLIENTS_AXIS)
    shards = mesh.size(mesh.mesh_dim_names.index(CLIENTS_AXIS))
    rank = clients_rank(mesh)
    f32 = np.float32

    def mesh_step(state: TrainState, batches, weights, mask,
                  cut_state=None) -> Tuple[TrainState, Dict]:
        parts = list(batches)
        slots = len(parts)
        device = next(iter(parts[0].values())).device
        w = np.asarray(weights, f32)
        m = np.asarray(mask, f32)
        if w.shape != (slots,) or m.shape != (slots,):
            raise ValueError(f"{slots} slots, weights {w.shape}, mask "
                             f"{m.shape}")
        cnt = max(m.sum(dtype=f32), f32(1.0))
        scale = w / cnt
        block = local_slots(slots, mesh)
        real = [c for c in block if m[c] != 0]
        # work units: (first slot, end slot, loss scale, gradient weight,
        # metric weight, generator's client); a fused unit is the block's
        # run of real slots, its batch mean counting for its n clients in
        # the metrics' Σ x·m
        if not real:
            units = [(block[0], block[0] + 1, None, 0.0, 0.0, block[0])]
        elif pre_scale and per_client_codebooks \
                and real == list(range(real[0], real[0] + len(real))) \
                and len({(w[c], m[c]) for c in real}) == 1:
            n, c = len(real), real[0]
            units = [(c, c + n, float(f32(n) * w[c] / cnt), float(m[c]),
                      float(f32(n) * m[c]), None if shards == 1 else rank)]
        else:
            units = [(c, c + 1, float(scale[c]) if pre_scale else None,
                      float(m[c] if pre_scale else m[c] * scale[c]),
                      float(m[c]), c) for c in real]
        flat = flat_params(state.params)
        ghat = {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in flat.items()}
        sums: Dict[str, torch.Tensor] = {}
        cuts = []
        for first, end, loss_scale, coef, mcoef, client in units:
            batch = parts[first] if end == first + 1 else {
                k: torch.cat([parts[c][k] for c in range(first, end)])
                for k in parts[first]}
            kw = {"quantize": quantize}
            if step_key is not None:
                kw["key"] = step_generator(step_key, state.step, device,
                                           client)
            if cut_state is not None:
                kw["cut_state"] = _client_cut(cut_state, first, end)
            loss, met, grads = _grads(model, state.params, batch, kw,
                                      loss_scale)
            met = dict(met, loss=loss)
            if "cut_state" in met:
                cuts += _split_cut(met.pop("cut_state"), end - first)
            # a float metric joins on the device without a host copy
            for k, v in met.items():
                if k not in sums:
                    sums[k] = torch.zeros((), dtype=torch.float32,
                                          device=device)
                if mcoef:
                    sums[k] = sums[k] + mcoef * (
                        v.float() if torch.is_tensor(v)
                        else torch.full((), float(v), dtype=torch.float32,
                                        device=device))
            if coef:
                for k, g in grads.items():
                    ghat[k] += coef * g.float()
        keys = sorted(sums)
        buf = torch.cat([g.reshape(-1) for g in ghat.values()]
                        + [torch.stack([sums[k] for k in keys])])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        grads, off = {}, 0
        for k, p in flat.items():
            grads[k] = buf[off:off + p.numel()].view(p.shape).to(p.dtype)
            off += p.numel()
        out = {k: buf[off + i] / float(cnt) for i, k in enumerate(keys)}
        out["mean_staleness_weight"] = float((w * m).sum(dtype=f32) / cnt)
        if cuts:
            ran = [c for first, end, *_ in units for c in range(first, end)]
            by_slot = dict(zip(ran, cuts))
            out["cut_state"] = _gather_cuts(
                [by_slot.get(c, cuts[-1]) for c in block], slots, mesh,
                group)
        return _apply(optimizer, state, grads), out

    return mesh_step


def make_eval_step(model) -> Callable:
    """``eval_step(params, batch) -> {"ce", "accuracy"}`` for a
    ``TransformerLM``: the uncompressed forward's mean CE and its top-1
    accuracy over the valid (>= 0) labels, the codebook axis of an audio
    batch's (B, K, S) labels moved behind the sequence. No gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        acts, _, _ = model.client_forward(params["client"], batch,
                                          mode="train")
        x, _, _ = model.server_forward(params["server"], acts, batch,
                                       mode="train")
        lg = model.logits(params, x)
        ce = model.token_ce(lg, batch["labels"])
        pred = lg.argmax(-1)
        labels = batch["labels"]
        if model.cfg.num_codebooks > 1:
            labels = labels.movedim(1, 2)
        mask = labels >= 0
        acc = ((pred == labels) & mask).sum() / mask.sum().clamp_min(1)
        return {"ce": ce, "accuracy": acc}

    return eval_step


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

"""Federated runtime: client sampling, weighted aggregation, round drivers
(twin of ``repro/federated/runtime.py``).

Implements the three algorithms the paper compares (§3, Table 1):

  * FEDAVG      — every sampled client runs H local SGD steps on the FULL
                  model, the server averages the deltas weighted by p_i.
  * SPLITFED    — per iteration, the cohort's activations hit the server,
                  gradients come back; equivalent to mini-batch SGD (§3).
  * FEDLITE     — SplitFed + grouped PQ + gradient correction at the cut.

`FederatedTrainer.run` drives rounds through the virtual-clock
``federated/scheduler.py``, measures both directions' payloads with the
real wire format (``federated/wire.py``) and leaves the per-round `Trace`
in ``trainer.last_trace``.

What differs from the reference:

  * Seeds, not keys. ``run`` takes an int seed; every client batch comes
    from ``client_batch_for(cid, round_id)``, which draws it from
    ``np.random.SeedSequence([seed, round_id, cid])`` (round ids start at
    1; id 0 is the wire measurement's batch). It is the one place batches
    come from, so a test can override it to inject the reference's
    ``jax.random`` batches.
  * The model is an ``nn.Module`` whose weights are drawn when it is built
    (from its own generator); ``init_state`` starts from copies of them.
    A codec the trainer installs goes into a shallow copy of the module
    (``copy.copy``: the parameters are shared, not copied), so the
    caller's module is not mutated, and the trained path and the measured
    bytes use the same codec object.
  * ``device`` (default ``"cuda"``) is where the model, the data's batches
    and the run live; without a card, a trainer not asked for the CPU
    raises. Nothing falls back to the CPU.
  * Host syncs follow the reference's budget: the metrics of the whole
    run come to the host in one transfer (`obs.MetricsBuffer.flush`),
    logging syncs only every ``log_every`` rounds, screening checks
    finiteness per client only under a fault plan, and the wire
    measurement copies each measured payload's arrays to the host once
    per ``run``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compressors import (CutCompressor, CutState,
                                          NoneCompressor, PQCompressor,
                                          make_compressor)
from repro_torch.core.fedlite import TrainState
from repro_torch.core.quantizer import QuantizerState, quantize_stateful
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.federated import wire
from repro_torch.federated.executor import make_executor
from repro_torch.federated.faults import FaultPlan, make_injector
from repro_torch.federated.network import (ClientProfile, uniform_fleet,
                                           validate_fleet)
from repro_torch.federated.scheduler import (Arrival, AsyncBuffer, FullSync,
                                             Policy, Scheduler)
from repro_torch.federated.trace import Trace
from repro_torch.obs import flight as flightlib
from repro_torch.optim import Optimizer

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]


def sample_clients(rng: np.random.Generator, num_clients: int, cohort: int,
                   weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Sample a cohort without replacement, uniformly or p_i-proportionally.

    ``weights`` (e.g. ``FederatedDataset.client_weights``, p_i ∝ n_i) biases
    selection toward data-rich clients — the sampling the FedAvg analysis
    assumes; ``None`` keeps the uniform sampling SplitFed/FedLite use.
    """
    size = min(cohort, num_clients)
    if weights is None:
        return rng.choice(num_clients, size=size, replace=False)
    p = np.asarray(weights, np.float64)
    if p.shape != (num_clients,) or (p < 0).any() or p.sum() <= 0:
        raise ValueError("weights must be a nonnegative (num_clients,) vector")
    return rng.choice(num_clients, size=size, replace=False, p=p / p.sum())


def weighted_average(trees: Sequence[Tensors], weights: Sequence[float]
                     ) -> Tensors:
    """Σ_i w_i·tree_i / Σ w, per tensor name (w normalized in f64)."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return {k: sum(float(wi) * t[k] for wi, t in zip(w, trees))
            for k in trees[0]}


def _batch_rng(*entropy: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(list(entropy)))


# ---------------------------------------------------------------------------
# FedAvg baseline
# ---------------------------------------------------------------------------

def make_fedavg_step(model, lr: float):
    """The single local SGD step on the full, uncompressed model:
    ``step(params, batch) -> (new params, loss)``."""
    def sgd_step(p: Tensors, b) -> Tuple[Tensors, torch.Tensor]:
        p = {k: v.detach().requires_grad_() for k, v in p.items()}
        loss, _ = torch.func.functional_call(model, p, (b,),
                                             {"quantize": False})
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            new_p = {k: v - lr * g for (k, v), g in zip(p.items(), grads)}
        return new_p, loss.detach()
    return sgd_step


def fedavg_round(model, params: Tensors, data: FederatedDataset, client_ids,
                 key: int, *, local_steps: int, batch: int, lr: float,
                 batch_kwargs: Optional[dict] = None, sgd_step=None):
    """One FedAvg round: H local SGD steps per client, weighted delta average.

    Returns (new_params, mean local loss). Client ``cid``'s step ``s``
    draws its batch from ``SeedSequence([key, cid, s])``. The mean loss
    stays a DEVICE scalar — no host sync per round (``run_fedavg`` flushes
    every round's loss through one `obs.MetricsBuffer` transfer).
    """
    batch_kwargs = batch_kwargs or {}
    if sgd_step is None:
        sgd_step = make_fedavg_step(model, lr)
    params = {k: v.detach() for k, v in params.items()}
    deltas, losses = [], []
    for cid in client_ids:
        p = params
        for s in range(local_steps):
            b = data.sample_batch(int(cid), _batch_rng(key, int(cid), s),
                                  batch, **batch_kwargs)
            p, loss = sgd_step(p, b)
            losses.append(loss)
        deltas.append({k: p[k] - params[k] for k in params})
    weights = [float(data.client_weights[int(cid)]) for cid in client_ids]
    mean_delta = weighted_average(deltas, weights)
    new_params = {k: params[k] + mean_delta[k] for k in params}
    return new_params, torch.stack(losses).mean()


def run_fedavg(model, params: Tensors, data: FederatedDataset, *,
               rounds: int, cohort: int, key: int, local_steps: int,
               batch: int, lr: float, weighted_sampling: bool = True,
               seed: int = 0, batch_kwargs: Optional[dict] = None):
    """FedAvg driver: p_i-proportional cohort sampling + weighted averaging.
    Round r runs ``fedavg_round`` under the key drawn from
    ``SeedSequence([key, r + 1])``. Returns (params, per-round mean-loss
    list)."""
    rng = np.random.default_rng(seed)
    weights = data.client_weights if weighted_sampling else None
    sgd_step = make_fedavg_step(model, lr)
    buf = obs.MetricsBuffer()   # device losses; one transfer at end of run
    for r in range(rounds):
        ids = sample_clients(rng, data.num_clients, cohort, weights=weights)
        round_key = int(np.random.SeedSequence([key, r + 1])
                        .generate_state(1)[0])
        params, loss = fedavg_round(
            model, params, data, ids, round_key, local_steps=local_steps,
            batch=batch, lr=lr, batch_kwargs=batch_kwargs, sgd_step=sgd_step)
        buf.record({"loss": loss})
    return params, [m["loss"] for m in buf.flush()]


# ---------------------------------------------------------------------------
# SplitFed / FedLite trainer
# ---------------------------------------------------------------------------

def _copy_state(state: TrainState) -> TrainState:
    """A state the run may rebind freely (the caller keeps theirs)."""
    return TrainState(
        {k: v.detach().clone().requires_grad_()
         for k, v in state.params.items()},
        copy.deepcopy(state.opt_state), state.step)


@dataclasses.dataclass
class FederatedTrainer:
    """Round driver for split-learning algorithms on a FederatedDataset.

    Each round samples a cohort, stacks the cohort's client batches into one
    global batch (cohort = leading batch dim) and runs the split step.

    Rounds are dispatched by the virtual-clock `Scheduler`: ``fleet``
    (default identical ideal clients) and ``policy`` (default `FullSync`)
    select the heterogeneity scenario. Under straggler policies the
    stacked batch shrinks to the survivors. ``run`` leaves the per-round
    `Trace` — simulated wall-clock + measured wire bytes — in
    ``self.last_trace``. WHERE each round's per-client math executes is
    the ``executor``'s job (``federated/executor.py``; ``"stacked"``).

    The fields are the reference's; the module docstring lists what
    differs (int seeds, ``client_batch_for``, ``device``).
    """
    model: Any
    optimizer: Optimizer
    data: FederatedDataset
    cohort: int
    client_batch: int
    quantize: bool = True
    batch_kwargs: Optional[dict] = None
    seed: int = 0
    fleet: Optional[Sequence[ClientProfile]] = None
    policy: Optional[Policy] = None
    client_step_seconds: float = 1.0
    server_step_seconds: float = 0.0
    codebook_wire_dtype: str = "float16"
    # per-direction cut-layer codecs (spec string or CutCompressor; see
    # core/compressors.py). Uplink default: the model's PQ ("pq") or dense
    # ("none"). Downlink default: whatever the model carries, else dense.
    # A downlink spec is installed INTO (a shallow copy of) the model, so
    # the training backward pass and the measured wire bytes use the same
    # codec.
    uplink_compressor: Any = None
    downlink_compressor: Any = None
    # ---- cross-round cut-layer state (all default-off)
    # warm_start: carry the PQ codebooks across scheduler rounds, keyed by
    # client id (Lloyd resumes at PQConfig.warm_iters iterations).
    warm_start: bool = False
    # error_feedback: per-client uplink error-feedback memory, gathered /
    # scattered by client id across rounds.
    error_feedback: bool = False
    # stochastic_downlink: a per-step generator for the downlink codec so
    # scalarq gradient codecs round stochastically (unbiased).
    stochastic_downlink: bool = False
    # codebook_delta_bits: measure the pq directions with the `pq-delta`
    # wire kind (quantized codebook deltas vs the acked reference).
    codebook_delta_bits: Optional[int] = None
    # executor: "stacked", "mesh" / "mesh(shards=N)" (one process per
    # shard: every rank builds the same trainer) or a CohortExecutor.
    executor: Any = "stacked"
    # topology: optional aggregation hierarchy (federated/topology.py).
    topology: Any = None
    # scheduler_backend: "auto" | "vector" | "heapq"; both backends give
    # bitwise-identical traces.
    scheduler_backend: str = "auto"
    # fault_plan: optional seeded chaos schedule (federated/faults.py).
    fault_plan: Optional[FaultPlan] = None
    # slo_monitor: optional object with ``check(trace)``, called with the
    # finished trace at the end of every run() (duck-typed).
    slo_monitor: Optional[Any] = None
    # device: where the model, the batches and the run live.
    device: Any = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FederatedTrainer runs on the card by default and this "
                "machine has no CUDA device; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        for name, p in self.model.named_parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameter {name!r} is on {p.device}, the "
                    f"trainer on {self.device}")
        pq = getattr(self.model, "pq", None)
        dl = make_compressor(self.downlink_compressor, pq=pq)
        if dl is not None and hasattr(self.model, "downlink_compressor"):
            self._install(downlink_compressor=dl)
        self.downlink = dl if dl is not None else \
            getattr(self.model, "downlink_compressor", None)
        # the uplink codec is INSTALLED into the model (or must match what
        # the model already runs) so the trained path and the measured
        # traffic never diverge
        up = make_compressor(self.uplink_compressor, pq=pq)
        if up is None:
            up = PQCompressor(pq) if (self.quantize and pq is not None) \
                else NoneCompressor()
        elif isinstance(up, NoneCompressor):
            if self.quantize and pq is not None:
                raise ValueError(
                    "uplink_compressor='none' conflicts with the model's PQ "
                    "config; pass quantize=False or a model without pq")
        elif isinstance(up, PQCompressor):
            if not self.quantize:
                raise ValueError("uplink_compressor='pq' needs quantize=True")
            if up.cfg != pq:
                self._install(pq=up.cfg)
        elif hasattr(self.model, "uplink_compressor"):
            if not self.quantize:
                raise ValueError(
                    f"uplink_compressor={up.spec!r} needs quantize=True")
            self._install(uplink_compressor=up)
        else:
            raise ValueError(
                f"{type(self.model).__name__} has no uplink_compressor "
                f"field; only 'pq'/'none' uplinks are realizable for it")
        self.uplink = up
        if self.codebook_delta_bits is not None:
            if not 1 <= self.codebook_delta_bits <= 16:
                raise ValueError(f"codebook_delta_bits="
                                 f"{self.codebook_delta_bits} not in [1, 16]")
            if not isinstance(up, PQCompressor) \
                    and not isinstance(self.downlink, PQCompressor):
                raise ValueError(
                    "codebook_delta_bits needs a pq uplink or downlink")
            if not self.quantize:
                raise ValueError("codebook_delta_bits needs quantize=True")
        if self.warm_start and not isinstance(up, PQCompressor):
            raise ValueError("warm_start needs a pq uplink")
        if (self.warm_start or self.error_feedback) and not self.quantize:
            raise ValueError("warm_start/error_feedback need quantize=True")
        # the execution engine owns the steps; it is bound AFTER the codecs
        # above were installed so its steps see the final model
        self.executor = make_executor(self.executor)
        self.executor.bind(self)
        self._wants_cut_state = self.warm_start or self.error_feedback
        self._global_q: Optional[QuantizerState] = None   # cohort-global
        self._global_q_nparts = 0                         # cohort size of it
        self._client_q: Dict[int, QuantizerState] = {}    # by client id
        self._seed_q: Optional[QuantizerState] = None     # latest absorbed
        #                               per-client codebook: warm-start seed
        #                               for first-time clients
        self._ef_memory: Dict[int, torch.Tensor] = {}     # per-client rows
        self._act_struct: Optional[Tuple[Tuple[int, ...],
                                         torch.dtype]] = None
        self._batch_seed = self.seed   # run()'s seed; batches come from it
        self.last_codebook_meta: Dict[str, Any] = {}
        # (uplink, downlink) wire-kind tags behind the measured payload
        # bytes; set by measure_round_bytes, fed to the scheduler's ledger
        self.last_wire_kinds = ("dense", "dense")
        # canary uplink payload: the real wire bytes a client would ship,
        # corrupted per-plan in _screen_cohort (only built under a plan)
        self._canary_payload: Optional[bytes] = None
        self._fault_log: Dict[int, Dict[str, int]] = {}
        self._screen_log: Dict[int, Dict[str, Any]] = {}
        self._rng = np.random.default_rng(self.seed)
        if self.fleet is None:
            self.fleet = uniform_fleet(self.data.num_clients)
        validate_fleet(self.fleet, self.data.num_clients)
        if self.policy is None:
            self.policy = FullSync()
        if self.topology is not None:
            self.topology.ensure(self.data.num_clients)
            self.executor.set_topology(self.topology)
        self.last_trace: Optional[Trace] = None

    @property
    def writes_files(self) -> bool:
        """Whether this process writes the run's files (the obs event log,
        snapshots): rank 0 of a mesh executor's ``clients`` group, or the
        only process. Every rank keeps the same trace and history."""
        return getattr(self.executor, "rank", 0) == 0

    def _install(self, **fields) -> None:
        """Set codec fields on a shallow copy of the model: the caller's
        module is left as it is, and the parameters are shared."""
        model = copy.copy(self.model)
        for k, v in fields.items():
            setattr(model, k, v)
        self.model = model

    def init_state(self) -> TrainState:
        """A fresh state from copies of the model's current weights."""
        return TrainState.create(dict(self.model.named_parameters()),
                                 self.optimizer)

    # ---- batch assembly ----------------------------------------------------
    def client_batch_for(self, cid: int, round_id: int,
                         draw: int = 0) -> Dict[str, Any]:
        """Client ``cid``'s batch for round ``round_id`` under the current
        run's seed, from ``SeedSequence([seed, round_id, cid])``: the one
        place batches come from. Training rounds use ids from 1; id 0 is
        the wire measurement's (``draw`` 1 is its second tensor, for the
        steady-state ``pq-delta`` measurement)."""
        entropy = [self._batch_seed, int(round_id), int(cid)] \
            + ([int(draw)] if draw else [])
        batch = self.data.sample_batch(
            int(cid), _batch_rng(*entropy), self.client_batch,
            **(self.batch_kwargs or {}))
        for k, v in batch.items():
            if torch.is_tensor(v) and v.device.type != self.device.type:
                raise ValueError(f"batch[{k!r}] is on {v.device}, the "
                                 f"trainer on {self.device}")
        return batch

    def stack_batches(self, parts: Sequence[Dict[str, torch.Tensor]]):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def cohort_batch(self, round_id: int) -> Dict[str, torch.Tensor]:
        ids = sample_clients(self._rng, self.data.num_clients, self.cohort)
        return self.stack_batches([self.client_batch_for(cid, round_id)
                                   for cid in ids])

    def round(self, state: TrainState, round_id: int):
        """One synchronous server update on a fresh cohort, through the
        configured executor (the stacked default concatenates the cohort
        into one fused batch)."""
        ids = sample_clients(self._rng, self.data.num_clients, self.cohort)
        parts = [self.client_batch_for(cid, round_id) for cid in ids]
        return self.executor.execute(state, parts)

    # ---- cross-round cut-layer state ---------------------------------------
    def _client_act_struct(self, params, part):
        """Shape/dtype of one client's cut activation (one forward, cached)."""
        if self._act_struct is None:
            acts = self.executor.client_forward(params, part)
            self._act_struct = (tuple(acts.shape), acts.dtype)
        return self._act_struct

    def _client_ef(self, cid: int) -> torch.Tensor:
        mem = self._ef_memory.get(int(cid))
        if mem is not None:
            return mem
        shape, dtype = self._act_struct
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _gather_client_q(self, cids) -> Optional[QuantizerState]:
        """Per-client codebook states stacked in participant order (the
        port's states always carry the client axis).

        Warm-start lineage is keyed by CLIENT ID, so straggler policies
        that reshuffle cohort composition keep each client's lineage. A
        client with no state yet is SEEDED from the most recently absorbed
        codebook (`_seed_q`). Returns ``None`` (cold round) only before
        any per-client state exists."""
        if not self._client_q and self._seed_q is None:
            return None
        states = [self._client_q.get(c, self._seed_q) for c in cids]
        if any(s is None for s in states):   # no seed to warm first-timers
            return None
        return QuantizerState(*(torch.stack(xs) for xs in zip(*states)))

    def _cut_state_for(self, participants, params, parts, stacked: bool):
        """The round's `CutState` (or None when both features are off).
        Stacked path: per-client codebooks stacked in participant order
        when the model quantizes per client (else the cohort-global
        codebook) + per-client EF rows concatenated in participant order.
        Per-client path (AsyncBuffer flushes): every leaf gains a leading
        client axis."""
        if not self._wants_cut_state:
            return None
        self._client_act_struct(params, parts[0])
        cids = [int(a.client) for a in participants]
        if stacked:
            q = None
            if self.warm_start:
                q = self._gather_client_q(cids)
                if q is None:
                    # cohort-global lineage (one codebook per cohort) — or
                    # a stacked state, which only fits the cohort size
                    # that produced it: fall back to cold on a change
                    q = self._global_q
                    if q is not None and q.codebooks.shape[0] > 1 \
                            and len(cids) != self._global_q_nparts:
                        q = None
            ef = torch.cat([self._client_ef(c) for c in cids]) \
                if self.error_feedback else None
            return CutState(quantizer=q, ef_memory=ef)
        q = self._gather_client_q(cids) if self.warm_start else None
        ef = torch.stack([self._client_ef(c) for c in cids]) \
            if self.error_feedback else None
        return CutState(quantizer=q, ef_memory=ef)

    def _absorb_cut_state(self, participants, new_cut, stacked: bool):
        """Scatter a step's returned `CutState` back into the per-client
        slots keyed by client id. A stacked step's state is per client
        when the model split the fused batch into one codebook per
        participant (more than one); otherwise it lands in the
        cohort-global slot, as the reference's client-axis-free state
        does."""
        if new_cut is None:
            return
        cids = [int(a.client) for a in participants]
        if self.warm_start and new_cut.quantizer is not None:
            q = new_cut.quantizer
            nq = q.codebooks.shape[0]
            per_client = (nq == len(cids) and nq > 1) if stacked \
                else nq >= len(cids)
            if per_client:
                for i, c in enumerate(cids):
                    self._client_q[c] = QuantizerState(*(x[i] for x in q))
                self._seed_q = self._client_q[cids[-1]]
            else:
                self._global_q = q
                self._global_q_nparts = len(cids)
        if self.error_feedback and new_cut.ef_memory is not None:
            if stacked:
                rows = self._act_struct[0][0]
                for i, c in enumerate(cids):
                    self._ef_memory[c] = \
                        new_cut.ef_memory[i * rows:(i + 1) * rows]
            else:
                for i, c in enumerate(cids):
                    self._ef_memory[c] = new_cut.ef_memory[i]

    # ---- server-side admission screening (chaos plans only) ----------------
    def _screen_cohort(self, inj, update_idx: int, participants, parts,
                       weights):
        """Inject the plan's payload faults, then quarantine every
        contribution that fails the server's admission checks before any
        of it can touch the aggregate.

        Corruption is applied to the round's canary — the real uplink
        wire frame — and detection is the actual `federated/wire.py`
        decode (CRC + typed errors). Poisoned clients ship NaN-filled
        tensors; the finiteness screen (one host sync per client, under a
        fault plan only) catches them. A round whose survivor fraction
        falls below ``quorum_fraction`` is VOIDED.

        Returns ``(participants, parts, weights, fault_counters)`` —
        empty lists mean the round was voided.
        """
        cids = np.asarray([int(a.client) for a in participants], np.int64)
        poison = inj.poison_mask(update_idx, cids)
        corrupt = inj.corrupt_mask(update_idx, cids)
        fl: Dict[str, int] = {}
        if not poison.any() and not corrupt.any():
            return participants, parts, weights, fl
        parts = list(parts)
        for i in np.nonzero(poison)[0]:
            parts[i] = {k: torch.full_like(v, float("nan"))
                        if v.is_floating_point() else v
                        for k, v in parts[i].items()}
        keep = np.ones(len(parts), bool)
        undetected = 0
        canary = self._canary_payload
        for i in range(len(parts)):
            if corrupt[i] and canary is not None:
                bad = inj.corrupt_payload(canary, update_idx, int(cids[i]))
                try:
                    wire.decode_payload(bad)
                except wire.WireError:
                    keep[i] = False       # caught in transit -> quarantined
                    continue
                undetected += 1           # CRC missed: canary assertion trips
            if not keep[i]:
                continue
            for leaf in parts[i].values():
                if leaf.is_floating_point() \
                        and not bool(torch.isfinite(leaf).all()):
                    keep[i] = False       # non-finite -> quarantined
                    break
        quarantined = int((~keep).sum())
        if quarantined:
            fl["quarantined"] = quarantined
        if undetected:
            fl["corrupt_undetected"] = undetected
        voided = \
            int(keep.sum()) < self.fault_plan.quorum_fraction * len(parts)
        if quarantined or voided:
            self._screen_log[update_idx] = {
                "quarantined": [int(c) for c in cids[~keep]],
                "voided": voided}
        if voided:
            fl["round_voided"] = 1
            obs.event("fault.round_voided", cat="faults", round=update_idx,
                      quarantined=quarantined, cohort=len(parts))
            return [], [], [], fl
        if quarantined:
            participants = [a for a, k in zip(participants, keep) if k]
            parts = [p for p, k in zip(parts, keep) if k]
            if weights is not None:
                weights = [w for w, k in zip(weights, keep) if k]
        return participants, parts, weights, fl

    # ---- wire measurement --------------------------------------------------
    def _measure_acts(self, state: TrainState, draw: int) -> torch.Tensor:
        """The cut tensor (n, d) of client 0's measurement batch ``draw``."""
        acts = self.executor.client_forward(state.params,
                                            self.client_batch_for(0, 0, draw))
        return acts.reshape(-1, acts.shape[-1])

    def measure_round_bytes(self, state: TrainState) -> Tuple[int, int]:
        """Measured per-client (uplink, downlink) payload bytes for a round.

        One real client forward feeds both directions. Uplink: the cut
        activations through the configured uplink codec and the tagged wire
        format (`federated/wire.py`). Downlink: the cut-layer gradient
        message through the downlink codec — its payload layout is
        shape-determined, so the activation tensor stands in for the
        gradient and a single measurement is exact for every round.
        ``none`` on either side measures the dense tensor at its native
        dtype. With ``codebook_delta_bits`` set, each pq direction is
        measured as the steady-state ``pq-delta`` payload (see
        ``_measure_delta_direction``).
        """
        acts2 = self._measure_acts(state, 0)
        raw_bytes = acts2.numel() * acts2.element_size()

        def measured(compressor: Optional[CutCompressor]):
            # quantize=False disables the cut codecs in the training step
            # (models gate on it), so the measurement must stay dense too
            if not self.quantize or compressor is None \
                    or compressor.name == "none":
                return raw_bytes, "dense", None
            comp = compressor.compress(acts2[None])   # one client
            payload = compressor.wire_payload(
                comp, value_dtype=self.codebook_wire_dtype)
            # the kind tag the receiver will dispatch on — read from the
            # actual payload header so chains report their outermost stage
            return len(payload), wire.payload_kind(payload), payload

        with obs.span("trainer.measure_round_bytes", cat="wire"):
            uplink_bytes, up_kind, up_payload = measured(self.uplink)
            downlink_bytes, down_kind, _ = measured(self.downlink)
            # the chaos canary: one real uplink frame (dense tensors get a
            # dense frame), built only when a fault plan will corrupt it
            self._canary_payload = up_payload
            if up_payload is None and self.fault_plan is not None:
                self._canary_payload = wire.encode_dense(
                    acts2.float(), acts2.shape[0], acts2.shape[1],
                    "float32")
            self.last_codebook_meta = {}
            if self.codebook_delta_bits is not None and self.quantize:
                acts_b = self._measure_acts(state, 1)
                if isinstance(self.uplink, PQCompressor):
                    uplink_bytes = self._measure_delta_direction(
                        self.uplink.cfg, acts2, acts_b, uplink_bytes,
                        prefix="", bytes_key="uplink_bytes")
                    up_kind = "pq-delta"
                if isinstance(self.downlink, PQCompressor):
                    downlink_bytes = self._measure_delta_direction(
                        self.downlink.cfg, acts2, acts_b, downlink_bytes,
                        prefix="downlink_", bytes_key="downlink_bytes")
                    down_kind = "pq-delta"
        self.last_wire_kinds = (up_kind, down_kind)
        return uplink_bytes, downlink_bytes

    def _measure_delta_direction(self, cfg, acts2, acts_b, full_bytes: int,
                                 *, prefix: str, bytes_key: str) -> int:
        """Steady-state `pq-delta` payload bytes for one direction.

        Round 0 quantizes cold and ships full codebooks; the acked
        reference is what the receiver decoded — the codebook at wire
        fidelity. Round 1 quantizes warm-started from round 0's
        `QuantizerState` and ships b-bit codebook deltas against it."""
        qb1, qstate = quantize_stateful(acts2[None], cfg)
        # loopback of bytes we just encoded — nothing untrusted on this wire
        ref = wire.decode_bytes(  # fedlint: disable=unchecked-wire-decode
            wire.encode_bytes(qb1, self.codebook_wire_dtype)) \
            .codebooks.astype(np.float32)
        qb2, _ = quantize_stateful(acts_b[None], cfg, qstate)
        payload, _ = wire.encode_pq_delta(qb2, ref, self.codebook_delta_bits)
        d = int(acts2.shape[-1])
        cb_full = int(np.prod(cfg.codebook_shape(d))) \
            * wire._ITEMSIZE[wire._dtype_name(self.codebook_wire_dtype)]
        code_bytes = len(wire.encode_bytes(qb2, self.codebook_wire_dtype)) \
            - wire.HEADER_BYTES - wire.CRC_BYTES - cb_full
        cb_delta = len(payload) - wire.HEADER_BYTES - wire.CRC_BYTES \
            - code_bytes
        self.last_codebook_meta.update({
            f"{prefix}codebook_delta_bits": self.codebook_delta_bits,
            f"{bytes_key}_full_codebook": full_bytes,
            f"{bytes_key}_delta_codebook": len(payload),
            f"{prefix}codebook_bytes_full": cb_full,
            f"{prefix}codebook_bytes_delta": cb_delta,
            f"{prefix}codebook_bytes_reduction": cb_full / max(cb_delta, 1),
        })
        return len(payload)

    def measure_uplink_bytes(self, state: TrainState) -> int:
        return self.measure_round_bytes(state)[0]

    def measure_downlink_bytes(self, state: TrainState) -> int:
        return self.measure_round_bytes(state)[1]

    def measure_dense_bytes(self, state: TrainState) -> int:
        """The uncompressed cut tensor (either direction's dense baseline)."""
        acts = self._measure_acts(state, 0)
        return acts.numel() * acts.element_size()

    # ---- scheduled run -----------------------------------------------------
    def run(self, steps: int, seed: int = 0, log_every: int = 0,
            state: Optional[TrainState] = None,
            cursor: Optional[Dict[str, Any]] = None,
            on_round=None):
        """Run ``steps`` server updates through the scheduler.

        ``seed`` (an int, the reference's key) draws the client batches
        (``client_batch_for``). Returns (final state, history) where
        history holds one dict per server update: the step metrics
        (host-synced once, at the end of the run) plus the round's
        simulation fields. The full `Trace` is kept in ``self.last_trace``.

        ``state`` (optional) continues training from an existing
        `TrainState` (copied on entry: the caller's state is not touched).
        ``cursor`` / ``on_round`` are the crash-recovery hooks forwarded to
        `Scheduler.run` (sync policies only).
        """
        self._batch_seed = int(seed)
        state = self.init_state() if state is None else _copy_state(state)
        # per-round step metrics stay on the device; MetricsBuffer.flush is
        # the run's single blocking transfer
        metrics_buf = obs.MetricsBuffer()
        inj = make_injector(self.fault_plan)
        self._fault_log = {}
        self._screen_log = {}

        def execute(update_idx: int, participants: Sequence[Arrival],
                    weights: Sequence[float]) -> Dict:
            nonlocal state
            with obs.span("trainer.draw_batches", cat="trainer"):
                parts = [self.client_batch_for(a.client, a.version + 1)
                         for a in participants]
            if inj is not None and parts:
                participants, parts, weights, fl = self._screen_cohort(
                    inj, update_idx, participants, parts, weights)
                if fl:
                    self._fault_log[update_idx] = fl
                if not parts:
                    return {}   # round voided: below quorum, no update
            # AsyncBuffer flushes run the per-contribution staleness
            # weighting (FedBuff) on every flush; synchronous policies pass
            # weights=None and the executor fuses the cohort
            is_async = isinstance(self.policy, AsyncBuffer)
            per_client = self.executor.per_client_layout(is_async)
            cut_in = self._cut_state_for(participants, state.params, parts,
                                         stacked=not per_client)
            state, metrics = self.executor.execute(
                state, parts, weights if is_async else None, cut_in)
            self._absorb_cut_state(participants,
                                   metrics.pop("cut_state", None),
                                   stacked=not per_client)
            metrics_buf.record(metrics)
            if log_every and update_idx % log_every == 0:
                # the only mid-run host sync, at the caller-chosen cadence
                logger.info("step %d: loss=%.4f", update_idx,
                            float(metrics.get("loss", 0.0)))  # fedlint: disable=host-sync-in-callback
            return metrics

        scheduler = Scheduler(fleet=self.fleet, policy=self.policy,
                              client_step_seconds=self.client_step_seconds,
                              server_step_seconds=self.server_step_seconds,
                              seed=self.seed,
                              backend=self.scheduler_backend,
                              topology=self.topology,
                              faults=self.fault_plan)
        uplink, downlink = self.measure_round_bytes(state)
        trace = scheduler.run(
            steps, sample_cohort=lambda rd: sample_clients(
                self._rng, self.data.num_clients, self.cohort),
            uplink_bytes=uplink, downlink_bytes=downlink, execute=execute,
            placement=self.executor.place,
            wire_kinds=self.last_wire_kinds,
            cursor=cursor, on_round=on_round)
        dl = self.downlink
        trace.meta.update({
            "uplink_compressor": getattr(self.uplink, "spec",
                                         self.uplink.name),
            "downlink_compressor": "none" if dl is None
            else getattr(dl, "spec", dl.name),
            "uplink_bytes_per_client": uplink,
            "downlink_bytes_per_client": downlink,
            "warm_start": self.warm_start,
            "error_feedback": self.error_feedback,
            "stochastic_downlink": self.stochastic_downlink,
            "executor": self.executor.name,
            "executor_shards": getattr(self.executor, "num_shards", 1),
            "uplink_wire_kind": self.last_wire_kinds[0],
            "downlink_wire_kind": self.last_wire_kinds[1],
            "scheduler_backend": scheduler._resolve_backend(),
        })
        if self.topology is not None:
            trace.meta.update(self.topology.meta())
        trace.meta.update(self.last_codebook_meta)

        # one blocking transfer for the whole run
        host_metrics = metrics_buf.flush()
        history: List[Dict[str, float]] = []
        it = iter(host_metrics)
        for rec in trace:
            # merge server-side screening counters into the scheduler's
            # wire-level fault counters for the same round
            fl = self._fault_log.get(rec.round)
            if fl:
                rec.faults.update(fl)
            floats = next(it) if rec.metrics else {}
            rec.metrics = floats
            entry = dict(floats, step=rec.round, t_start=rec.t_start,
                         t_end=rec.t_end, uplink_bytes=rec.uplink_bytes,
                         downlink_bytes=rec.downlink_bytes,
                         participants=len(rec.participants),
                         dropped=len(rec.dropped))
            history.append(entry)
        # replay server-side screening verdicts onto the flight frames
        if trace.flights and self._screen_log:
            flightlib.apply_screening(trace.flights, self._screen_log)
        self.last_trace = trace
        if self.writes_files:
            obs.log_trace(trace)   # no-op unless a recorder is configured
        if self.slo_monitor is not None:
            self.slo_monitor.check(trace)
        return state, history

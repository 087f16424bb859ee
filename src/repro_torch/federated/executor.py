"""Cohort execution engine: who runs the round's client math, and where
(twin of ``repro/federated/executor.py``).

The virtual-clock `Scheduler` decides WHO participates in a server update;
the train steps in ``core/fedlite.py`` define WHAT one update computes.
This module owns the layer between them — HOW a cohort's per-client
forward/backward work is mapped onto devices. `FederatedTrainer` routes
``round`` / ``run``'s execute hook / ``measure_round_bytes`` through a
`CohortExecutor`, selected by spec string or instance:

  * ``stacked`` — the single-device path: synchronous policies concatenate
    the cohort's client batches into one fused batch for
    ``make_train_step``; `AsyncBuffer` flushes go through
    ``make_weighted_step``'s per-contribution staleness weighting.
  * ``mesh``    — cohort-parallel execution over the ``clients`` axis of a
    1-D ``DeviceMesh`` (``launch/mesh.make_clients_mesh``), in PyTorch's
    multi-process idiom: one process per shard (``torchrun`` or
    ``torch.multiprocessing.spawn``; a plain process is a world of one),
    each holding the same trainer and replicated parameters. The
    scheduler's numpy streams give every rank the same cohort and
    placement; each rank computes the clients of its contiguous block,
    and the weighted gradient sum crosses ranks once per server update,
    as one ``all_reduce`` (``core/fedlite.make_mesh_step``). Cohorts that
    do not divide the shard count are padded with zero-masked slots.

Every scheduler policy executes unchanged on either backend: policies see
cohorts and arrival times, never devices. The executor also assigns each
participant its shard (``place``), which the traces record.

Semantics: the mesh backend reproduces the stacked backend's round metrics
and gradients (allclose; float reassociation only) whenever the model
quantizes per client (``model.client_batch == trainer.client_batch``) or
runs unquantized. A cohort-global codebook (``model.client_batch == 0``
with PQ on) is not shard-local: the mesh then clusters per client, and
logs a warning. The λ-correction's scale in the fused synchronous step
and in per-client gradients is reconciled by ``make_mesh_step``'s
``correction_scope``.

New backends register through ``register_executor`` without touching the
trainer.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core.fedlite import (TrainState, make_mesh_step,
                                      make_train_step, make_weighted_step)
from repro_torch.sharding.ctx import CLIENTS_AXIS, clients_rank

logger = logging.getLogger(__name__)


class CohortExecutor:
    """Base class: maps one server update's cohort onto devices.

    Lifecycle: `FederatedTrainer.__post_init__` resolves the spec via
    ``make_executor`` and calls ``bind(trainer)`` exactly once — after the
    trainer has installed the cut-layer codecs into the model — so the
    executor builds its steps against the final model. All entry points
    take/return the trainer's `TrainState`; metrics stay on the device
    (the trainer host-syncs once per run).
    """
    name: str = "base"

    def bind(self, trainer) -> None:
        raise NotImplementedError

    def barrier(self) -> None:
        """Wait for every rank of the executor's mesh (one process: no
        wait)."""

    def _claim(self, trainer) -> None:
        """Attach to ``trainer``, refusing silent re-targeting: one executor
        instance holds one trainer's steps."""
        bound = getattr(self, "trainer", None)
        if bound is not None and bound is not trainer:
            raise ValueError(
                f"{type(self).__name__} is already bound to another trainer;"
                " construct one executor per FederatedTrainer")
        self.trainer = trainer

    # ---- cohort layout -----------------------------------------------------
    def per_client_layout(self, is_async: bool) -> bool:
        """Whether cut-layer state must be client-major for this path
        (vs the stacked synchronous layout: concatenated EF rows +
        cohort-level codebook state)."""
        raise NotImplementedError

    def place(self, participants: Sequence[Any]) -> List[Any]:
        """Annotate each `Arrival` with the shard that will execute it."""
        with obs.span("executor.place", cat="executor", backend=self.name,
                      clients=len(participants)):
            return [dataclasses.replace(a, shard=0) for a in participants]

    # ---- topology awareness ------------------------------------------------
    def set_topology(self, topology: Any) -> None:
        """Store the topology's client->edge map (the stacked single-device
        path stores but ignores it)."""
        self._cluster_of = None if topology is None \
            else getattr(topology, "cluster_of", None)

    # ---- execution ---------------------------------------------------------
    def execute(self, state: TrainState, parts: Sequence[Dict],
                weights: Optional[Sequence[float]] = None,
                cut_state: Any = None) -> Tuple[TrainState, Dict]:
        """Run one server update over ``parts`` (one batch per client, in
        participant order). ``weights=None`` selects synchronous semantics;
        a weight vector selects the per-contribution (FedBuff) semantics
        with ``cut_state`` in client-major layout."""
        raise NotImplementedError

    # ---- measurement routing ----------------------------------------------
    def client_forward(self, params: Dict[str, torch.Tensor], batch):
        """One client's cut activations for the wire measurement, from the
        state's params (no autograd graph)."""
        with torch.no_grad():
            return torch.func.functional_call(
                _ClientForward(self.trainer.model),
                {f"model.{k}": v for k, v in params.items()}, (batch,))


class _ClientForward(torch.nn.Module):
    """``model.client_forward`` of a batch dict (its entry under the
    model's ``input_key``), as a module's forward, so that
    ``functional_call`` can run it on a state's params."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.client_forward(batch[self.model.input_key])


@dataclasses.dataclass
class StackedExecutor(CohortExecutor):
    """The single-device path: one fused step per synchronous round, the
    per-contribution weighted step per asynchronous flush."""
    name: str = dataclasses.field(default="stacked", init=False)

    def bind(self, trainer) -> None:
        self._claim(trainer)
        step_key = trainer.seed if trainer.stochastic_downlink else None
        self._step = make_train_step(trainer.model, trainer.optimizer,
                                     quantize=trainer.quantize,
                                     step_key=step_key)
        self._weighted_step = make_weighted_step(
            trainer.model, trainer.optimizer, quantize=trainer.quantize,
            step_key=step_key)

    def per_client_layout(self, is_async: bool) -> bool:
        return is_async

    def execute(self, state, parts, weights=None, cut_state=None):
        # the span measures host launch time (the step runs asynchronously
        # on the device); waiting for the device here would add the very
        # host sync the metrics buffer exists to avoid
        with obs.span("executor.execute", cat="executor", backend=self.name,
                      clients=len(parts),
                      mode="sync" if weights is None else "weighted"):
            if weights is None:
                # one definition of the batch fusing
                batch = self.trainer.stack_batches(parts)
                return self._step(state, batch, cut_state)
            return self._weighted_step(state, parts, weights, cut_state)


@dataclasses.dataclass
class MeshExecutor(CohortExecutor):
    """Cohort-parallel execution over the ``clients`` axis of a
    ``DeviceMesh``, one process per shard.

    ``shards=0`` takes the world size of the initialised process group (a
    world of one when none is); pass ``shards=n``, ``backend`` (default:
    the trainer's device's, NCCL on the card, gloo on the CPU) or an
    explicit ``mesh`` (any ``DeviceMesh`` with a ``clients`` axis). Every
    rank builds the same trainer and runs the same ``run``: the
    scheduler's numpy streams give every rank the same cohorts, arrivals
    and placement, and each rank computes its block of slots.
    """
    shards: int = 0
    mesh: Any = None
    backend: Optional[str] = None
    name: str = dataclasses.field(default="mesh", init=False)

    def bind(self, trainer) -> None:
        from repro_torch.launch.mesh import make_clients_mesh

        self._claim(trainer)
        if self.mesh is None:
            self.mesh = make_clients_mesh(self.shards, trainer.device,
                                          self.backend)
        if CLIENTS_AXIS not in (self.mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh {self.mesh.mesh_dim_names} has no "
                             f"{CLIENTS_AXIS!r} axis")
        self.num_shards = self.mesh.size(
            self.mesh.mesh_dim_names.index(CLIENTS_AXIS))
        self.rank = clients_rank(self.mesh)
        self._steps: Dict[str, Callable] = {}
        self._step_key = trainer.seed if trainer.stochastic_downlink \
            else None
        if trainer.quantize and getattr(trainer.model, "pq", None) is not None \
                and getattr(trainer.model, "client_batch", 0) == 0:
            logger.warning(
                "mesh executor with a cohort-global PQ codebook "
                "(model.client_batch=0): clustering runs per client on the "
                "mesh — set model.client_batch=trainer.client_batch for "
                "stacked-parity quantization granularity")

    def per_client_layout(self, is_async: bool) -> bool:
        return True

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.get_group(CLIENTS_AXIS))

    # ---- placement ---------------------------------------------------------
    def _slot_count(self, n: int) -> int:
        """Padded client-slot count: the smallest multiple of the shard
        count that fits the cohort."""
        return max(-(-n // self.num_shards) * self.num_shards,
                   self.num_shards)

    def place(self, participants):
        """Contiguous-block shard assignment; cluster-major when a
        topology is installed (participants stably sorted by edge cluster
        before the block split, so one shard's block holds whole clusters
        where sizes allow; the scheduler records this order)."""
        with obs.span("executor.place", cat="executor", backend=self.name,
                      clients=len(participants)):
            parts = list(participants)
            cluster_of = getattr(self, "_cluster_of", None)
            if cluster_of is not None and parts:
                order = np.argsort(
                    np.asarray([int(cluster_of[a.client]) for a in parts]),
                    kind="stable")
                parts = [parts[i] for i in order]
            local = self._slot_count(len(parts)) // self.num_shards
            return [dataclasses.replace(a, shard=i // local)
                    for i, a in enumerate(parts)]

    # ---- execution ---------------------------------------------------------
    def _get_step(self, scope: str) -> Callable:
        if scope not in self._steps:
            self._steps[scope] = make_mesh_step(
                self.trainer.model, self.trainer.optimizer, self.mesh,
                quantize=self.trainer.quantize, step_key=self._step_key,
                correction_scope=scope)
        return self._steps[scope]

    def execute(self, state, parts, weights=None, cut_state=None):
        sync = weights is None
        n = len(parts)
        slots = self._slot_count(n)
        pad = slots - n
        with obs.span("executor.execute", cat="executor", backend=self.name,
                      clients=n, slots=slots, shards=self.num_shards,
                      mode="sync" if sync else "weighted"):
            # padding slots repeat the last client (mask 0): only a rank
            # whose block holds no real client runs one, for its layout
            batches = list(parts) + [parts[-1]] * pad
            w = ([1.0] * n if sync else list(weights)) + [1.0] * pad
            mask = [1.0] * n + [0.0] * pad
            if cut_state is not None and pad:
                cut_state = _pad_cut(cut_state, pad)
            step = self._get_step("cohort" if sync else "client")
            state, metrics = step(state, batches, w, mask, cut_state)
            if sync:
                # synchronous metrics keep the stacked path's keys
                metrics.pop("mean_staleness_weight", None)
            return state, metrics


def _pad_cut(cut_state, pad: int):
    """A client-major ``CutState`` grown by ``pad`` copies of its last
    client."""
    def grow(x):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    q = cut_state.quantizer
    return type(cut_state)(
        quantizer=None if q is None else type(q)(*(grow(x) for x in q)),
        ef_memory=None if cut_state.ef_memory is None
        else grow(cut_state.ef_memory))


# ---------------------------------------------------------------------------
# registry + spec parsing
# ---------------------------------------------------------------------------

_EXECUTORS: Dict[str, Callable[..., CohortExecutor]] = {}


def register_executor(name: str,
                      factory: Callable[..., CohortExecutor]) -> None:
    """Register (or replace) a named executor factory."""
    _EXECUTORS[name] = factory


register_executor("stacked", lambda **kw: StackedExecutor(**kw))
register_executor("mesh", lambda **kw: MeshExecutor(**kw))


def available_executors() -> Tuple[str, ...]:
    return tuple(sorted(_EXECUTORS))


_SPEC_RE = re.compile(r"^(?P<name>[a-zA-Z_]\w*)(?:\((?P<args>.*)\))?$")


def make_executor(spec) -> CohortExecutor:
    """Build an executor from a spec string (``"stacked"``, ``"mesh"``,
    ``"mesh(shards=4)"``) or pass an instance through unchanged. ``None``
    resolves to the stacked default."""
    if spec is None:
        return StackedExecutor()
    if isinstance(spec, CohortExecutor):
        return spec
    m = _SPEC_RE.match(spec.strip())
    if not m or m.group("name") not in _EXECUTORS:
        raise ValueError(f"unknown executor spec {spec!r}; registered: "
                         f"{available_executors()}")
    kwargs: Dict[str, Any] = {}
    for part in (m.group("args") or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"executor arg {part!r} must be key=value")
        k, v = part.split("=", 1)
        kwargs[k.strip()] = int(v.strip()) if v.strip().isdigit() \
            else v.strip()
    return _EXECUTORS[m.group("name")](**kwargs)

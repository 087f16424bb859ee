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
  * ``mesh``    — cohort-parallel execution over a ``clients`` device axis.
    It stays registered, so a spec naming it fails loudly: the port's mesh
    (DeviceMesh / DTensor, one all-reduce of the weighted gradient) is
    ROADMAP A13.

New backends register through ``register_executor`` without touching the
trainer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.fedlite import (TrainState, make_train_step,
                                      make_weighted_step)


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
    """Cohort-parallel execution over a ``clients`` device axis: not
    ported yet. Registered so that ``executor="mesh"`` names what is
    missing instead of reading as an unknown spec."""
    shards: int = 0
    mesh: Any = None
    name: str = dataclasses.field(default="mesh", init=False)

    def bind(self, trainer) -> None:
        raise NotImplementedError(
            "the mesh executor (cohort-parallel execution over a `clients` "
            "device axis) is not ported yet (ROADMAP A13); use "
            "executor='stacked'")


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

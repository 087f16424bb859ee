"""Crash-consistent runtime snapshots + the self-healing run driver (twin
of ``repro/federated/recovery.py``).

`federated/faults.py` can kill the server between rounds (`ServerKilled`);
this module is what survives it. A **snapshot** captures everything a
`FederatedTrainer.run` needs to continue bitwise-identically:

  * the `TrainState` (params, optimizer state, step counter);
  * the cross-round cut-layer state — per-client / cohort-global
    `QuantizerState` warm-start lineages, the seed codebook, and every
    client's error-feedback memory;
  * the trainer's cohort-sampling RNG (`numpy` bit-generator state);
  * the scheduler cursor ({round, virtual clock, scheduler RNG state});
  * the trace records, flight frames and history rows of every completed
    round.

Snapshots ride the `checkpointing/checkpoint.py` atomic-write + manifest
machinery (tmp + rename, sha256-verified restore), with the non-array
state in the manifest-covered meta json, so a kill mid-save can never
leave a restorable-but-corrupt snapshot.

A snapshot is the reference's, key for key, in the reference's layouts,
so each package restores the other's: ``train/NNNN`` holds the leaves in
the order of the reference's ``jax.tree.leaves(TrainState)`` (dict keys
sorted at every level: the params as ``{client, server}``, then the
optimizer state, then the step; steps as int32 0-d arrays; conv weights
HWIO), ``client_q/<cid>``, ``ef/<cid>``, ``global_q`` (without the client
axis when it holds one codebook) and ``seed_q``. `state_leaves` and
`state_from_leaves` are that conversion.

`run_with_recovery` drives training in ``checkpoint_every``-round
segments, snapshotting after each, and reacts to a `ServerKilled` the way
a restarted process would: restore the latest snapshot FROM DISK (the
in-memory trainer is treated as lost), disarm the kill that already
fired (a restarted server does not re-die at the same round), and resume
from the cursor. Final params and trace are bitwise-identical to an
uninterrupted run (tests/test_torch_recovery.py pins this). The run's
batches come from an int ``seed``, as in `FederatedTrainer.run`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpointing.checkpoint import (latest_step,
                                                  restore_checkpoint,
                                                  save_checkpoint)
from repro_torch.core.fedlite import TrainState
from repro_torch.core.quantizer import QuantizerState
from repro_torch.federated.faults import ServerKilled
from repro_torch.federated.trace import RoundRecord, Trace
from repro_torch.models.paper_models import from_jax_params, to_jax_params
from repro_torch.obs import flight as flightlib

__all__ = ["snapshot_runtime", "restore_runtime", "run_with_recovery",
           "state_leaves", "state_from_leaves"]


# ---------------------------------------------------------------------------
# TrainState <-> the reference's leaf list
# ---------------------------------------------------------------------------

def _ref_tree(tree: Any, names) -> Any:
    """A port optimizer-state tree in the reference's layout: a dict keyed
    by the parameter names becomes ``{client: {...}, server: {...}}``
    (conv weights HWIO; a parameter's sub-tree, such as Adafactor's
    ``{"row", "col"}``, is kept in the reference's layout already), an int
    step an int32 0-d array."""
    if isinstance(tree, dict) and tree and set(tree) == names:
        if all(torch.is_tensor(v) for v in tree.values()):
            return to_jax_params(tree)
        out: Dict[str, Dict[str, Any]] = {}
        for key, sub in tree.items():
            part, name = key.split(".", 1)
            out.setdefault(part, {})[name] = _ref_tree(sub, names)
        return out
    if isinstance(tree, dict):
        return {k: _ref_tree(v, names) for k, v in tree.items()}
    if isinstance(tree, int):
        return np.asarray(tree, np.int32)
    return tree


def _leaves(tree: Any) -> List[Any]:
    """``jax.tree.leaves`` of a nested dict: keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def state_leaves(state: TrainState) -> List[Any]:
    """The reference's ``jax.tree.leaves(TrainState)`` of a port state:
    params, then optimizer state, then step, dict keys sorted at every
    level; tensors in the reference's layouts (on their device), steps as
    int32 0-d numpy arrays."""
    names = set(state.params)
    return (_leaves(to_jax_params(state.params))
            + _leaves(_ref_tree(state.opt_state, names))
            + [np.asarray(state.step, np.int32)])


def _tensor(leaf, device) -> torch.Tensor:
    """A leaf (a tensor, or an array copied) as a tensor on ``device``."""
    if not torch.is_tensor(leaf):
        leaf = torch.from_numpy(np.array(leaf))
    return leaf.to(device)


def _take(template: Any, it, device) -> Any:
    """A nested dict shaped like ``template`` (a structure: its leaves are
    not read) whose leaves are the next ones of ``it``, in sorted-key
    order, as tensors on ``device``."""
    if isinstance(template, dict):
        return {k: _take(template[k], it, device) for k in sorted(template)}
    return _tensor(next(it), device)


def _fill(template: Any, it, names, device) -> Any:
    """The port tree shaped like ``template`` with its leaves taken, in the
    reference's order, from ``it``."""
    if isinstance(template, dict) and template and set(template) == names:
        parts: Dict[str, Dict[str, Any]] = {}
        for key, sub in template.items():
            part, name = key.split(".", 1)
            parts.setdefault(part, {})[name] = sub
        taken = _take(parts, it, device)
        if all(torch.is_tensor(v) for v in template.values()):
            got = from_jax_params(taken)
        else:
            got = {f"{part}.{name}": v for part, sub in taken.items()
                   for name, v in sub.items()}
        return {k: got[k] for k in template}
    if isinstance(template, dict):
        out = {k: _fill(template[k], it, names, device)
               for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, int):
        return int(next(it))
    return _tensor(next(it), device)


def state_from_leaves(leaves, template: TrainState,
                      device=None) -> TrainState:
    """The inverse of `state_leaves`: a port `TrainState` with
    ``template``'s structure from the reference's leaf list (tensors or
    arrays). Params come back as leaf tensors with ``requires_grad``, as
    `TrainState.create` makes them; steps as Python ints."""
    device = torch.device(device) if device is not None else \
        next(iter(template.params.values())).device
    names = set(template.params)
    it = iter(leaves)
    params = _fill(template.params, it, names, device)
    opt_state = _fill(template.opt_state, it, names, device)
    step = int(next(it))
    if next(it, None) is not None:
        raise ValueError("more leaves than the template's TrainState holds")
    params = {k: v.detach().requires_grad_() for k, v in params.items()}
    return TrainState(params, opt_state, step)


# ---------------------------------------------------------------------------
# cut-layer state <-> the reference's layout
# ---------------------------------------------------------------------------

def _q_tree(q: Optional[QuantizerState]) -> Optional[Dict[str, Any]]:
    return None if q is None else dict(q._asdict())


def _q_from(tree: Optional[Dict[str, Any]]) -> Optional[QuantizerState]:
    return None if tree is None else QuantizerState(**tree)


def _global_to_ref(q: QuantizerState) -> QuantizerState:
    """The port's cohort-global state always carries a client axis; the
    reference's has none when it holds one codebook."""
    if q.codebooks.shape[0] == 1:
        return QuantizerState(q.codebooks[0], q.rounds[0])
    return q


def _global_from_ref(q: QuantizerState) -> QuantizerState:
    if q.codebooks.dim() == 3:
        return QuantizerState(q.codebooks[None], q.rounds[None])
    return q


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def snapshot_runtime(trainer, state: TrainState, cursor: Dict[str, Any],
                     trace: Trace, history: List[Dict[str, Any]],
                     ckpt_dir: str) -> str:
    """Write one atomic, manifest-verified snapshot at ``cursor['round']``.

    Array state goes into the npz (TrainState leaves in the reference's
    order + the cut-layer dicts by client id); everything host-side —
    both RNG states, the cursor, completed trace records, flight frames,
    history — goes into the manifest-covered meta json.
    """
    step = int(cursor["round"])
    tree: Dict[str, Any] = {
        "train": {f"{i:04d}": leaf
                  for i, leaf in enumerate(state_leaves(state))},
        "client_q": {str(c): _q_tree(q)
                     for c, q in trainer._client_q.items()},
        "ef": {str(c): m for c, m in trainer._ef_memory.items()},
    }
    if trainer._global_q is not None:
        tree["global_q"] = _q_tree(_global_to_ref(trainer._global_q))
    if trainer._seed_q is not None:
        tree["seed_q"] = _q_tree(trainer._seed_q)
    meta = {
        "cursor": cursor,
        "trainer_rng": trainer._rng.bit_generator.state,
        "global_q_nparts": trainer._global_q_nparts,
        "records": [dataclasses.asdict(r) for r in trace.records],
        "trace_meta": dict(trace.meta),
        "history": history,
        # flight-recorder frames ride the manifest too: a resumed run's
        # exemplar lifecycles cover the WHOLE run, not just the tail
        "flights": [f.to_json() for f in getattr(trace, "flights", [])],
    }
    with obs.span("recovery.snapshot", cat="io", round=step):
        # under a mesh executor rank 0 writes and every rank waits for it,
        # so that any rank may restore from ``ckpt_dir`` after a kill
        path = save_checkpoint(ckpt_dir, step, tree, extra=meta) \
            if trainer.writes_files \
            else os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
        trainer.executor.barrier()
    return path


def _load_meta(ckpt_dir: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, f"meta_{step:08d}.json")) as f:
        return json.load(f)


def restore_runtime(trainer, template_state: TrainState, ckpt_dir: str,
                    step: Optional[int] = None,
                    ) -> Tuple[TrainState, Dict[str, Any], Trace,
                               List[Dict[str, Any]]]:
    """Rebuild ``(state, cursor, trace, history)`` from the latest (or
    given) snapshot, onto the trainer's device, and reinstall the
    cut-layer + RNG state on ``trainer``.

    ``template_state`` supplies the TrainState structure — snapshots store
    leaves in the reference's flatten order, which is fixed for a fixed
    trainer construction, exactly what a restarted process rebuilds."""
    step = step if step is not None else latest_step(ckpt_dir)
    tree = restore_checkpoint(ckpt_dir, step, device=trainer.device)
    meta = _load_meta(ckpt_dir, step)
    leaves = [tree["train"][k] for k in sorted(tree["train"])]
    state = state_from_leaves(leaves, template_state, trainer.device)
    trainer._client_q = {int(c): _q_from(q)
                         for c, q in tree.get("client_q", {}).items()}
    trainer._ef_memory = {int(c): m for c, m in tree.get("ef", {}).items()}
    glob = _q_from(tree.get("global_q"))
    trainer._global_q = None if glob is None else _global_from_ref(glob)
    trainer._seed_q = _q_from(tree.get("seed_q"))
    trainer._global_q_nparts = int(meta["global_q_nparts"])
    trainer._rng = np.random.default_rng()
    trainer._rng.bit_generator.state = meta["trainer_rng"]
    trace = Trace(records=[RoundRecord(**r) for r in meta["records"]],
                  meta=dict(meta["trace_meta"]))
    trace.flights = [flightlib.FlightFrame.from_json(d)
                     for d in meta.get("flights", [])]
    for r in trace.records:   # json round-trips tuples as lists
        r.participants = tuple(r.participants)
        r.dropped = tuple(r.dropped)
        r.staleness = tuple(r.staleness)
        r.shards = tuple(r.shards)
    return state, meta["cursor"], trace, list(meta["history"])


def run_with_recovery(trainer, steps: int, seed: int, ckpt_dir: str, *,
                      checkpoint_every: int = 5, log_every: int = 0,
                      max_restarts: int = 8):
    """Run ``steps`` rounds with periodic snapshots and kill recovery.

    Returns ``(state, history)`` like `FederatedTrainer.run`, with the
    merged whole-run `Trace` in ``trainer.last_trace``. Only synchronous
    policies are supported (the cursor contract). ``max_restarts`` bounds
    pathological plans that kill faster than a segment completes.
    """
    if checkpoint_every <= 0:
        raise ValueError("checkpoint_every must be positive")
    plan = trainer.fault_plan
    state = trainer.init_state()
    template = state
    cursor: Optional[Dict[str, Any]] = None
    trace = Trace()
    history: List[Dict[str, Any]] = []
    restarts = 0
    done = 0
    while done < steps:
        end = min(done + checkpoint_every, steps)
        try:
            state, seg_hist = trainer.run(end, seed, log_every=log_every,
                                          state=state, cursor=cursor)
        except ServerKilled as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            obs.event("fault.server_restart", cat="faults",
                      round=e.round_index, restarts=restarts)
            # a restarted process recovers from DISK, not from the dirty
            # in-memory trainer — and the fired kill stays fired
            trainer.fault_plan = trainer.fault_plan.disarm_kills_through(
                e.round_index)
            if done == 0:
                # killed before the first snapshot: cold restart
                state = trainer.init_state()
                trainer._client_q = {}
                trainer._ef_memory = {}
                trainer._global_q = None
                trainer._seed_q = None
                trainer._global_q_nparts = 0
                trainer._rng = np.random.default_rng(trainer.seed)
                cursor = None
                trace = Trace()
                history = []
            else:
                state, cursor, trace, history = restore_runtime(
                    trainer, template, ckpt_dir)
                done = int(cursor["round"])
            continue
        seg_trace = trainer.last_trace
        trace.records.extend(seg_trace.records)
        trace.flights.extend(getattr(seg_trace, "flights", []))
        trace.meta.update(seg_trace.meta)
        trace.cursor = seg_trace.cursor
        history.extend(seg_hist)
        cursor = seg_trace.cursor
        done = end
        snapshot_runtime(trainer, state, cursor, trace, history, ckpt_dir)
    trainer.fault_plan = plan
    trainer.last_trace = trace
    return state, history

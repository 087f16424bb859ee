"""Trace-driven autoscaler: turn observed round traces into (cohort,
policy, compressor) moves (twin of ``repro/federated/autoscale.py``).

The scheduler measures, the executor scales compute — this module closes
the control loop over the remaining knobs. A `TraceAutoscaler` watches the
windowed observations a `Trace` exposes (``tail_ratio`` — the p95/p50
straggler tail of round durations, ``drop_rate``, ``bytes_per_round``,
``loss_slope``) and recommends the next `AutoscalePlan`:

  * straggler-dominated rounds (heavy duration tail under a waiting
    policy) → stop waiting: move FullSync to a Deadline at a p50-derived
    budget (the Caldas-style bounded round);
  * an over-aggressive policy (drop rate past ``drop_hi``) → back off —
    loosen the deadline / shed a drop slot — before shrinking the cohort,
    so participation is sacrificed last;
  * a wire-bytes budget breach → first strengthen the downlink codec along
    ``DOWNLINK_LADDER`` (compression is cheaper than participation), then
    halve the cohort;
  * a healthy, still-improving run → grow the cohort toward ``max_cohort``
    (more parallel clients per round, which the mesh executor turns into
    wall-clock);
  * a plateaued run → halve the cohort: the marginal clients are buying
    no loss and their bytes are pure cost.

Rules are ordered, pure and deterministic: the same trace and current plan
always produce the same recommendation (asserted in
tests/test_torch_autoscale.py), so autoscaled runs are reproducible.
``autoscale_run`` drives a full training run in plan-sized segments —
consult, rebuild the trainer, continue from the same `TrainState` — the
path the femnist example's ``--autoscale`` flag runs. Segment ``seg``
runs under the int seed drawn from ``SeedSequence([seed, seg])`` where the
reference folds its key.

The plan's policy is a spec string (``"full_sync"``, ``"drop_slowest:k"``,
``"deadline:seconds"``, ``"async:buffer"``) so plans are hashable,
loggable rows; ``make_policy`` materializes the scheduler object.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.federated.scheduler import (AsyncBuffer, Deadline,
                                             DropSlowestK, FullSync)
from repro_torch.federated.trace import Trace
from repro_torch.obs import slo

# the codec escalation ladder for bytes-budget breaches: each entry is a
# `core/compressors.py` spec for the downlink gradient message (None =
# dense). Measured reductions: ~4x for scalarq(8), ~12x for the chain.
DOWNLINK_LADDER: Tuple[Optional[str], ...] = (
    None, "scalarq(bits=8)", "chain:topk(k=0.1)+scalarq(bits=8)")


@dataclasses.dataclass(frozen=True)
class AutoscalePlan:
    """One point in the (cohort, policy, downlink codec) control space."""
    cohort: int
    policy: str = "full_sync"            # policy spec (see make_policy)
    downlink: Optional[str] = None       # downlink compressor spec
    reason: str = "initial"              # which rule produced this plan

    def moved_from(self, other: "AutoscalePlan") -> bool:
        """True when this plan changes any knob vs ``other``."""
        return (self.cohort, self.policy, self.downlink) != \
            (other.cohort, other.policy, other.downlink)


def make_policy(spec: str):
    """Materialize a policy spec string into a scheduler policy object."""
    name, _, arg = spec.partition(":")
    if name == "full_sync":
        return FullSync()
    if name == "drop_slowest":
        return DropSlowestK(int(arg or 1))
    if name == "deadline":
        return Deadline(float(arg))
    if name == "async":
        return AsyncBuffer(int(arg or 4))
    raise ValueError(f"unknown policy spec {spec!r}")


@dataclasses.dataclass
class TraceAutoscaler:
    """Deterministic rule-based controller over `Trace` windows.

    Thresholds are explicit fields so benchmark rows can record the exact
    controller that produced a run. ``window`` rounds of observation feed
    every rule; rules are evaluated in the order documented in the module
    docstring, first hit wins, no hit returns the current plan unchanged
    (``reason="steady"``).
    """
    window: int = 8
    tail_hi: float = 1.8            # p95/p50 duration ratio: straggler tail
    drop_hi: float = 0.3            # lost fraction: policy too aggressive
    deadline_slack: float = 1.5     # deadline = slack * p50 duration
    bytes_budget_per_round: Optional[float] = None   # total bytes, both dirs
    plateau_slope: float = -1e-3    # loss slope above this = plateaued
    min_cohort: int = 2
    max_cohort: int = 64

    def observe(self, trace: Trace) -> Dict[str, float]:
        """The windowed signals every rule reads (also a benchmark row).

        The two tier signals are observational (0.0 on flat-star runs):
        under a two-tier topology ``bytes_per_round`` — which rule 3
        budgets against — already includes both tiers via
        ``RoundRecord.uplink_bytes``, and the split shows WHERE the bytes
        flow: a congested parameter server shows up as
        ``server_uplink_per_round`` growth, which more edges would
        dilute, while ``edge_uplink_per_round`` only responds to cohort
        size and codec moves.
        """
        w = self.window
        sig = {
            "rounds": float(len(trace)),
            "tail_ratio": trace.tail_ratio(w),
            "drop_rate": trace.drop_rate(w),
            "bytes_per_round": trace.bytes_per_round(w),
            "p50_duration": trace.duration_percentile(50.0, w),
            "p99_duration": trace.duration_percentile(99.0, w),
            "loss_slope": trace.loss_slope(w),
            "edge_uplink_per_round": trace.tier_bytes_per_round(
                "edge_uplink", w),
            "server_uplink_per_round": trace.tier_bytes_per_round(
                "server_uplink", w),
        }
        # chaos-health signals, shared with the SLO monitors
        # (repro_torch.obs.slo): observational here — rules key off
        # tail/drop — but recorded so autoscale benchmark rows grade run
        # health too
        slo_sig = slo.trace_signals(trace, w)
        sig["quarantine_rate"] = slo_sig["quarantine_rate"]
        sig["retry_byte_overhead"] = slo_sig["retry_byte_overhead"]
        return sig

    def recommend(self, trace: Trace,
                  current: AutoscalePlan) -> AutoscalePlan:
        """The next plan given the observed window (pure, deterministic)."""
        if not len(trace):
            return current
        obs = self.observe(trace)

        # 1. straggler tail under a waiting policy: bound the round instead
        if obs["tail_ratio"] > self.tail_hi \
                and current.policy.startswith("full_sync"):
            budget = self.deadline_slack * obs["p50_duration"]
            return dataclasses.replace(
                current, policy=f"deadline:{budget:g}",
                reason=f"straggler tail {obs['tail_ratio']:.2f} > "
                       f"{self.tail_hi:g}: bound rounds at {budget:g}s")

        # 2. policy too aggressive: back off before shrinking the cohort
        if obs["drop_rate"] > self.drop_hi:
            name, _, arg = current.policy.partition(":")
            if name == "deadline":
                return dataclasses.replace(
                    current, policy=f"deadline:{2 * float(arg):g}",
                    reason=f"drop rate {obs['drop_rate']:.2f} > "
                           f"{self.drop_hi:g}: loosen deadline")
            if name == "drop_slowest" and int(arg or 1) > 1:
                return dataclasses.replace(
                    current, policy=f"drop_slowest:{int(arg) - 1}",
                    reason=f"drop rate {obs['drop_rate']:.2f} > "
                           f"{self.drop_hi:g}: shed a drop slot")
            if current.cohort > self.min_cohort:
                return dataclasses.replace(
                    current, cohort=max(current.cohort // 2, self.min_cohort),
                    reason=f"drop rate {obs['drop_rate']:.2f} > "
                           f"{self.drop_hi:g}: shrink cohort")

        # 3. bytes budget: strengthen the codec first, then shed clients
        if self.bytes_budget_per_round is not None \
                and obs["bytes_per_round"] > self.bytes_budget_per_round:
            ladder = list(DOWNLINK_LADDER)
            if current.downlink in ladder \
                    and ladder.index(current.downlink) < len(ladder) - 1:
                nxt = ladder[ladder.index(current.downlink) + 1]
                return dataclasses.replace(
                    current, downlink=nxt,
                    reason=f"bytes/round {obs['bytes_per_round']:.3g} over "
                           f"budget: downlink -> {nxt}")
            if current.cohort > self.min_cohort:
                return dataclasses.replace(
                    current, cohort=max(current.cohort // 2, self.min_cohort),
                    reason=f"bytes/round {obs['bytes_per_round']:.3g} over "
                           f"budget: shrink cohort")

        # 4. healthy and improving: scale the cohort out
        if obs["loss_slope"] < self.plateau_slope \
                and obs["tail_ratio"] <= self.tail_hi \
                and obs["drop_rate"] <= self.drop_hi \
                and current.cohort < self.max_cohort:
            return dataclasses.replace(
                current, cohort=min(current.cohort * 2, self.max_cohort),
                reason=f"healthy (slope {obs['loss_slope']:.2g}): "
                       "grow cohort")

        # 5. plateaued: the marginal clients buy nothing
        if obs["loss_slope"] >= self.plateau_slope \
                and len(trace) >= self.window \
                and current.cohort > self.min_cohort:
            return dataclasses.replace(
                current, cohort=max(current.cohort // 2, self.min_cohort),
                reason=f"plateau (slope {obs['loss_slope']:.2g}): "
                       "shrink cohort")

        return dataclasses.replace(current, reason="steady")


def _segment_seed(seed: int, seg: int) -> int:
    """Segment ``seg``'s run seed: from ``SeedSequence([seed, seg])``, so
    neighbouring seeds and segments give unrelated batch streams."""
    return int(np.random.SeedSequence([seed, seg]).generate_state(1)[0])


def autoscale_run(make_trainer: Callable[[AutoscalePlan, int], Any],
                  plan: AutoscalePlan, rounds: int, seed: int, *,
                  controller: Optional[TraceAutoscaler] = None,
                  interval: int = 8) -> Dict[str, Any]:
    """Drive one training run in autoscaled segments.

    ``make_trainer(plan, segment_index)`` builds a `FederatedTrainer` for
    the plan (cohort/policy/downlink applied); every ``interval`` rounds
    the controller reads the segment's trace and recommends the next plan.
    The `TrainState` carries across segments (``FederatedTrainer.run``'s
    ``state=``), and so do the trainer's cross-round cut-layer caches
    (per-client warm-start codebooks / EF memories / the cohort-global
    slot) — they are keyed by client id, so a plan move must not reset a
    client's lineage any more than a cohort reshuffle does. This is ONE
    training run under a moving configuration.

    Returns a dict with the final ``state``, the stitched per-round
    ``history`` (each entry additionally carrying its segment's plan
    index), the per-segment ``plans``/``traces``, and byte totals the
    benchmark compares against static cells.
    """
    controller = controller or TraceAutoscaler(window=interval)
    state = None
    prev_trainer = None
    history: List[Dict] = []
    plans: List[AutoscalePlan] = [plan]
    traces: List[Trace] = []
    done = 0
    seg = 0
    while done < rounds:
        seg_rounds = min(interval, rounds - done)
        trainer = make_trainer(plan, seg)
        if prev_trainer is not None:
            # transplant the client-keyed cut-layer caches into the new
            # trainer (same model family across plans; cohort size and
            # policy do not change the per-client state layout)
            for attr in ("_client_q", "_seed_q", "_ef_memory",
                         "_global_q", "_global_q_nparts"):
                setattr(trainer, attr, getattr(prev_trainer, attr))
        state, hist = trainer.run(seg_rounds, _segment_seed(seed, seg),
                                  state=state)
        prev_trainer = trainer
        for h in hist:
            history.append(dict(h, plan=len(plans) - 1))
        traces.append(trainer.last_trace)
        done += seg_rounds
        seg += 1
        if done < rounds:
            nxt = controller.recommend(trainer.last_trace, plan)
            if nxt.moved_from(plan):
                plans.append(nxt)
                # plan moves are first-class events in the run's event log
                obs.event("autoscale.plan", cat="autoscale", segment=seg,
                          rounds_done=done, cohort=nxt.cohort,
                          policy=nxt.policy,
                          downlink=nxt.downlink or "model-default",
                          reason=nxt.reason)
            plan = nxt
    return {
        "state": state,
        "history": history,
        "plans": plans,
        "traces": traces,
        "uplink_bytes": sum(t.total_uplink_bytes for t in traces),
        "downlink_bytes": sum(t.total_downlink_bytes for t in traces),
        "simulated_seconds": sum(t.simulated_seconds for t in traces),
    }

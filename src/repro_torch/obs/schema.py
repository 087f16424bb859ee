"""Obs event schema registry (twin of ``repro/obs/schema.py``; the same
names).

Every structured event name the codebase emits (``obs.event(name, ...)``
or a raw ``{"type": "event", "name": ...}`` append) is declared here with
its category and the argument keys consumers may rely on. The registry
is the contract between emitters and the tooling that reads runs — the
inspector CLI, the Perfetto exporter, the SLO monitors — and fedlint's
``orphan-obs-event`` pass enforces that the federated layer only emits
registered names, so a renamed or ad-hoc event can't silently orphan a
dashboard.

Arg lists are documentation of the stable surface, not an exhaustive
closed set: emitters may add keys, but the listed ones must keep their
meaning. Span names are not registered — spans are free-form timing
scopes; events are the queryable records.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["EVENT_SCHEMAS", "is_registered_event"]

# name -> (category, stable arg keys, one-line meaning)
EVENT_SCHEMAS: Dict[str, Tuple[str, Tuple[str, ...], str]] = {
    # -- run lifecycle (emitted by the recorder itself) --
    "run_start": ("run", (), "recorder configured; start of a run log"),
    # -- scheduler --
    "policy.cut": (
        "scheduler", ("round", "cut", "policy"),
        "straggler policy cut N arrivals this round"),
    "fault.round": (
        "faults", ("round", "crashes", "retries", "crash_dropped",
                   "edges_down", "rehomed"),
        "per-round sync fault counters from the injector"),
    "fault.flush": (
        "faults", ("round", "crashes", "retries", "crash_dropped",
                   "jittered"),
        "per-flush async fault counters from the injector"),
    # -- runtime / recovery --
    "fault.round_voided": (
        "faults", ("round", "quarantined", "cohort"),
        "server screen left the round below quorum; update voided"),
    "fault.server_restart": (
        "faults", ("round", "restarts"),
        "ServerKilled absorbed; runtime restored from snapshot"),
    # -- autoscaler --
    "autoscale.plan": (
        "autoscale", ("segment", "rounds_done", "cohort", "policy",
                      "downlink", "reason"),
        "trace-driven autoscaler chose the next segment's knobs"),
    # -- trace summary (log_trace) --
    "round": (
        "trace", ("round", "t_start", "t_end", "participants", "dropped",
                  "uplink_bytes", "downlink_bytes"),
        "one RoundRecord summarized into the event log"),
    "run": (
        "trace", ("rounds", "sim_seconds", "uplink_bytes",
                  "downlink_bytes"),
        "whole-run trace summary"),
    # -- flight recorder (repro_torch.obs.flight) --
    "flight.rollup": (
        "flights", ("round", "kind", "flights", "states", "retries",
                    "retry_downlinks", "rehomed"),
        "per-update flight histogram: state counts + per-edge rollups"),
    "flight.sampled": (
        "flights", ("flight_id", "client", "round", "seq", "kind"),
        "exemplar flight entered the cohort"),
    "flight.placed": (
        "flights", ("flight_id", "client", "round", "edge", "shard",
                    "rehomed"),
        "exemplar flight's edge/executor-shard placement"),
    "flight.quarantined": (
        "flights", ("flight_id", "client", "round", "state"),
        "exemplar flight screened out (or voided) server-side"),
    "flight.outcome": (
        "flights", ("flight_id", "client", "round", "state"),
        "exemplar flight's terminal state"),
    # -- SLO monitors (repro_torch.obs.slo) --
    "slo_violation": (
        "slo", ("rule", "signal", "op", "threshold", "value", "window"),
        "a declarative SLO rule failed on the run's trace reductions"),
}


def is_registered_event(name: str) -> bool:
    return name in EVENT_SCHEMAS

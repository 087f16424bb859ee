"""Run-wide telemetry: spans, sync-free metrics, exporters, flight frames,
SLO health and the run inspector (twin of ``repro/obs``).

  spans.py   — `span`/`virtual_span`/`event`/`instrument` record host
               wall-clock and the scheduler's simulated clock as parallel
               lanes into a module-level `Recorder` (`configure` installs
               one; everything is a no-op otherwise, and while
               ``torch.compile`` traces).
  metrics.py — `MetricsBuffer` plus the ``counter``/``gauge``/``histogram``
               helpers: metrics stay device tensors through the run and
               the whole run flushes with ONE device→host transfer.
  export.py  — append-only JSONL event logs and Chrome/Perfetto
               ``trace_event`` JSON.
  flight.py  — the contribution flight recorder (`FlightFrame` per server
               update on ``Trace.flights``).
  slo.py     — declarative windowed SLO rules over trace reductions;
               `FederatedTrainer(slo_monitor=HealthMonitor())` grades every
               run and violations become ``slo_violation`` events.
  inspect.py — ``python -m repro_torch.obs <run.jsonl>``: round tables,
               percentiles, the byte ledger, ``--faults``, ``--health``
               (SLO grading, plus ``--slo`` specs) and ``--flight``; the
               reference's report, character for character.
  schema.py  — the obs event-name registry (`EVENT_SCHEMAS`).

Typical wiring:

    from repro_torch import obs
    obs.configure(run="bench", meta={"fleet": "lognormal"})
    ...  # run training; Scheduler/executor/wire spans record themselves
    rec = obs.shutdown()
    rec.write_jsonl("run.jsonl")
    rec.write_perfetto("run.perfetto.json")
"""

from repro_torch.obs.export import (
    jsonable,
    read_jsonl,
    read_jsonl_tolerant,
    to_perfetto,
    write_jsonl,
    write_perfetto,
)
from repro_torch.obs.flight import (
    FlightFrame,
    flights_enabled,
    log_frames,
    set_flights,
)
from repro_torch.obs.metrics import MetricsBuffer, counter, gauge, histogram
from repro_torch.obs.schema import EVENT_SCHEMAS, is_registered_event
from repro_torch.obs.slo import (
    DEFAULT_SLOS,
    HealthMonitor,
    SloResult,
    SloRule,
    parse_rule,
    signals_from_rows,
    trace_signals,
)
from repro_torch.obs.spans import (
    Recorder,
    configure,
    current,
    enabled,
    event,
    instrument,
    shutdown,
    span,
    virtual_span,
)


def log_trace(trace, run=None) -> None:
    """Append a finished `repro_torch.federated.Trace` to the event log.

    Each `RoundRecord` becomes a ``type: "round"`` event on the virtual
    lane carrying participants, per-direction bytes, the wire-kind ledger
    and the round's (already host-side) metrics; the run's meta + summary
    close it out as a ``type: "run"`` event. Duck-typed on the record
    fields so this package never imports the federated layer."""
    rec = current()
    if rec is None:
        return
    for r in trace:
        rec.append({
            "type": "round", "lane": "virtual", "cat": "rounds",
            "name": f"round {r.round}",
            "t0": float(r.t_start), "t1": float(r.t_end),
            "args": {"round": r.round,
                     "participants": len(r.participants),
                     "dropped": len(r.dropped),
                     "uplink_bytes": r.uplink_bytes,
                     "downlink_bytes": r.downlink_bytes,
                     "staleness": list(r.staleness),
                     "ledger": dict(r.ledger),
                     "faults": dict(getattr(r, "faults", {}) or {}),
                     "metrics": dict(r.metrics)}})
    # the contribution flight layer: per-update rollup histograms plus
    # reservoir-sampled exemplar lifecycles (called after the runtime has
    # applied screening verdicts, so exemplars carry final states)
    frames = getattr(trace, "flights", None)
    if frames:
        log_frames(rec, frames)
    rec.append({"type": "run", "lane": "host", "cat": "obs",
                "name": run or rec.run, "t": rec.now(),
                "args": {"meta": jsonable(dict(trace.meta)),
                         "summary": jsonable(trace.summary())}})


__all__ = [
    "DEFAULT_SLOS", "EVENT_SCHEMAS", "FlightFrame", "HealthMonitor",
    "MetricsBuffer", "Recorder", "SloResult", "SloRule", "configure",
    "counter", "current", "enabled", "event", "flights_enabled", "gauge",
    "histogram", "instrument", "is_registered_event", "jsonable",
    "log_frames", "log_trace", "parse_rule", "read_jsonl",
    "read_jsonl_tolerant", "set_flights", "shutdown", "signals_from_rows",
    "span", "to_perfetto", "trace_signals", "virtual_span", "write_jsonl",
    "write_perfetto",
]

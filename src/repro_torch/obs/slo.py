"""Declarative SLO health monitors over trace reductions (twin of
``repro/obs/slo.py``).

A `SloRule` names a windowed signal (round-duration percentiles, drop
rate, quarantine rate, retry-byte overhead, per-tier bytes budgets...),
a comparison, and a threshold. `HealthMonitor.check(trace)` evaluates a
rule set against a finished `repro_torch.federated.Trace` (duck-typed — this
package never imports the federated layer), emits one structured
``slo_violation`` obs event per failing rule, and returns the full
result list; `FederatedTrainer(slo_monitor=...)` runs it automatically
at end of run, and the same signal set feeds `TraceAutoscaler.observe`.

The inspector consumes the second entry point: `signals_from_rows`
rebuilds the signal dict from a run log's ``type: "round"`` rows, so
``python -m repro_torch.obs <run.jsonl> --health`` grades a *recorded* run
with the identical rules — including ad-hoc ones parsed from
``--slo "drop_rate<=0.3"`` specs.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.spans import event as _obs_event

__all__ = ["SloRule", "SloResult", "HealthMonitor", "DEFAULT_SLOS",
           "parse_rule", "trace_signals", "signals_from_rows"]

#: signal names `trace_signals` / `signals_from_rows` always populate
SIGNALS = (
    "rounds", "round_duration_p50_s", "round_duration_p99_s", "tail_ratio",
    "drop_rate", "quarantine_rate", "retry_byte_overhead",
    "corrupt_undetected", "uplink_bytes_per_round",
    "downlink_bytes_per_round", "edge_uplink_bytes_per_round",
    "server_uplink_bytes_per_round",
)


@dataclasses.dataclass(frozen=True)
class SloRule:
    """``signal op threshold`` over the last ``window`` updates (all
    when None). ``op`` is "<=" (budget) or ">=" (floor)."""
    name: str
    signal: str
    op: str = "<="
    threshold: float = 0.0
    window: Optional[int] = None

    def ok(self, value: float) -> bool:
        if self.op == "<=":
            return value <= self.threshold
        if self.op == ">=":
            return value >= self.threshold
        raise ValueError(f"unknown SLO op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class SloResult:
    rule: SloRule
    value: Optional[float]   # None = signal not measurable on this run
    ok: bool

    def describe(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        val = "n/a" if self.value is None else f"{self.value:.6g}"
        win = f" (last {self.rule.window})" if self.rule.window else ""
        return (f"{status}  {self.rule.name}: {self.rule.signal}={val} "
                f"{self.rule.op} {self.rule.threshold:g}{win}")


# permissive run-health defaults: generous enough that a healthy chaos
# run passes, tight enough that a pathological one (storm-level drop /
# quarantine, runaway retry bytes) trips
DEFAULT_SLOS = (
    SloRule("straggler-tail", "tail_ratio", "<=", 3.0),
    SloRule("drop-rate", "drop_rate", "<=", 0.5),
    SloRule("quarantine-rate", "quarantine_rate", "<=", 0.25),
    SloRule("retry-byte-overhead", "retry_byte_overhead", "<=", 0.5),
    SloRule("corruption-detected", "corrupt_undetected", "<=", 0.0),
)

_RULE_RE = re.compile(
    r"^\s*([A-Za-z0-9_.]+)\s*(<=|>=)\s*([-+0-9.eE]+)"
    r"(?:\s*@\s*(\d+))?\s*$")


def parse_rule(spec: str) -> SloRule:
    """Parse ``"signal<=threshold"`` / ``"signal>=threshold@window"``
    (the ``--slo`` CLI syntax) into a rule named after the spec."""
    m = _RULE_RE.match(spec)
    if m is None:
        raise ValueError(
            f"bad SLO spec {spec!r}; expected e.g. 'drop_rate<=0.3' or "
            f"'rounds>=5@20'")
    sig, op, thr, win = m.groups()
    return SloRule(name=spec.strip(), signal=sig, op=op,
                   threshold=float(thr),
                   window=int(win) if win else None)


def _fault_ledger_signals(recs, sig: Dict[str, float]) -> None:
    participants = sum(len(r.participants) for r in recs)
    quarantined = sum(r.faults.get("quarantined", 0) for r in recs)
    sig["quarantine_rate"] = \
        quarantined / participants if participants else 0.0
    sig["corrupt_undetected"] = float(
        sum(r.faults.get("corrupt_undetected", 0) for r in recs))
    retry = sum(v for r in recs for k, v in r.ledger.items()
                if k.startswith("retry_downlink/"))
    down = sum(v for r in recs for k, v in r.ledger.items()
               if k.startswith("downlink/"))
    sig["retry_byte_overhead"] = retry / down if down else 0.0


def trace_signals(trace, window: Optional[int] = None) -> Dict[str, float]:
    """The SLO signal dict from a live `Trace` (duck-typed reductions)."""
    recs = list(trace.window(window))
    sig: Dict[str, float] = {
        "rounds": float(len(recs)),
        "round_duration_p50_s": trace.duration_percentile(50.0, window),
        "round_duration_p99_s": trace.duration_percentile(99.0, window),
        "tail_ratio": trace.tail_ratio(window),
        "drop_rate": trace.drop_rate(window),
        "uplink_bytes_per_round": trace.bytes_per_round(window, "uplink"),
        "downlink_bytes_per_round":
            trace.bytes_per_round(window, "downlink"),
        "edge_uplink_bytes_per_round":
            trace.tier_bytes_per_round("edge_uplink", window),
        "server_uplink_bytes_per_round":
            trace.tier_bytes_per_round("server_uplink", window),
    }
    _fault_ledger_signals(recs, sig)
    return sig


def _percentile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    pos = (len(xs) - 1) * min(max(q, 0.0), 100.0) / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def signals_from_rows(rows: Sequence[Dict[str, Any]],
                      window: Optional[int] = None) -> Dict[str, float]:
    """The same signal dict rebuilt from a run log's ``type: "round"``
    events (`repro_torch.obs.inspect` row dicts) — the offline --health path."""
    rows = list(rows)[-window:] if window else list(rows)
    durs = [float(r["t_end"]) - float(r["t_start"]) for r in rows]
    n = len(rows) or 1
    p50 = _percentile(durs, 50.0)
    participants = sum(int(r.get("participants", 0)) for r in rows)
    dropped = sum(int(r.get("dropped", 0)) for r in rows)
    quarantined = sum(int((r.get("faults") or {}).get("quarantined", 0))
                      for r in rows)
    retry = sum(v for r in rows
                for k, v in (r.get("ledger") or {}).items()
                if k.startswith("retry_downlink/"))
    down = sum(v for r in rows
               for k, v in (r.get("ledger") or {}).items()
               if k.startswith("downlink/"))

    def tier(prefix: str) -> float:
        total = sum(v for r in rows
                    for k, v in (r.get("ledger") or {}).items()
                    if k.startswith(prefix + "/"))
        return total / n

    return {
        "rounds": float(len(rows)),
        "round_duration_p50_s": p50,
        "round_duration_p99_s": _percentile(durs, 99.0),
        "tail_ratio": _percentile(durs, 95.0) / p50 if p50 > 0 else 1.0,
        "drop_rate": dropped / (dropped + participants)
        if dropped + participants else 0.0,
        "quarantine_rate":
            quarantined / participants if participants else 0.0,
        "corrupt_undetected": float(
            sum(int((r.get("faults") or {}).get("corrupt_undetected", 0))
                for r in rows)),
        "retry_byte_overhead": retry / down if down else 0.0,
        "uplink_bytes_per_round":
            sum(int(r.get("uplink_bytes", 0)) for r in rows) / n,
        "downlink_bytes_per_round":
            sum(int(r.get("downlink_bytes", 0)) for r in rows) / n,
        "edge_uplink_bytes_per_round": tier("edge_uplink"),
        "server_uplink_bytes_per_round": tier("server_uplink"),
    }


class HealthMonitor:
    """Evaluate a rule set; `check` additionally emits ``slo_violation``
    obs events so failures land in the run's own event log."""

    def __init__(self, rules: Sequence[SloRule] = DEFAULT_SLOS):
        self.rules = tuple(rules)

    def _evaluate(self, signal_fn) -> List[SloResult]:
        by_window: Dict[Optional[int], Dict[str, float]] = {}
        out: List[SloResult] = []
        for rule in self.rules:
            if rule.window not in by_window:
                by_window[rule.window] = signal_fn(rule.window)
            sig = by_window[rule.window]
            value = sig.get(rule.signal)
            if value is None:
                # unknown/unmeasurable signal: not a violation, but
                # visible as value=n/a in the report
                out.append(SloResult(rule, None, True))
            else:
                out.append(SloResult(rule, float(value),
                                     rule.ok(float(value))))
        return out

    def evaluate(self, trace) -> List[SloResult]:
        return self._evaluate(lambda w: trace_signals(trace, w))

    def evaluate_rows(self, rows: Sequence[Dict[str, Any]],
                      ) -> List[SloResult]:
        return self._evaluate(lambda w: signals_from_rows(rows, w))

    def check(self, trace) -> List[SloResult]:
        results = self.evaluate(trace)
        for res in results:
            if not res.ok:
                _obs_event("slo_violation", cat="slo",
                           rule=res.rule.name, signal=res.rule.signal,
                           op=res.rule.op, threshold=res.rule.threshold,
                           value=res.value, window=res.rule.window)
        return results

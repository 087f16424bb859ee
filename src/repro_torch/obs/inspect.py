"""The run inspector behind ``python -m repro_torch.obs <run.jsonl>`` (twin
of ``repro/obs/inspect.py``: the same report, character for character, for
the same log).

Consumes a JSONL event log written by `Recorder.write_jsonl` and prints:

  * the run header (meta + end-of-run summary events),
  * a round table (virtual start/end, participants, dropped, bytes, loss),
  * round-duration percentiles (p50/p90/p99 + tail ratio) on the virtual
    lane and span-duration percentiles per (lane, name) for the host lane,
  * the per-direction, per-wire-kind byte ledger totals,
  * bytes/time-to-target when ``--target`` is given (or a target loss is
    found in the run summary),
  * fault-injection totals when the run carried a `FaultPlan`.

``--json`` emits the same summary as one JSON document for scripting;
``--faults`` prints the per-round fault table (crashes, retries,
quarantines, voided rounds) instead of the full report; ``--health``
grades the run against the SLO rule set (plus any ``--slo`` specs);
``--flight <client-or-id>`` reconstructs a recorded contribution
flight's full lifecycle from its exemplar events.

Logs are read tolerantly: a run killed mid-write leaves a truncated
final line, which is reported as a warning while everything parseable
still renders.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs import slo as slo_mod
from repro_torch.obs.export import read_jsonl_tolerant


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile; q in [0, 100]; 0.0 on empty."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    q = min(max(float(q), 0.0), 100.0)
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def _span_stats(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    groups: Dict[tuple, List[float]] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        key = (ev.get("lane", "host"), ev.get("name", "?"))
        groups.setdefault(key, []).append(
            float(ev["t1"]) - float(ev["t0"]))
    rows = []
    for (lane, name), durs in sorted(groups.items()):
        rows.append({"lane": lane, "name": name, "count": len(durs),
                     "total_s": sum(durs),
                     "p50_s": percentile(durs, 50),
                     "p99_s": percentile(durs, 99)})
    rows.sort(key=lambda r: (r["lane"], -r["total_s"]))
    return rows


def _round_rows(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    rows = []
    for ev in events:
        if ev.get("type") != "round":
            continue
        args = ev.get("args", {})
        rows.append({"round": args.get("round", len(rows)),
                     "t_start": float(ev.get("t0", 0.0)),
                     "t_end": float(ev.get("t1", 0.0)),
                     "participants": args.get("participants", 0),
                     "dropped": args.get("dropped", 0),
                     "uplink_bytes": args.get("uplink_bytes", 0),
                     "downlink_bytes": args.get("downlink_bytes", 0),
                     "ledger": args.get("ledger", {}) or {},
                     "faults": args.get("faults", {}) or {},
                     "loss": (args.get("metrics", {}) or {}).get("loss")})
    return rows


def summarize(events: List[Dict[str, Any]],
              target: Optional[float] = None,
              metric: str = "loss") -> Dict[str, Any]:
    """Reduce an event log to the inspector's summary document."""
    rounds = _round_rows(events)
    durations = [r["t_end"] - r["t_start"] for r in rounds]
    ledger: Dict[str, float] = {}
    fault_totals: Dict[str, int] = {}
    for r in rounds:
        for k, v in r["ledger"].items():
            ledger[k] = ledger.get(k, 0) + v
        for k, v in r["faults"].items():
            fault_totals[k] = fault_totals.get(k, 0) + int(v)

    runs = [ev for ev in events if ev.get("type") == "run"]
    meta = [ev for ev in events if ev.get("type") == "meta"]
    p50 = percentile(durations, 50)
    summary: Dict[str, Any] = {
        "events": len(events),
        "runs": [ev.get("args", {}).get("meta", {}) for ev in runs],
        "run_meta": (meta[0].get("args", {}) if meta else {}),
        "rounds": rounds,
        "round_duration_p50_s": p50,
        "round_duration_p90_s": percentile(durations, 90),
        "round_duration_p99_s": percentile(durations, 99),
        "tail_ratio": (percentile(durations, 99) / p50) if p50 > 0 else 1.0,
        "simulated_seconds": (rounds[-1]["t_end"] if rounds else 0.0),
        "uplink_bytes": sum(r["uplink_bytes"] for r in rounds),
        "downlink_bytes": sum(r["downlink_bytes"] for r in rounds),
        "ledger": ledger,
        "fault_totals": fault_totals,
        "spans": _span_stats(events),
    }

    if target is None:  # fall back to a target recorded in the run summary
        for ev in runs:
            t = (ev.get("args", {}).get("summary", {}) or {}).get("target")
            if isinstance(t, (int, float)):
                target = float(t)
                break
    if target is not None:
        summary["target"] = {"metric": metric, "value": target}
        up = down = 0
        t_hit = bytes_hit = round_hit = None
        for r in rounds:
            up += r["uplink_bytes"]
            down += r["downlink_bytes"]
            value = r.get(metric) if metric != "loss" else r["loss"]
            if value is not None and value <= target:
                t_hit, bytes_hit, round_hit = r["t_end"], up + down, r["round"]
                break
        summary["target"].update({"reached_round": round_hit,
                                  "time_to_target_s": t_hit,
                                  "bytes_to_target": bytes_hit})
    return summary


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n):,} B"
        n /= 1024.0
    return f"{n:,.1f} GiB"  # pragma: no cover - unreachable


def format_faults(summary: Dict[str, Any], max_rows: int = 12) -> str:
    """Render the per-round fault table (``--faults``).

    Rows are only printed for rounds that recorded at least one fault
    counter (crashes, retries, quarantines, voids, ...); a run with no
    `FaultPlan` armed renders as a single "no fault events" line."""
    lines: List[str] = []
    faulted = [r for r in summary["rounds"] if r["faults"]]
    totals = summary.get("fault_totals", {})
    if not faulted:
        lines.append("faults: no fault events recorded")
        return "\n".join(lines)
    cols = sorted({k for r in faulted for k in r["faults"]})
    lines.append("faults (per round, zero-fault rounds omitted):")
    header = f"{'round':>5}" + "".join(f" {c:>18}" for c in cols)
    lines.append(header)
    shown = faulted if len(faulted) <= max_rows else faulted[:max_rows]
    for r in shown:
        row = f"{r['round']:>5}"
        row += "".join(f" {r['faults'].get(c, 0):>18}" for c in cols)
        lines.append(row)
    if len(faulted) > max_rows:
        lines.append(f"  ... {len(faulted) - max_rows} more faulted rounds")
    lines.append("totals: " + ", ".join(f"{k}={v}"
                                        for k, v in sorted(totals.items())))
    return "\n".join(lines)


def format_report(summary: Dict[str, Any], max_rows: int = 12) -> str:
    """Render the summary document as the human-readable report."""
    lines: List[str] = []
    run_meta = summary.get("run_meta", {})
    lines.append(f"run: {run_meta.get('run', '?')}  "
                 f"events: {summary['events']}  "
                 f"rounds: {len(summary['rounds'])}")
    extras = {k: v for k, v in run_meta.items() if k != "run"}
    if extras:
        lines.append("meta: " + ", ".join(f"{k}={v}"
                                          for k, v in sorted(extras.items())))

    rounds = summary["rounds"]
    if rounds:
        lines.append("")
        lines.append(f"{'round':>5} {'t_start':>9} {'t_end':>9} "
                     f"{'parts':>5} {'drop':>4} {'uplink':>12} "
                     f"{'downlink':>12} {'loss':>9}")
        shown = rounds if len(rounds) <= max_rows else rounds[:max_rows]
        for r in shown:
            loss = f"{r['loss']:.4f}" if r["loss"] is not None else "-"
            lines.append(f"{r['round']:>5} {r['t_start']:>9.2f} "
                         f"{r['t_end']:>9.2f} {r['participants']:>5} "
                         f"{r['dropped']:>4} "
                         f"{_fmt_bytes(r['uplink_bytes']):>12} "
                         f"{_fmt_bytes(r['downlink_bytes']):>12} {loss:>9}")
        if len(rounds) > max_rows:
            lines.append(f"  ... {len(rounds) - max_rows} more rounds")
        lines.append("")
        lines.append(
            f"virtual round duration  p50={summary['round_duration_p50_s']:.2f}s"
            f"  p90={summary['round_duration_p90_s']:.2f}s"
            f"  p99={summary['round_duration_p99_s']:.2f}s"
            f"  tail_ratio={summary['tail_ratio']:.2f}")
        lines.append(
            f"simulated {summary['simulated_seconds']:.1f}s   "
            f"uplink {_fmt_bytes(summary['uplink_bytes'])}   "
            f"downlink {_fmt_bytes(summary['downlink_bytes'])}")

    if summary["ledger"]:
        lines.append("")
        lines.append("byte ledger (direction/wire-kind):")
        for k, v in sorted(summary["ledger"].items()):
            lines.append(f"  {k:<24} {_fmt_bytes(v):>14}")

    if summary.get("fault_totals"):
        lines.append("")
        lines.append("fault totals: " +
                     ", ".join(f"{k}={v}" for k, v in
                               sorted(summary["fault_totals"].items())))

    target = summary.get("target")
    if target:
        lines.append("")
        if target.get("reached_round") is not None:
            lines.append(
                f"target {target['metric']} <= {target['value']}: reached at "
                f"round {target['reached_round']} "
                f"(t={target['time_to_target_s']:.1f}s, "
                f"{_fmt_bytes(target['bytes_to_target'])} on the wire)")
        else:
            lines.append(f"target {target['metric']} <= {target['value']}: "
                         "not reached")

    spans = summary["spans"]
    if spans:
        lines.append("")
        lines.append("spans (by total time within lane):")
        lines.append(f"  {'lane':<8} {'name':<28} {'count':>6} "
                     f"{'total':>10} {'p50':>10} {'p99':>10}")
        for row in spans[:max_rows]:
            lines.append(f"  {row['lane']:<8} {row['name']:<28} "
                         f"{row['count']:>6} {row['total_s']:>9.3f}s "
                         f"{row['p50_s'] * 1e3:>8.2f}ms "
                         f"{row['p99_s'] * 1e3:>8.2f}ms")
        if len(spans) > max_rows:
            lines.append(f"  ... {len(spans) - max_rows} more span groups")
    return "\n".join(lines)


def format_health(results: List["slo_mod.SloResult"]) -> str:
    """Render SLO results (``--health``) as a pass/fail report."""
    lines = ["SLO health:"]
    for res in results:
        lines.append("  " + res.describe())
    failed = [r for r in results if not r.ok]
    if failed:
        lines.append(f"health: FAIL ({len(failed)}/{len(results)} rules "
                     "violated)")
    else:
        lines.append(f"health: PASS ({len(results)} rules)")
    return "\n".join(lines)


def _flight_groups(events: List[Dict[str, Any]],
                   ) -> Dict[str, List[Dict[str, Any]]]:
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        if ev.get("cat") != "flights":
            continue
        fid = (ev.get("args") or {}).get("flight_id")
        if fid is not None:
            groups.setdefault(str(fid), []).append(ev)
    return groups


def _flight_line(ev: Dict[str, Any]) -> str:
    a = ev.get("args") or {}
    name = ev.get("name", "?")
    if "t0" in ev:
        when = f"{float(ev['t0']):>9.2f}s –{float(ev['t1']):>8.2f}s"
    else:
        when = f"{float(ev.get('t', 0.0)):>9.2f}s" + " " * 10
    if name == "flight.sampled":
        what = f"sampled into the cohort ({a.get('kind', '?')} wave, " \
               f"seq {a.get('seq', '?')})"
    elif name == "flight.placed":
        edge = a.get("edge", -1)
        where = f"edge {edge}" if edge != -1 else "server (flat star)"
        shard = a.get("shard", -1)
        if shard != -1:
            where += f", executor shard {shard}"
        what = f"placed on {where}"
        if a.get("rehomed"):
            what += "  [re-homed: nearest edge was down]"
    elif name == "flight.uplink":
        what = "uplink in flight"
    elif name == "flight.retry":
        what = (f"crash retries x{a.get('retries', '?')} "
                f"({a.get('retry_downlinks', 0)} extra model downlinks)")
    elif name == "flight.quarantined":
        what = f"server screen: {a.get('state', 'quarantined')}"
    elif name == "flight.outcome":
        what = f"outcome: {a.get('state', '?')}"
    elif name == "flight.server":
        return (f"{when}  server aggregate step "
                "(host lane; linked by Perfetto flow)")
    else:
        what = name
    return f"{when}  {what}"


def format_flight(events: List[Dict[str, Any]], query: str,
                  max_flights: int = 4) -> "tuple[str, bool]":
    """Reconstruct recorded flight lifecycles (``--flight``).

    ``query`` is a flight id (``r3-c17-s5``) or a bare client id (every
    exemplar flight of that client renders, capped). Returns
    ``(report, found)`` — only reservoir-sampled exemplars carry full
    lifecycles, so a miss lists what IS available."""
    groups = _flight_groups(events)
    sel: Dict[str, List[Dict[str, Any]]] = {}
    if query in groups:
        sel = {query: groups[query]}
    else:
        try:
            cid = int(query)
        except ValueError:
            cid = None
        if cid is not None:
            sel = {fid: evs for fid, evs in groups.items()
                   if any((e.get("args") or {}).get("client") == cid
                          for e in evs)}
    if not sel:
        lines = [f"no recorded flight matches {query!r}."]
        if groups:
            known = sorted(groups)
            shown = ", ".join(known[:12])
            more = f" (+{len(known) - 12} more)" if len(known) > 12 else ""
            lines.append(f"recorded exemplar flights: {shown}{more}")
            lines.append("(only reservoir-sampled exemplars carry full "
                         "lifecycles; rollup histograms cover the rest)")
        else:
            lines.append("this log carries no flight events — record with "
                         "flight recording enabled (the default) and "
                         "obs.log_trace.")
        return "\n".join(lines), False

    lines = []
    for fid in sorted(sel)[:max_flights]:
        evs = sorted(sel[fid],
                     key=lambda e: (float(e.get("t0", e.get("t", 0.0))),
                                    e.get("name", "")))
        head = next((e for e in evs if e.get("name") == "flight.sampled"),
                    evs[0])
        a = head.get("args") or {}
        lines.append(f"flight {fid}  (client {a.get('client', '?')}, "
                     f"update {a.get('round', '?')})")
        for ev in evs:
            lines.append("  " + _flight_line(ev))
        lines.append("")
    if len(sel) > max_flights:
        lines.append(f"... {len(sel) - max_flights} more matching flights")
    return "\n".join(lines).rstrip(), True


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize a telemetry JSONL log written with "
                    "--emit-trace (round tables, percentiles, byte ledger, "
                    "bytes/time-to-target).")
    ap.add_argument("path", help="JSONL event log (Recorder.write_jsonl)")
    ap.add_argument("--target", type=float, default=None,
                    help="metric threshold for time/bytes-to-target")
    ap.add_argument("--metric", default="loss",
                    help="round metric the target applies to (default: loss)")
    ap.add_argument("--rows", type=int, default=12,
                    help="max table rows to print (default: 12)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a report")
    ap.add_argument("--faults", action="store_true",
                    help="print the per-round fault-injection table "
                         "(crashes, retries, quarantines, voids) instead "
                         "of the full report")
    ap.add_argument("--health", action="store_true",
                    help="grade the run against the SLO rule set and "
                         "print pass/fail per rule")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="SIGNAL<=THRESH[@WINDOW]",
                    help="additional SLO rule (repeatable), e.g. "
                         "'drop_rate<=0.3' or 'tail_ratio<=2.5@20'; "
                         "implies --health")
    ap.add_argument("--flight", default=None, metavar="CLIENT-OR-ID",
                    help="reconstruct a recorded contribution flight's "
                         "lifecycle (flight id like r3-c17-s5, or a "
                         "client id)")
    args = ap.parse_args(argv)

    try:
        events, skipped = read_jsonl_tolerant(args.path)
    except OSError as exc:
        print(f"error: cannot read {args.path}: {exc}", file=sys.stderr)
        return 2
    if skipped:
        print(f"warning: {args.path}: skipped {skipped} unparseable "
              f"line{'s' if skipped != 1 else ''} (truncated/partial "
              "write); rendering the rest", file=sys.stderr)
    if not events:
        print(f"error: {args.path}: no parseable events", file=sys.stderr)
        return 2
    try:
        if args.flight is not None:
            report, found = format_flight(events, args.flight,
                                          max_flights=max(args.rows // 3, 1))
            print(report)
            return 0 if found else 1
        if args.health or args.slo:
            try:
                rules = list(slo_mod.DEFAULT_SLOS) \
                    + [slo_mod.parse_rule(s) for s in args.slo]
            except ValueError as exc:
                print(f"error: {exc}", file=sys.stderr)
                return 2
            results = slo_mod.HealthMonitor(rules).evaluate_rows(
                _round_rows(events))
            print(format_health(results))
            # grading a recorded run is a report, not a gate: exit 0
            # either way so CI artifact generation never flips red here
            return 0
        summary = summarize(events, target=args.target, metric=args.metric)
        if args.json:
            print(json.dumps(summary, sort_keys=True))
        elif args.faults:
            print(format_faults(summary, max_rows=args.rows))
        else:
            print(format_report(summary, max_rows=args.rows))
    except BrokenPipeError:   # e.g. `... | head`; the report is best-effort
        return 0
    return 0

"""Exporters: append-only JSONL event logs and Chrome/Perfetto traces.

Twin of ``repro/obs/export.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.obs`` imports jax.

Both exporters consume the plain-dict event schema documented in
``spans.py``. The JSONL log is the durable artifact (one JSON object per
line, append-only, streamable); the Perfetto export is a view of the same
events as Chrome ``trace_event`` JSON, loadable at https://ui.perfetto.dev
or chrome://tracing.

The two time lanes map to two Perfetto "processes":

  pid 1 — "host wall-clock"        (process wall time, seconds from epoch)
  pid 2 — "scheduler virtual-clock" (simulated fleet time)

within which each span category gets its own named thread row, so
scheduler rounds, executor phases, wire encode/decode and round records
render as separate, aligned tracks.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterable, List

_HOST_PID = 1
_VIRTUAL_PID = 2
_LANE_NAMES = {_HOST_PID: "host wall-clock",
               _VIRTUAL_PID: "scheduler virtual-clock"}


def jsonable(value: Any) -> Any:
    """Best-effort conversion of an event payload to JSON-able builtins.

    Handles numpy/torch scalars and arrays (via ``item``/``tolist``), tuples,
    sets and nested containers; anything else falls back to ``str``."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in value]
    if hasattr(value, "ndim") and hasattr(value, "tolist"):
        return value.item() if value.ndim == 0 else value.tolist()
    if hasattr(value, "item"):  # numpy generic scalars
        return value.item()
    return str(value)


def write_jsonl(events: Iterable[Dict[str, Any]], path,
                append: bool = False) -> int:
    """Write events as JSON Lines; returns the number of lines written."""
    path = Path(path)
    mode = "a" if append else "w"
    n = 0
    with path.open(mode, encoding="utf-8") as fh:
        for ev in events:
            fh.write(json.dumps(jsonable(ev), sort_keys=True))
            fh.write("\n")
            n += 1
    return n


def read_jsonl(path) -> List[Dict[str, Any]]:
    """Read a JSONL event log back into a list of event dicts."""
    events = []
    with Path(path).open("r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def read_jsonl_tolerant(path) -> "tuple[List[Dict[str, Any]], int]":
    """Read a JSONL event log, skipping unparseable lines.

    A run killed mid-write leaves a truncated final line (or, with
    interleaved writers, the odd garbled one); the strict reader raises
    and the inspector showed nothing. This variant returns
    ``(events, skipped)`` — everything parseable plus how many lines were
    dropped, so callers can render the run with a clear warning instead
    of dying on the artifact that most needs inspecting."""
    events: List[Dict[str, Any]] = []
    skipped = 0
    with Path(path).open("r", encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if isinstance(ev, dict):
                events.append(ev)
            else:
                skipped += 1
    return events, skipped


def _pid(ev: Dict[str, Any]) -> int:
    return _VIRTUAL_PID if ev.get("lane") == "virtual" else _HOST_PID


def to_perfetto(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Render events as a Chrome ``trace_event`` JSON document.

    Spans (and round records) become complete "X" events with microsecond
    ts/dur; instants become "i" events; each (lane, category) pair gets a
    named thread row via "M" metadata.

    Spans whose args carry a ``flight_id`` (the contribution flight
    recorder's exemplar lifecycles, `repro.obs.flight`) are additionally
    chained with flow events ("s"/"t"/"f" keyed on the flight id), so
    Perfetto draws arrows from a flight's virtual-lane retry/uplink spans
    to its host-lane server span — one contribution's causal path across
    the two time lanes."""
    out: List[Dict[str, Any]] = []
    flows: Dict[str, List[Dict[str, Any]]] = {}
    for pid, name in _LANE_NAMES.items():
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name}})
    tids: Dict[tuple, int] = {}

    def tid_for(pid: int, cat: str) -> int:
        key = (pid, cat)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == pid]) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tids[key], "args": {"name": cat}})
        return tids[key]

    for ev in events:
        pid = _pid(ev)
        cat = str(ev.get("cat", "app"))
        base = {"name": str(ev.get("name", "?")), "cat": cat, "pid": pid,
                "tid": tid_for(pid, cat),
                "args": jsonable(ev.get("args", {}))}
        if "t0" in ev and "t1" in ev:      # spans and round records
            base["ph"] = "X"
            base["ts"] = float(ev["t0"]) * 1e6
            base["dur"] = max(0.0, (float(ev["t1"]) - float(ev["t0"])) * 1e6)
            fid = (ev.get("args") or {}).get("flight_id")
            if fid is not None:
                flows.setdefault(str(fid), []).append(base)
        elif "t" in ev:                    # instants / run boundaries
            base["ph"] = "i"
            base["ts"] = float(ev["t"]) * 1e6
            base["s"] = "t"
        else:  # pragma: no cover - malformed event; keep the export loadable
            continue
        out.append(base)
    for fid, slices in flows.items():
        if len(slices) < 2:
            continue
        slices = sorted(slices, key=lambda s: s["ts"])
        for i, sl in enumerate(slices):
            ph = "s" if i == 0 else ("f" if i == len(slices) - 1 else "t")
            flow = {"ph": ph, "name": "flight", "cat": "flights",
                    "id": fid, "pid": sl["pid"], "tid": sl["tid"],
                    "ts": sl["ts"]}
            if ph == "f":
                flow["bp"] = "e"
            out.append(flow)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_perfetto(events: Iterable[Dict[str, Any]], path) -> None:
    Path(path).write_text(json.dumps(to_perfetto(events)) + "\n",
                          encoding="utf-8")

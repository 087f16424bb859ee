"""Structured spans: host wall-clock and scheduler virtual time as lanes.

Twin of ``repro/obs/spans.py``. The reference's in-jit no-op is a
``torch.compiler.is_compiling()`` check here.

A `Recorder` collects plain-dict events; ``span``/``virtual_span``/``event``
are the module-level entry points the hot path calls. When no recorder is
configured (the default) every entry point is a near-zero-cost no-op, so
instrumentation can live permanently in `Scheduler.run`, the executors, the
wire codec, Lloyd/kmeans and checkpoint I/O without taxing uninstrumented
runs.

Two time lanes, recorded side by side:

  * host   — ``time.perf_counter`` seconds since the recorder's epoch; what
             the process actually spent (launch time for device work —
             spans never block on device values, so they add zero
             device→host syncs).
  * virtual — the scheduler's simulated clock (``virtual_span``); what the
             modeled fleet spent.

Spans are trace-safe: while ``torch.compile`` traces
(``torch.compiler.is_compiling()``) every entry point degrades to a no-op,
so a span in a function that is sometimes compiled records eager calls
only. Span ``args`` must be plain host values (ints, strs, shapes), never
device tensors.

Event schema (one JSON-able dict per event; see ``export.py``):

  {"type": "span",  "lane": "host"|"virtual", "name", "cat",
   "t0", "t1", "args": {...}}                       # t in lane seconds
  {"type": "event", "lane": ..., "name", "cat", "t", "args": {...}}
  {"type": "round", "lane": "virtual", ...}         # emitted by log_trace
  {"type": "meta" | "run", ...}                     # run boundaries
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch


def _eager() -> bool:
    """False while ``torch.compile`` traces the caller: a span in a
    function that is sometimes compiled records eager calls only."""
    return not torch.compiler.is_compiling()


class Recorder:
    """An append-only in-memory event log with a perf_counter epoch."""

    def __init__(self, run: str = "run",
                 meta: Optional[Dict[str, Any]] = None):
        self.run = run
        self.epoch = time.perf_counter()
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self._written = 0          # events already flushed to JSONL
        self.append({"type": "meta", "lane": "host", "cat": "obs",
                     "name": "run_start", "t": 0.0,
                     "args": dict(meta or {}, run=run)})

    # ---- recording ---------------------------------------------------------
    def now(self) -> float:
        """Host seconds since the recorder's epoch."""
        return time.perf_counter() - self.epoch

    def append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(ev)

    def virtual_span(self, name: str, t_start: float, t_end: float,
                     cat: str = "scheduler", **args) -> None:
        self.append({"type": "span", "lane": "virtual", "name": name,
                     "cat": cat, "t0": float(t_start), "t1": float(t_end),
                     "args": args})

    def event(self, name: str, cat: str = "app", lane: str = "host",
              t: Optional[float] = None, **args) -> None:
        self.append({"type": "event", "lane": lane, "name": name, "cat": cat,
                     "t": self.now() if t is None else float(t),
                     "args": args})

    # ---- export (delegates to export.py) -----------------------------------
    def write_jsonl(self, path, append: bool = True) -> int:
        """Flush events to an append-only JSONL log. Repeated calls write
        only the events recorded since the previous flush; returns the
        number of events written."""
        from repro_torch.obs.export import write_jsonl
        with self._lock:
            pending = self.events[self._written:]
            wrote = write_jsonl(pending, path,
                                append=append and self._written > 0)
            self._written += len(pending)
        return wrote

    def write_perfetto(self, path) -> None:
        """Write every event so far as Chrome/Perfetto trace_event JSON."""
        from repro_torch.obs.export import write_perfetto
        with self._lock:
            events = list(self.events)
        write_perfetto(events, path)


class _Span:
    """Host-lane span context manager (created only when recording)."""
    __slots__ = ("_rec", "name", "cat", "args", "_t0")

    def __init__(self, rec: Recorder, name: str, cat: str, args: Dict):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._rec.now()
        return self

    def set(self, **args) -> None:
        """Attach args discovered mid-span (host values only)."""
        self.args.update(args)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._rec.append({"type": "span", "lane": "host", "name": self.name,
                          "cat": self.cat, "t0": self._t0,
                          "t1": self._rec.now(), "args": self.args})
        return False


class _NullSpan:
    """The disabled path: one shared, stateless, do-nothing span."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()
_RECORDER: Optional[Recorder] = None


def configure(run: str = "run",
              meta: Optional[Dict[str, Any]] = None) -> Recorder:
    """Install a fresh module-level recorder (replacing any current one)."""
    global _RECORDER
    _RECORDER = Recorder(run=run, meta=meta)
    return _RECORDER


def shutdown() -> Optional[Recorder]:
    """Uninstall and return the current recorder (None if none)."""
    global _RECORDER
    rec, _RECORDER = _RECORDER, None
    return rec


def current() -> Optional[Recorder]:
    return _RECORDER


def enabled() -> bool:
    """True when a recorder is installed and nothing is being compiled."""
    return _RECORDER is not None and _eager()


def span(name: str, cat: str = "app", **args):
    """Host-lane span context manager; a no-op when disabled or tracing."""
    rec = _RECORDER
    if rec is None or not _eager():
        return _NULL_SPAN
    return _Span(rec, name, cat, args)


def virtual_span(name: str, t_start: float, t_end: float,
                 cat: str = "scheduler", **args) -> None:
    """Record a closed span on the simulated-clock lane."""
    rec = _RECORDER
    if rec is not None:
        rec.virtual_span(name, t_start, t_end, cat=cat, **args)


def event(name: str, cat: str = "app", lane: str = "host",
          t: Optional[float] = None, **args) -> None:
    """Record an instant event (autoscale plan moves, policy cuts, ...).

    ``t`` is lane time: omit it on the host lane (now), pass the sim time
    explicitly for ``lane="virtual"``."""
    rec = _RECORDER
    if rec is None or not _eager():
        return
    rec.event(name, cat=cat, lane=lane, t=t, **args)


def instrument(name: Optional[str] = None,
               cat: str = "app") -> Callable[[Callable], Callable]:
    """Decorator/wrapper form of ``span`` for whole-function timing."""
    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _RECORDER is None or not _eager():
                return fn(*args, **kwargs)
            with span(label, cat=cat):
                return fn(*args, **kwargs)
        return wrapper
    return deco

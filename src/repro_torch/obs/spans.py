"""Structured spans: host wall-clock and scheduler virtual time as lanes.

Twin of ``repro/obs/spans.py``. The reference's in-jit no-op is a
``torch.compiler.is_compiling()`` check here.

A `Recorder` collects plain-dict events; ``span``/``virtual_span``/``event``
are the module-level entry points the hot path calls. When no recorder is
configured and torch's profiler is off (the default) every entry point is
a near-zero-cost no-op, so instrumentation lives permanently on the hot
path without taxing uninstrumented runs. The spans that exist:

  * ``scheduler.round`` / ``scheduler.flush`` — one server update of the
    scheduler (``federated/scheduler.py``);
  * ``trainer.draw_batches`` — the cohort's ``client_batch_for`` calls in
    ``FederatedTrainer.run``; ``trainer.measure_round_bytes`` — the wire
    measurement a run starts with (``federated/runtime.py``);
  * ``executor.place`` / ``executor.execute`` — the cohort's placement and
    its step (``federated/executor.py``);
  * ``step.forward`` / ``step.backward`` / ``step.update`` — a step's
    forward (its k-means included), its ``autograd.grad`` and the
    optimizer's update, in every step of ``core/fedlite.py``;
  * ``kmeans.lloyd`` — a ``batched_lloyd`` call, and ``kmeans.seed`` — its
    seeding (cold starts only: the L - 1 farthest-point host steps)
    (``core/kmeans.py``);
  * ``wire.*`` — the wire codec (``federated/wire.py``);
    ``checkpoint.save`` / ``checkpoint.restore`` / ``recovery.snapshot`` —
    checkpoint I/O;
  * ``ssm.scan`` — an ``ssd_scan`` call: its chunk loop or its CUDA
    kernels (``models/ssm.py``; args: chunks, chunk, route "plain" or
    "kernel");
  * ``moe.route`` / ``moe.dispatch`` / ``moe.experts`` / ``moe.combine`` —
    an MoE layer's router and slots, its scatter, its expert products and
    its gathers (``models/moe.py``; args: k, capacity, experts held, and
    on the scatter and the gathers route "plain" or "kernel"), and
    ``moe.shared`` — the shared expert beside it
    (``models/transformer.py``; args: width). Under rematerialization a
    recomputed forward opens them again.

Three time lanes:

  * host   — ``time.perf_counter`` seconds since the recorder's epoch; what
             the process actually spent (launch time for device work —
             spans never block on device values, so they add zero
             device→host syncs).
  * virtual — the scheduler's simulated clock (``virtual_span``); what the
             modeled fleet spent.
  * profiler — while torch's profiler runs (``torch.profiler.profile``),
             every host span also opens a ``record_function`` range of its
             name, with or without a recorder: the span then sits on the
             device trace's clock as a user annotation, with the kernels
             launched under it. No event dict changes for it.

Spans are trace-safe: while ``torch.compile`` traces
(``torch.compiler.is_compiling()``) every entry point degrades to a no-op,
so a span in a function that is sometimes compiled records eager calls
only. Span ``args`` must be plain host values (ints, strs, shapes), never
device tensors. Spans nest by interval on a thread; the events carry no
parent id.

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


# whether torch's profiler is recording now (a C call, well under 1 us)
_profiling = torch.autograd._profiler_enabled


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
    """Host-lane span context manager (created only when recording or
    profiling): ``rec`` None records nothing, ``profiled`` opens a
    ``record_function`` range around the interval."""
    __slots__ = ("_rec", "name", "cat", "args", "_t0", "_range")

    def __init__(self, rec: Optional[Recorder], name: str, cat: str,
                 args: Dict, profiled: bool):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._range = torch.profiler.record_function(name) \
            if profiled else None

    def __enter__(self) -> "_Span":
        if self._range is not None:
            self._range.__enter__()
        if self._rec is not None:
            self._t0 = self._rec.now()
        return self

    def set(self, **args) -> None:
        """Attach args discovered mid-span (host values only)."""
        self.args.update(args)

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._rec is not None:
            self._rec.append({"type": "span", "lane": "host",
                              "name": self.name, "cat": self.cat,
                              "t0": self._t0, "t1": self._rec.now(),
                              "args": self.args})
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
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
    """Host-lane span context manager, also a profiler range while torch's
    profiler runs; a no-op with neither, and while tracing."""
    rec, profiled = _RECORDER, _profiling()
    if (rec is None and not profiled) or not _eager():
        return _NULL_SPAN
    return _Span(rec, name, cat, args, profiled)


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
            if (_RECORDER is None and not _profiling()) or not _eager():
                return fn(*args, **kwargs)
            with span(label, cat=cat):
                return fn(*args, **kwargs)
        return wrapper
    return deco

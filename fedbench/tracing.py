"""The traced stretch of a ``--trace 1`` run and its reduction.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities), with a synchronize on each side, and keeps every device
operation (kernels, copies, sets) and every host operation as plain
intervals. The reductions are the benchmark's own: the device's busy time
is the union of its operations' intervals, an idle gap is named by the
innermost host operation running at its midpoint, and a kernel's device
time is the sum of its launches' durations.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch


class Op(NamedTuple):
    name: str
    t0: float      # microseconds, the profiler's clock
    t1: float


class Profiled(NamedTuple):
    window_s: float        # host seconds of the stretch, synchronized
    device_ops: List[Op]   # every operation on the device
    host_ops: List[Op]     # every host operation the profiler recorded


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """A profiled stretch opened and closed by ``start`` and ``stop``,
    each after a synchronize, so a caller can open it on a boundary
    inside a call (a round's end)."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity
        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._t0 = 0.0

    def start(self) -> None:
        sync(self.device)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> Profiled:
        sync(self.device)
        window = time.perf_counter() - self._t0
        self._prof.stop()
        dev, host = [], []
        for e in self._prof.events():
            if getattr(e, "is_user_annotation", False):
                continue    # a span's mark on a timeline, not an operation
            op = Op(e.name, float(e.time_range.start),
                    float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append(op)
            elif e.device_type == torch.autograd.DeviceType.CPU:
                host.append(op)
        return Profiled(window, dev, host)


def profile(fn: Callable[[], None], device: torch.device) -> Profiled:
    """``fn()`` under the profiler, between two synchronizes."""
    tracer = Tracer(device)
    tracer.start()
    fn()
    return tracer.stop()


def merged(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    out: List[List[float]] = []
    for t0, t1 in sorted((o.t0, o.t1) for o in ops):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def busy_s(p: Profiled) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in merged(p.device_ops)) * 1e-6


def device_seconds(p: Profiled, pattern: str) -> Tuple[float, int]:
    """(summed device seconds, launches) of the device operations whose
    name matches ``pattern``."""
    rx = re.compile(pattern)
    hits = [o for o in p.device_ops if rx.search(o.name)]
    return sum(o.t1 - o.t0 for o in hits) * 1e-6, len(hits)


def top_device_ops(p: Profiled, n: int = 10) -> List[list]:
    """The ``n`` device operations that took most time, by name."""
    tot: Dict[str, float] = {}
    for o in p.device_ops:
        tot[o.name] = tot.get(o.name, 0.0) + (o.t1 - o.t0) * 1e-6
    return [[k[:160], v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(p: Profiled, n: int = 10, scan: int = 4000) -> List[list]:
    """Idle time between device operations, summed by what the host was
    doing at each gap's midpoint (the innermost host operation running
    then), the ``n`` largest."""
    spans = merged(p.device_ops)
    host = sorted(p.host_ops, key=lambda o: o.t0)
    starts = [o.t0 for o in host]
    tot: Dict[str, float] = {}
    for (_, a), (b, _) in zip(spans, spans[1:]):
        mid = 0.5 * (a + b)
        name = "host: between operations"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - scan, -1), -1):
            if host[j].t1 >= mid:
                name = host[j].name
                break
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return [[k[:160], v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

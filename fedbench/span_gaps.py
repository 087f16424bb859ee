"""The idle gaps of a traced stretch by the program span they fall in: a
reduction the result line does not make yet.

The program's spans (``repro_torch.obs``) are ranges on the profiler's
clock while it runs, as user annotations, and ``tracing.Tracer.stop``
drops those. ``kept_annotations()`` keeps them aside for each stretch a
``Tracer`` stops meanwhile, and ``idle_by_span`` puts each idle gap
between device operations under the innermost span at its midpoint.

    python3 fedbench/span_gaps.py --workload femnist.fullsync --seed 7 \\
        --seconds 51

runs the cell once as ``--trace 1`` does, on the card, and prints one
JSON line: the profiled stretch's idle seconds by span, all of them
(``all``) and those ``tracing.idle_gaps`` names "host: between
operations" (``between_ops``), with the stretch's window and busy
seconds.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve()
               != ROOT / "fedbench"]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from fedbench import tracing  # noqa: E402

BETWEEN = "host: between operations"
NO_SPAN = "(no span)"


def annotations(prof) -> List[tracing.Op]:
    """The host's user annotations of a stopped ``torch.profiler``."""
    import torch
    return [tracing.Op(e.name, float(e.time_range.start),
                       float(e.time_range.end))
            for e in prof.events()
            if getattr(e, "is_user_annotation", False)
            and e.device_type == torch.autograd.DeviceType.CPU]


@contextlib.contextmanager
def kept_annotations() -> Iterator[List[Tuple[tracing.Profiled,
                                              List[tracing.Op]]]]:
    """A list that gets (stretch, its annotations) for each
    ``tracing.Tracer`` stopped inside the block."""
    kept = []
    real = tracing.Tracer.stop

    def stop(self):
        p = real(self)
        kept.append((p, annotations(self._prof)))
        return p

    tracing.Tracer.stop = stop
    try:
        yield kept
    finally:
        tracing.Tracer.stop = real


def idle_by_span(p: tracing.Profiled, marks: List[tracing.Op],
                 scan: int = 4000) -> Dict[str, Dict[str, float]]:
    """Idle seconds between device operations by the innermost mark that
    holds each gap's midpoint: under ``all`` every gap, under
    ``between_ops`` the gaps in which no host operation runs at the
    midpoint (``tracing.idle_gaps``' rule), largest first."""
    dev = tracing.merged(p.device_ops)
    host = sorted(p.host_ops, key=lambda o: o.t0)
    starts = [o.t0 for o in host]
    out: Dict[str, Dict[str, float]] = {"all": {}, "between_ops": {}}
    for (_, a), (b, _) in zip(dev, dev[1:]):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        between = not any(host[j].t1 >= mid
                          for j in range(i, max(i - scan, -1), -1))
        holders = [m for m in marks if m.t0 <= mid <= m.t1]
        span = min(holders, key=lambda m: m.t1 - m.t0).name \
            if holders else NO_SPAN
        for key in ("all", "between_ops") if between else ("all",):
            out[key][span] = out[key].get(span, 0.0) + (b - a) * 1e-6
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1]))
            for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from fedbench import harness

    cell = harness.Cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("fedbench: span_gaps needs a CUDA card", file=sys.stderr)
        return 2
    with kept_annotations() as kept:
        out = cell.driver.run(cell, args.seed, args.seconds, True,
                              torch.device("cuda"))
    p = out.readings.profiled
    marks = next(m for q, m in kept if q is p)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "correct": out.correct, "window_s": p.window_s,
                      "busy_s": tracing.busy_s(p),
                      "spans_per_stretch": len(marks),
                      "idle_by_span_s": idle_by_span(p, marks)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 fedbench/run.py --workload femnist.fullsync --seed 7 \\
        --seconds 51 --trace 0

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, from the program's spans, the benchmark's spans and the
profiler's trace, with the device's busy seconds and a breakdown. Both
check the timed path's first steps against the plain reference
(``correct``) and print each compared number beside its limit, on standard
error and under ``checks``, last in the line. A machine with fewer cards
than the cell asks for, or a run that finds ``jax`` or the JAX package
loaded, exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the package is imported as ``fedbench`` from the root, never its
# folders as top-level names
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve()
               != ROOT / "fedbench"]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    an empty string where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             *, bench=None, workload=None, fault=None):
    """(result line, stderr lines) of one run of cell ``name`` on
    ``device``. ``workload`` replaces the cell file's contents (the tests'
    small sizes); ``fault`` plants a fault in the program (the fault
    checks)."""
    import torch

    from fedbench import harness, tracing

    bench = harness.load_benchmark() if bench is None else bench
    cell = harness.Cell(bench, name)
    if workload is not None:
        cell.workload = workload
    device = torch.device(device)
    out = cell.driver.run(cell, seed, seconds, trace, device, fault=fault)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    if trace:
        metrics = harness.read_per_layer(cell, out.readings)
        prof = out.readings.profiled
        if prof is not None:
            dev["busy_s"] = tracing.busy_s(prof)
            dev["window_s"] = prof.window_s
            breakdown = {"device_ops": tracing.top_device_ops(prof),
                         "idle_gaps": tracing.idle_gaps(prof)}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.e2e}
    notes = [f"seconds: {json.dumps(out.timings)}"]
    notes += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in out.checks.items()]
    line = harness.result_line(out.correct, out.attempted, out.failed,
                               metrics, dev, out.checks, breakdown)
    return line, notes


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from fedbench import harness

    bench = harness.load_benchmark()
    cell = harness.Cell(bench, args.workload)
    chips = cell.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"fedbench: the cell {args.workload} needs {chips} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    limit = power_limit()
    line, notes = run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", bench=bench)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"fedbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 2
    if limit:
        print(f"card: {limit}", file=sys.stderr)
    for n in notes:
        print(n, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

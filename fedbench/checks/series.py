"""Run cells of the benchmark several times, each run a process of its
own, and report each metric's spread.

    python3 fedbench/checks/series.py --out chiprun_out/sets.jsonl \\
        --runs femnist.fullsync:11,12,13 --seconds 51 --trace 0

Each run's exit code, wall seconds, result line and the end of its
standard error go to ``--out`` (one JSON object a line); at the end the
quartile spread of each metric of each cell -- (Q3 - Q1) / median, with
``statistics.quantiles(values, n=4)`` -- is printed.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", nargs="+", required=True,
                    help="cell:seed,seed,... (run in the order given)")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    values = {}
    with open(args.out, "a") as out:
        for spec in args.runs:
            cell, seeds = spec.split(":")
            for seed in seeds.split(","):
                t0 = time.perf_counter()
                p = subprocess.run(
                    [sys.executable, "fedbench/run.py", "--workload", cell,
                     "--seed", seed, "--seconds", str(args.seconds),
                     "--trace", str(args.trace)], cwd=ROOT,
                    capture_output=True, text=True)
                wall = time.perf_counter() - t0
                lines = p.stdout.strip().splitlines()
                res = json.loads(lines[-1]) if p.returncode == 0 and lines \
                    else None
                rec = {"cell": cell, "seed": int(seed), "trace": args.trace,
                       "seconds": args.seconds, "rc": p.returncode,
                       "wall_s": wall, "result": res,
                       "stderr": p.stderr[-3000:]}
                out.write(json.dumps(rec) + "\n")
                out.flush()
                ok = res["correct"] if res else None
                short = {k: v["value"] for k, v in res["metrics"].items()} \
                    if res else p.stderr[-1500:]
                print(f"{cell} seed {seed}: rc {p.returncode} correct {ok} "
                      f"wall {wall:.1f} s {short}", flush=True)
                if res:
                    for k, v in res["metrics"].items():
                        values.setdefault((cell, k), []).append(v["value"])
    for (cell, k), vs in values.items():
        print(f"spread {cell} {k}: {spread(vs):.5f} over {len(vs)} "
              f"(median {statistics.median(vs):.6g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

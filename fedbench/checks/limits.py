"""The readings that a cell's limits are set from: the compared numbers of
sound runs of the program over many seeds, of the control (the reference
put in the program's place, computed in the precision below the
configuration's), and of the program with each fault planted.

    python3 fedbench/checks/limits.py --cell femnist.fullsync \\
        --seeds 11 12 13 --control tf32 --control-seeds 21 22 23 \\
        --faults half_batch --fault-seeds 31 32 33 --out readings.jsonl

Training readings need no measured window: each seed builds the cell's
program, drives its checked first steps and holds them to the reference,
all in one process. One JSON object a line goes to ``--out``; the largest
sound reading and the smallest control and fault readings of each number
are printed at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(argv=None) -> int:
    import torch

    from fedbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", nargs="*", type=int, default=[])
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", nargs="*", type=int, default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = harness.Cell(harness.load_benchmark(), args.cell)
    drv = cell.driver
    seen = {}

    def note(kind, seed, readings):
        rec = {"cell": args.cell, "kind": kind, "seed": seed,
               "readings": readings}
        if device.type == "cuda":
            rec["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
            torch.cuda.reset_peak_memory_stats(device)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
        for k, v in readings.items():
            if isinstance(v, float):
                seen.setdefault(kind, {}).setdefault(k, []).append(v)

    for seed in args.seeds:
        prog = drv.setup(cell, seed, device)[2]
        note("program", seed, drv.reference_readings(
            cell.config, cell.traffic, seed, device, prog))
    for seed in args.control_seeds:
        note(f"control:{args.control}", seed,
             drv.control_readings(cell, seed, device, args.control))
    for fault in args.faults:
        for seed in args.fault_seeds:
            prog = drv.setup(cell, seed, device, fault)[2]
            note(f"fault:{fault}", seed, drv.reference_readings(
                cell.config, cell.traffic, seed, device, prog))
    for kind, nums in seen.items():
        pick = max if kind == "program" else min
        print(f"{args.cell} {kind}: " + ", ".join(
            f"{k} {pick(v):.4g}" for k, v in nums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's registry and result line.

Everything a cell needs is found by its name in ``BENCHMARK.json``:

  * ``workloads/<cell>.json``  -- the cell: its configuration, its driver,
    the traffic parameters the driver reads, and its ``why``;
  * the configuration's ``file`` -- sizes, precision and source, and the
    names of its program model, plain reference and counts, which the
    driver resolves;
  * ``drivers/<driver>.py``   -- the loop of one kind of cell;
  * ``metrics/<metric>.py``   -- one reader per per-layer metric.

So a later cell or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "fedbench"

# top-level module names that may not be loaded in a run: the JAX stack
# and the JAX package the port mirrors (compared whole: "repro_torch" is
# not "repro")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

_T_IMPORT = time.time()


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot), or since this module was imported where
    ``/proc`` is not there."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def seed_of(seed: int, *stream: int) -> int:
    """A 62-bit seed of stream ``stream`` of run ``seed``, from numpy's
    ``SeedSequence`` (any size of ``seed``; neighbouring seeds and streams
    give unrelated numbers)."""
    import numpy as np
    state = np.random.SeedSequence([seed, *stream]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def forbidden_loaded() -> List[str]:
    """The modules of ``sys.modules`` whose top-level name is forbidden."""
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload_file(name: str) -> Path:
    return HERE / "workloads" / f"{name}.json"


def metric_file(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def list_workload_files() -> List[str]:
    return sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


def list_metric_files() -> List[str]:
    return sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                  if not p.stem.startswith("_"))


class Cell:
    """One cell of ``BENCHMARK.json`` with its files read: ``entry`` (the
    ``workloads`` entry), ``workload`` (its file), ``config`` (the
    configuration's file), ``e2e`` and ``per_layer`` (the metric entries
    it reports)."""

    def __init__(self, bench: Dict[str, Any], name: str,
                 root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(root / self.config_entry["file"]) as f:
            self.config = json.load(f)
        with open(workload_file(name)) as f:
            self.workload = json.load(f)
        if self.workload["config"] != self.entry["config"]:
            raise ValueError(f"{name}: its file names configuration "
                             f"{self.workload['config']!r}, BENCHMARK.json "
                             f"{self.entry['config']!r}")
        self.e2e = [m for m in bench["end_to_end"] if reports(m, name)]
        moved = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in bench["per_layer"]
                          if reports(m, name) and m["moves"] in moved]

    @property
    def driver(self):
        return importlib.import_module(
            f"fedbench.drivers.{self.workload['driver']}")

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.workload["traffic"]


def reports(metric: Dict[str, Any], cell: str) -> bool:
    """Whether a metric entry covers the cell: listed, or no list."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str):
    """The reader module of per-layer metric ``name``
    (``metrics/<name>.py``): ``read(readings) -> float | None``."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        f"fedbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(cell: Cell, readings) -> Dict[str, Dict[str, Any]]:
    """Each of the cell's per-layer metrics that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"]).read(readings)
        if value is None:
            continue
        if not math.isfinite(value):
            raise ValueError(f"{m['name']}: reader returned {value}")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, list]] = None) -> str:
    """The one JSON line a run prints last, its compared numbers last."""
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(attempted),
                            "failed": int(failed), "metrics": metrics,
                            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)

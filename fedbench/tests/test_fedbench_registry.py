"""Every entry of BENCHMARK.json resolves to its files and keeps to the
benchmark's contract; a cell and a per-layer metric are added as new files
only."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fedbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return harness.load_benchmark(ROOT)


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= len(b["command"]) <= 32
    assert all(line_ok(w) for w in b["command"])
    assert b["command"][1] in ("fedbench/run.py",)
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024


def test_configs_resolve():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("fedbench/") and c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))


def test_configs_name_their_modules():
    """A configuration names its plain reference, its counts and the
    program's model (a paper model's class, or a zoo architecture), so a
    driver serves every configuration of its kind unedited."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import paper_models
    for c in bench()["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert (ROOT / "fedbench" / "reference"
                / f"{data['reference']}.py").is_file()
        assert (ROOT / "fedbench" / "counts" / f"{data['counts']}.py").is_file()
        if "program" in data:
            assert callable(getattr(paper_models, data["program"]["model"]))
        else:
            assert get_arch(data["arch"]).name
            assert (ROOT / "fedbench" / "reference"
                    / f"{data['optimizer']['name']}.py").is_file()


def test_cells_resolve():
    b = bench()
    cells = b["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        cell = harness.Cell(b, w["name"], ROOT)
        assert cell.workload["name"] == w["name"]
        assert sorted(cell.workload["end_to_end"]) == sorted(
            m["name"] for m in cell.e2e)
        assert {m["name"] for m in cell.e2e} > {"setup_s"}
        assert cell.per_layer, w["name"]
        assert (ROOT / "fedbench" / "drivers"
                / f"{cell.workload['driver']}.py").is_file()
        assert cell.workload["limits"]


def test_metrics_keep_the_contract():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert 1 <= len(b["end_to_end"]) <= 16
    assert 1 <= len(b["per_layer"]) <= 128
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line_ok(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert harness.reports(moved, cell), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [m["name"] for m in
                                  harness.load_benchmark(ROOT)["per_layer"]])
def test_metric_reader_declares_its_entry(name):
    entry = {m["name"]: m for m in bench()["per_layer"]}[name]
    mod = harness.load_reader(name)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])


def test_a_cell_and_a_metric_are_new_files_only(tmp_path):
    """Copy the benchmark, add a cell and a metric as files plus entries,
    and the copied harness lists and reads them."""
    shutil.copytree(ROOT / "fedbench", tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "femnist.dummy", "config": "femnist_cnn",
                           "traffic": "dummy", "chips": 1,
                           "why": "a cell added as a file"})
    b["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "trainer", "moves": "round_ms"})
    for m in b["end_to_end"]:
        if m["name"] in ("round_ms",):
            m["workloads"].append("femnist.dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = json.loads((ROOT / "fedbench/workloads/femnist.fullsync.json")
                      .read_text())
    cell["name"] = "femnist.dummy"
    (tmp_path / "fedbench/workloads/femnist.dummy.json").write_text(
        json.dumps(cell))
    (tmp_path / "fedbench/metrics/dummy_ms.py").write_text(
        'LAYER = "trainer"\nUNIT = "ms"\nSOURCE = "host_clock"\n'
        'MOVES = "round_ms"\n\n\ndef read(r):\n    return 2.5\n')
    code = ("import types\nfrom fedbench import harness\n"
            "b = harness.load_benchmark()\n"
            "print(harness.list_workload_files())\n"
            "print(harness.list_metric_files())\n"
            "cell = harness.Cell(b, 'femnist.dummy')\n"
            "print(harness.read_per_layer(cell, types.SimpleNamespace("
            "kind='none', spans=None, profiled=None, units=0, wall_s=0)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(tmp_path),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    workloads, metrics, read = out.stdout.strip().splitlines()
    assert "femnist.dummy" in workloads and "dummy_ms" in metrics
    assert "'dummy_ms': {'value': 2.5, 'unit': 'ms'}" in read

"""The plain reference agrees with the port's plain CPU path; its control
(the reference in the precision below the configuration's) and each fault
planted in the timed path come out not correct. FEMNIST runs at its full
widths, the LM at SMOKE_CONFIG's."""

import json
from pathlib import Path

import pytest
import torch

from fedbench import compare, harness
from fedbench.drivers import federated_rounds, lm_train
from fedbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
FEMNIST = ["femnist.fullsync", "femnist.q288_L32", "femnist.splitfed"]
LM = "mixtral_8x22b.train_8x2k"


def femnist_cell(name):
    cell = harness.Cell(harness.load_benchmark(ROOT), name, ROOT)
    cell.workload = json.loads(json.dumps(cell.workload))
    cell.workload["traffic"].update(rounds_per_call=2, trace_rounds=[1, 2])
    return cell


def lm_cell():
    cell = harness.Cell(harness.load_benchmark(ROOT), LM, ROOT)
    cell.config = json.loads((Path(__file__).parent / "mixtral_smoke.json")
                             .read_text())
    cell.workload = json.loads(json.dumps(cell.workload))
    cell.workload["traffic"] = {"clients": 2, "seq": 32, "trace_steps": 1}
    return cell


@pytest.mark.parametrize("name", FEMNIST)
def test_femnist_reference_agrees_with_the_port(name):
    cell = femnist_cell(name)
    _, _, prog, _ = federated_rounds.setup(cell, 2 ** 31 + 11, CPU)
    readings = federated_rounds.reference_readings(
        cell.config, cell.traffic, 2 ** 31 + 11, CPU, prog)
    ok, checks = compare.decide(readings, cell.workload["limits"])
    assert ok, checks
    assert readings["loss_gap"] < 1e-6


def test_lm_reference_agrees_with_the_port():
    cell = lm_cell()
    _, _, prog = lm_train.setup(cell, 2 ** 31 + 12, CPU)
    readings = lm_train.reference_readings(cell.config, cell.traffic,
                                           2 ** 31 + 12, CPU, prog)
    assert readings["loss_gap"] < 1e-5 and readings["cut_gap"] < 1e-5
    assert readings["grad_norm_gap"] < 1e-5
    assert readings["change_norm_gap"] < 1e-5
    assert readings["cut_grad_gap"] < 1e-5
    assert readings["codes_off"] == 0
    assert readings["codes_differ_share"] == 0
    assert readings["codebook_cast_off"] == 0


@pytest.mark.parametrize("name,precision", [(n, "tf32") for n in FEMNIST]
                         + [(LM, "fp8")])
def test_the_control_is_not_correct(name, precision):
    cell = lm_cell() if name == LM else femnist_cell(name)
    drv = cell.driver
    readings = drv.control_readings(cell, 2 ** 31 + 13, CPU, precision)
    ok, checks = compare.decide(readings, cell.workload["limits"])
    assert not ok, checks


FAULTS = [(n, f) for n in FEMNIST[:2] for f in
          ("state_unchanged", "half_batch", "codes_altered", "wire_f32")] \
    + [(FEMNIST[2], f) for f in ("state_unchanged", "half_batch")] \
    + [(LM, f) for f in ("state_unchanged", "half_batch", "codes_altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_is_not_correct(name, fault):
    """The rest of a run (no look for a card), the timed path broken."""
    if name == LM:
        out = lm_train.run(lm_cell(), 2 ** 31 + 14, 0.0, False, CPU,
                           fault=fault)
        assert not out.correct, out.checks
        return
    cell = femnist_cell(name)
    line, _ = run_cell(name, 2 ** 31 + 14, 0.0, False, "cpu",
                       workload=cell.workload, fault=fault)
    assert json.loads(line)["correct"] is False


def test_a_traced_run_reports_its_per_layer_metrics():
    cell = femnist_cell("femnist.fullsync")
    line, notes = run_cell("femnist.fullsync", 2 ** 31 + 15, 0.0, True,
                           "cpu", workload=cell.workload)
    out = json.loads(line)
    assert out["correct"] and list(out)[-1] == "checks"
    # what a CPU run can read; the device's metrics need the card
    assert {"trainer_overhead_ms", "kmeans_host_ms", "mfu_pct.round"} <= \
        set(out["metrics"])
    assert any(n.startswith("check loss_gap") for n in notes)

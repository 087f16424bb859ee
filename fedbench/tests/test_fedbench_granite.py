"""The Granite cell (``granite_4h_small.train_8x4k``) at SMOKE_CONFIG's
widths (``granite_smoke.json``): the plain reference agrees with the
port's plain CPU path; its control (the reference in fp8, the precision
below the configuration's bf16) and each fault planted in the timed path
come out not correct under the cell's limits. Also the cell's counts and
its launches reader."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench import compare, harness, tracing
from fedbench.counts import hybrid_lm
from fedbench.drivers import lm_train
from fedbench.reference import granite_hybrid

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "granite_4h_small.train_8x4k"


def granite_cell():
    cell = harness.Cell(harness.load_benchmark(ROOT), CELL, ROOT)
    cell.config = json.loads((Path(__file__).parent / "granite_smoke.json")
                             .read_text())
    cell.workload = json.loads(json.dumps(cell.workload))
    cell.workload["traffic"] = {"clients": 2, "seq": 64, "trace_steps": 1}
    return cell


def test_reference_agrees_with_the_port():
    cell = granite_cell()
    _, _, prog = lm_train.setup(cell, 2 ** 31 + 22, CPU)
    readings = lm_train.reference_readings(cell.config, cell.traffic,
                                           2 ** 31 + 22, CPU, prog)
    for name in ("loss_gap", "cut_gap", "grad_norm_gap", "change_norm_gap",
                 "cut_grad_gap"):
        assert readings[name] < 1e-5, (name, readings)
    assert readings["codes_off"] == 0
    assert readings["codes_differ_share"] == 0
    assert readings["codebook_cast_off"] == 0
    assert compare.decide(readings, cell.workload["limits"])[0]


def test_the_control_is_not_correct():
    cell = granite_cell()
    readings = lm_train.control_readings(cell, 2 ** 31 + 23, CPU, "fp8")
    ok, checks = compare.decide(readings, cell.workload["limits"])
    assert not ok, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "codes_altered", "codebooks_rounded",
                                   "kmeans_iters_minus_1",
                                   "kmeans_random_seeds"])
def test_a_planted_fault_is_not_correct(fault):
    out = lm_train.run(granite_cell(), 2 ** 31 + 24, 0.0, False, CPU,
                       fault=fault)
    assert not out.correct, out.checks


def test_the_cell_configuration_is_the_port_config_cut():
    """The file's model is the port's published config with only the
    keys ``reduced`` names changed; its catalog keys are the published
    config's, the reduced ones beside their published values."""
    cell = harness.Cell(harness.load_benchmark(ROOT), CELL, ROOT)
    cfg = cell.config
    arch = lm_train.arch_config(cfg)
    assert (arch.num_layers, arch.experts_held, arch.num_experts,
            arch.period) == (20, 18, 72, 10)
    assert cfg["num_hidden_layers"] == 20 and \
        cfg["published"]["num_hidden_layers"] == 40
    assert cfg["num_local_experts"] == 18 and \
        cfg["published"]["num_local_experts"] == 72
    kinds = ["attention" if k == "attn" else "mamba"
             for k in arch.layer_pattern] * 2
    assert cfg["layer_types"] == kinds == \
        cfg["published"]["layer_types"][:20]
    specs = granite_hybrid.param_specs(cfg["model"])
    n = sum(torch.Size(s).numel() for s, _ in specs.values())
    assert 6.0e9 < n < 6.2e9


def test_granite_step_flops():
    cfg = json.loads((ROOT / "fedbench/configs/granite_4p0_h_small_2p.json")
                     .read_text())["model"]
    flops = hybrid_lm.train_step_flops(cfg, 8, 4096)
    assert 6.40e14 < flops < 6.50e14


def test_product_count_matches_the_layout():
    """The products' parameters a token passes through, from the
    reference's param layout: every 2-D weight of a layer, the held
    experts' stacks at k/E of a token each, the tied head."""
    m = json.loads((Path(__file__).parent / "granite_smoke.json")
                   .read_text())["model"]
    specs = granite_hybrid.param_specs(m)
    per_token = 0.0
    for key, (shape, _) in specs.items():
        if key.endswith("tok_embed"):
            per_token += m["vocab_size"] * shape[1]
        elif "/we_" in key:
            per_token += torch.Size(shape).numel() \
                * m["experts_per_token"] / m["num_experts"]
        elif len(shape) == 3 and "conv_w" not in key:
            per_token += shape[0] * shape[1] * shape[2]
    assert hybrid_lm.product_params_per_token(m) == pytest.approx(per_token)


def test_ssd_count_against_the_flop_counter():
    """The port's chunked scan computes every (i, j) of a chunk and masks;
    the count keeps the causal pairs."""
    from repro_torch.models.ssm import ssd_scan
    b, s, h, p, n, cs = 1, 64, 2, 4, 8, 32
    c = {"d_model": h * p // 2, "ssm_expand": 2, "ssm_state": n,
         "ssm_head_dim": p, "ssm_chunk": cs}
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(b, s, h, p, generator=g),
            torch.rand(b, s, h, generator=g), -torch.rand(h, generator=g),
            torch.randn(b, s, n, generator=g), torch.randn(b, s, n,
                                                          generator=g))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ssd_scan(*args, cs)
    masked = (s // cs) * cs * (cs - 1) // 2
    assert fc.get_total_flops() == hybrid_lm.ssd_flops_per_sequence(c, s) \
        + 2 * masked * (n + h * p)


def test_launches_per_step_reader():
    reader = harness.load_reader("launches_per_step.train")
    ops = [tracing.Op("k", 0.0, 1.0)] * 6
    prof = tracing.Profiled(1.0, ops, [])
    assert reader.read(SimpleNamespace(kind="train", profiled=prof,
                                       profiled_units=2)) == 3.0
    assert reader.read(SimpleNamespace(kind="round", profiled=prof,
                                       profiled_units=2)) is None
    assert reader.read(SimpleNamespace(
        kind="train", profiled=tracing.Profiled(1.0, [], []),
        profiled_units=2)) is None

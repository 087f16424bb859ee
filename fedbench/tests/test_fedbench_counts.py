"""The frozen FLOP and byte counts against a FLOP counter and against the
kernels' bounds on record."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench.counts import cut_kernels, femnist_cnn, lm

ROOT = Path(__file__).resolve().parents[2]


def femnist_config():
    return json.loads((ROOT / "fedbench/configs/femnist_cnn.json")
                      .read_text())


def test_femnist_flops_match_the_flop_counter():
    from repro_torch.models.paper_models import FemnistCNN
    cfg = femnist_config()
    model = FemnistCNN(device="cpu")
    n = 3
    batch = {"image": torch.randn(n, 28, 28, 1),
             "label": torch.randint(0, 62, (n,))}
    with FlopCounterMode(display=False) as fc:
        loss, _ = model(batch, quantize=False)
        loss.backward()
    assert fc.get_total_flops() == n * femnist_cnn.train_flops_per_sample(
        cfg["model"])
    assert femnist_cnn.train_flops_per_sample(cfg["model"]) == 71_605_248


def smoke_model_config():
    from repro_torch.configs.mixtral_8x22b import SMOKE_CONFIG
    c = dataclasses.asdict(SMOKE_CONFIG)
    return {k: c[k] for k in (
        "num_layers", "d_model", "vocab_size", "num_heads", "num_kv_heads",
        "head_dim", "d_ff", "num_experts", "experts_per_token",
        "sliding_window", "rope_theta", "norm_eps", "vocab_pad_to",
        "cut_periods", "param_dtype", "router_aux_weight")} | {
        "capacity_factor": 8.0}


def test_lm_flops_match_the_flop_counter(monkeypatch):
    """The reference's f32 step of SMOKE_CONFIG's widths, with no
    rematerialization and a capacity no pair exceeds: the FLOP counter's
    total is the count's, with the attention's masked pairs in it (the
    reference computes every (query, key) pair and masks)."""
    from fedbench.reference import mixtral
    monkeypatch.setattr(mixtral, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    m = smoke_model_config()
    b, s = 2, 32
    specs = mixtral.param_specs(m)
    g = torch.Generator().manual_seed(0)
    params = {k: (torch.randn(shape, generator=g) * 0.05).requires_grad_()
              for k, (shape, _) in specs.items()}
    tokens = torch.randint(0, m["vocab_size"], (b, s), generator=g)
    batch = {"tokens": tokens, "labels": tokens}
    cut = {"subvector_dim": 8, "clusters": 4, "iters": 1, "lam": 1e-4}
    rows = s * m["d_model"] // 8
    decision = (torch.randn(b, 4, 8), torch.randint(0, 4, (b, rows)))
    with FlopCounterMode(display=False) as fc:
        loss, _, _ = mixtral.loss_of(params, batch, m, cut,
                                     decision=decision)
        loss.backward()
    full = 3 * 4 * m["head_dim"] * s * s * m["num_heads"] * b \
        * m["num_layers"]
    causal = 3 * 4 * m["head_dim"] * lm.causal_pairs(
        s, m["sliding_window"]) * m["num_heads"] * b * m["num_layers"]
    want = lm.train_step_flops(m, b, s) - causal + full
    assert fc.get_total_flops() == want


def test_mixtral_step_flops():
    cfg = json.loads((ROOT / "fedbench/configs/mixtral_8x22b_2l.json")
                     .read_text())
    flops = lm.train_step_flops(cfg["model"], 8, 2048)
    assert 1.55e14 < flops < 1.62e14


@pytest.mark.parametrize("kernel,want_us", [("lloyd_update", 2.20),
                                            ("pq_quantize", 6.88)])
def test_cut_kernel_bounds_at_the_femnist_cut(kernel, want_us):
    """PERF.md's table: 2.20 us and 6.88 us at (10, 23040, 8), f32."""
    got = cut_kernels.least_seconds_of(kernel, 10, 23040, 8, 2, 4) * 1e6
    assert round(got, 2) == want_us

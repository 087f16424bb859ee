"""The round's program spans (``repro_torch.obs``): where they sit in a
FEMNIST FedLite round, and their ranges on torch's profiler, on the
CPU."""

import pytest
import torch

from repro_torch import obs
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import FederatedTrainer
from repro_torch.models.paper_models import FemnistCNN
from repro_torch.obs import spans as obs_spans
from repro_torch.optim import sgd

COHORT, B, L = 2, 4, 4
ROUNDS = 2
# each span of the round, and the span it sits in
PARENT = {"trainer.draw_batches": "scheduler.round",
          "executor.execute": "scheduler.round",
          "step.forward": "executor.execute",
          "step.backward": "executor.execute",
          "step.update": "executor.execute",
          "kmeans.lloyd": "step.forward",
          "kmeans.seed": "kmeans.lloyd"}


@pytest.fixture(scope="module")
def trainer():
    torch.manual_seed(0)
    data = make_federated_image_data(num_clients=6, seed=0, device="cpu")
    pq = PQConfig(num_subvectors=288, num_clusters=L, kmeans_iters=2)
    model = FemnistCNN(pq=pq, lam=1e-4, device="cpu")
    tr = FederatedTrainer(model, sgd(0.03), data, cohort=COHORT,
                          client_batch=B, quantize=True, seed=0,
                          device="cpu")
    state, _ = tr.run(1, 0)     # warm: the profiled runs see no first call
    return tr, state


def inside(a, b) -> bool:
    return b[0] <= a[0] and a[1] <= b[1]


def innermost_parent(iv, name, by_name):
    """The shortest span of ``PARENT[name]`` that holds ``iv``."""
    holders = [p for p in by_name.get(PARENT[name], []) if inside(iv, p)]
    return min(holders, key=lambda p: p[1] - p[0]) if holders else None


def test_round_spans_once_per_fullsync_round_and_nested(trainer):
    tr, state = trainer
    obs.configure(run="spans")
    try:
        tr.run(ROUNDS, 1, state=state)
    finally:
        rec = obs.shutdown()
    spans = [e for e in rec.events if e["type"] == "span"
             and e["lane"] == "host"]
    rounds = [(e["t0"], e["t1"]) for e in spans
              if e["name"] == "scheduler.round"]
    assert len(rounds) == ROUNDS
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append((e["t0"], e["t1"]))
    for name in PARENT:
        in_rounds = [iv for iv in by_name.get(name, [])
                     if any(inside(iv, rd) for rd in rounds)]
        for rd in rounds:
            assert sum(inside(iv, rd) for iv in in_rounds) == 1, (name, rd)
        for iv in in_rounds:
            assert innermost_parent(iv, name, by_name) is not None, name
    # the draws sit beside the step, not in it
    for iv in by_name["trainer.draw_batches"]:
        assert not any(inside(iv, ex) for ex in by_name["executor.execute"])


def test_profiler_ranges_without_a_recorder(trainer):
    tr, state = trainer
    from torch.profiler import ProfilerActivity, profile
    assert obs.current() is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(ROUNDS, 1, state=state)
    marks = [e for e in prof.events() if e.is_user_annotation]
    by_name = {}
    for e in marks:
        by_name.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    assert len(by_name["scheduler.round"]) == ROUNDS
    for name in PARENT:
        in_rounds = [iv for iv in by_name[name]
                     if any(inside(iv, rd)
                            for rd in by_name["scheduler.round"])]
        assert len(in_rounds) == ROUNDS, name
        for iv in in_rounds:
            assert innermost_parent(iv, name, by_name) is not None, name
    assert obs.current() is None     # the profiler lane records no event


def test_span_is_null_with_no_recorder_and_no_profiler():
    from torch.profiler import ProfilerActivity, profile
    assert obs.current() is None
    assert obs.span("x") is obs_spans._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sp = obs.span("x", cat="test", n=1)
        assert sp is not obs_spans._NULL_SPAN
        with sp:
            torch.ones(2).add_(1)
    assert obs.span("x") is obs_spans._NULL_SPAN
    marks = [e.name for e in prof.events() if e.is_user_annotation]
    assert marks == ["x"]
    assert obs.current() is None     # the profiler lane records no event

"""The benchmark's side of the program's spans, on the CPU: the readers of
the round's spans (``metrics/``), the traced stretch's host operations
with and without the spans' profiler ranges, and ``span_gaps``' reduction
of idle gaps by span."""

from types import SimpleNamespace

import pytest
import torch

from fedbench import harness, span_gaps, tracing
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import FederatedTrainer
from repro_torch.models.paper_models import FemnistCNN
from repro_torch.obs import spans as obs_spans
from repro_torch.optim import sgd

ROUND_SPANS = {"scheduler.round", "trainer.draw_batches", "executor.execute",
               "step.forward", "step.backward", "step.update",
               "kmeans.lloyd", "kmeans.seed"}


def _span(name, t0, t1):
    return {"type": "span", "lane": "host", "name": name, "cat": "test",
            "t0": t0, "t1": t1, "args": {}}


def _two_rounds(seeds_per_round=1):
    """Two rounds of 10 ms, each with its spans (seconds)."""
    out = []
    for base in (0.0, 0.010):
        out += [_span("trainer.draw_batches", base + 0.0005, base + 0.0015),
                _span("kmeans.seed", base + 0.0030, base + 0.0032),
                _span("kmeans.lloyd", base + 0.0029, base + 0.0040),
                _span("step.forward", base + 0.0020, base + 0.0050),
                _span("step.backward", base + 0.0050, base + 0.0070),
                _span("step.update", base + 0.0070, base + 0.0075),
                _span("executor.execute", base + 0.0019, base + 0.0076),
                _span("scheduler.round", base, base + 0.0099)]
        out += [_span("kmeans.seed", base + 0.0033, base + 0.0034)] * (
            seeds_per_round - 1)
    # outside every round: the wire measurement's k-means
    out += [_span("kmeans.lloyd", 0.03, 0.04), _span("kmeans.seed",
                                                     0.03, 0.031)]
    return out


READ = {"batch_draw_host_ms": 1.0, "step_forward_host_ms": 3.0 - 1.1,
        "step_backward_host_ms": 2.0, "step_update_host_ms": 0.5,
        "kmeans_seed_host_ms": 0.2}
SPAN = {"batch_draw_host_ms": "trainer.draw_batches",
        "step_forward_host_ms": "step.forward",
        "step_backward_host_ms": "step.backward",
        "step_update_host_ms": "step.update",
        "kmeans_seed_host_ms": "kmeans.seed"}


@pytest.mark.parametrize("name", sorted(READ))
def test_span_reader_value_and_wrong_counts(name):
    mod = harness.load_reader(name)

    def read(spans, calls=1, kind="round"):
        return mod.read(SimpleNamespace(kind=kind, spans=spans,
                                        kmeans_calls_per_round=calls))
    assert read(_two_rounds()) == pytest.approx(READ[name], rel=1e-9)
    assert read(None) is None and read([]) is None
    assert read(_two_rounds(), kind="train") is None
    # the LM driver's readings carry no k-means count
    assert mod.read(SimpleNamespace(kind="train", spans=_two_rounds())) \
        is None
    # a round holding one span too many of what the reader reads
    extra = _two_rounds() + [_span(SPAN[name], 0.0031, 0.0032)]
    assert read(extra) is None
    # the parent's program: no such spans in its rounds
    assert read([e for e in _two_rounds() if e["name"] != SPAN[name]]) \
        is None
    if name in ("step_forward_host_ms", "kmeans_seed_host_ms"):
        # a round whose k-means calls are not the configured count
        assert read(_two_rounds(), calls=2) is None
    if name == "kmeans_seed_host_ms":
        assert read(_two_rounds(), calls=0) is None        # SplitFed
        assert read(_two_rounds(2), calls=2) == pytest.approx(0.3)


def test_traced_stretch_keeps_its_host_ops_with_the_ranges(monkeypatch):
    """The spans' profiler ranges are user annotations: the stretch the
    benchmark reduces holds the same host operations with them as without
    them, and ``kept_annotations`` gets them back."""
    torch.manual_seed(0)
    data = make_federated_image_data(num_clients=4, seed=0, device="cpu")
    model = FemnistCNN(pq=PQConfig(num_subvectors=288, num_clusters=2,
                                   kmeans_iters=1), lam=1e-4, device="cpu")
    tr = FederatedTrainer(model, sgd(0.03), data, cohort=2, client_batch=2,
                          quantize=True, seed=0, device="cpu")
    state, _ = tr.run(1, 0)

    def traced():
        tracer = tracing.Tracer(torch.device("cpu"))
        tracer.start()
        tr.run(1, 1, state=state)
        return tracer.stop()
    real = tracing.Tracer.stop
    with span_gaps.kept_annotations() as kept:
        on = traced()
    assert tracing.Tracer.stop is real and len(kept) == 1
    assert kept[0][0] is on
    assert {m.name for m in kept[0][1]} >= ROUND_SPANS
    monkeypatch.setattr(obs_spans, "_profiling", lambda: False)
    off = traced()
    names = [{o.name for o in p.host_ops} for p in (on, off)]
    assert names[0] == names[1] and not ROUND_SPANS & names[0]
    assert not on.device_ops and not off.device_ops


def test_idle_by_span_on_a_synthetic_stretch():
    op = tracing.Op
    # device busy 0-10, 20-30, 40-50, 60-70 us: gaps at 15, 35, 55
    dev = [op("k", t, t + 10) for t in (0, 20, 40, 60)]
    host = [op("aten::add", 30, 38)]                    # holds 35
    marks = [op("scheduler.round", 0, 50), op("step.backward", 10, 20)]
    p = tracing.Profiled(1e-4, dev, host)
    got = span_gaps.idle_by_span(p, marks)
    assert got["all"] == pytest.approx(
        {"step.backward": 10e-6, "scheduler.round": 10e-6,
         span_gaps.NO_SPAN: 10e-6})
    assert got["between_ops"] == pytest.approx(
        {"step.backward": 10e-6, span_gaps.NO_SPAN: 10e-6})
    # the gaps between operations are those the breakdown names so
    named = dict(tracing.idle_gaps(p))
    assert named[span_gaps.BETWEEN] == pytest.approx(
        sum(got["between_ops"].values()))

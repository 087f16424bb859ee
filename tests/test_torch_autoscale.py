"""The port's trace-driven autoscaler (``repro_torch/federated/
autoscale.py``) against the JAX package's, on the CPU.

The rules are pure functions of a trace: on the canned traces of
``tests/test_executor.py`` the port recommends the reference's plans,
field for field (cohort, policy, downlink, reason). ``autoscale_run`` is
run at a small size: the history carries each round's plan index, the byte
totals are the segments' traces', the trainer's client-keyed cut-layer
caches move from one segment's trainer to the next, every plan move is an
``autoscale.plan`` event, and a bytes-budgeted run walks the downlink
ladder through the same plans as the reference's (the budget rule reads
the measured wire bytes and the simulated clock, which are bitwise between
the packages).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.quantizer import PQConfig as JPQConfig
from repro.data.synthetic import make_federated_image_data as j_image_data
from repro.federated import autoscale as jauto
from repro.federated import mobile_fleet as j_mobile_fleet
from repro.federated import FederatedTrainer as JTrainer
from repro.federated.trace import RoundRecord as JRoundRecord
from repro.federated.trace import Trace as JTrace
from repro.models.paper_models import FemnistCNN as JFemnistCNN
from repro.optim import sgd as jsgd
from repro_torch import obs
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import (DOWNLINK_LADDER, AsyncBuffer,
                                   AutoscalePlan, Deadline, DropSlowestK,
                                   FederatedTrainer, FullSync,
                                   TraceAutoscaler, autoscale_run,
                                   make_policy, mobile_fleet)
from repro_torch.federated.trace import RoundRecord, Trace
from repro_torch.models.paper_models import FemnistCNN
from repro_torch.optim import sgd

CPU = torch.device("cpu")


def _trace(durs, losses=None, dropped=0, up=1000, down=1000, ref=False):
    """``tests/test_executor.py``'s canned trace, in either package."""
    rec_cls, trace_cls = (JRoundRecord, JTrace) if ref else \
        (RoundRecord, Trace)
    losses = losses or [None] * len(durs)
    t = trace_cls()
    for i, (d, loss) in enumerate(zip(durs, losses)):
        t.append(rec_cls(
            round=i, t_start=float(i * 10), t_end=float(i * 10) + d,
            participants=tuple(range(4)),
            dropped=tuple(range(100, 100 + dropped)),
            uplink_bytes=up, downlink_bytes=down,
            metrics={} if loss is None else {"loss": loss}))
    return t


def _plan(p):
    return (p.cohort, p.policy, p.downlink, p.reason)


def _recommend(ctl_kw, trace_kw, plan_kw):
    """(port's plan, reference's plan) for one canned trace and plan."""
    ours = TraceAutoscaler(**ctl_kw).recommend(
        _trace(**trace_kw), AutoscalePlan(**plan_kw))
    ref = jauto.TraceAutoscaler(**ctl_kw).recommend(
        _trace(ref=True, **trace_kw), jauto.AutoscalePlan(**plan_kw))
    assert _plan(ours) == _plan(ref)
    return ours


IMPROVING = [5, 4.8, 4.6, 4.4, 4.2, 4.0, 3.8, 3.6]


def test_autoscaler_is_deterministic():
    trace = _trace([1, 1, 1, 1, 1, 1, 1, 5], losses=IMPROVING)
    ctl = TraceAutoscaler(window=8)
    outs = [ctl.recommend(trace, AutoscalePlan(cohort=4)) for _ in range(3)]
    assert outs[0] == outs[1] == outs[2]
    _recommend({"window": 8}, {"durs": [1] * 7 + [5], "losses": IMPROVING},
               {"cohort": 4})


def test_autoscaler_straggler_tail_bounds_rounds():
    plan = _recommend({"window": 8, "tail_hi": 1.8, "deadline_slack": 1.5},
                      {"durs": [1] * 7 + [5]}, {"cohort": 4})
    assert plan.policy.startswith("deadline:")
    assert float(plan.policy.split(":")[1]) == pytest.approx(1.5)
    assert plan.cohort == 4 and "straggler tail" in plan.reason


def test_autoscaler_backs_off_aggressive_policy():
    trace = {"durs": [2] * 8, "dropped": 3}
    plan = _recommend({"window": 8}, trace,
                      {"cohort": 4, "policy": "deadline:2"})
    assert plan.policy == "deadline:4"
    plan2 = _recommend({"window": 8}, trace,
                       {"cohort": 4, "policy": "drop_slowest:2"})
    assert plan2.policy == "drop_slowest:1"
    plan3 = _recommend({"window": 8}, trace, {"cohort": 4})
    assert plan3.cohort == 2 and "shrink cohort" in plan3.reason


def test_autoscaler_bytes_budget_escalates_codec_then_cohort():
    trace = {"durs": [1] * 8, "up": 4000, "down": 4000}
    ctl = {"window": 8, "bytes_budget_per_round": 1000.0}
    p1 = _recommend(ctl, trace, {"cohort": 8})
    assert p1.downlink == "scalarq(bits=8)" and p1.cohort == 8
    p2 = _recommend(ctl, trace, {"cohort": 8, "downlink": p1.downlink})
    assert p2.downlink == DOWNLINK_LADDER[-1]
    p3 = _recommend(ctl, trace, {"cohort": 8, "downlink": p2.downlink})
    assert p3.cohort == 4


def test_autoscaler_grows_when_healthy_shrinks_on_plateau():
    improving = {"durs": [1] * 8, "losses": [5.0 - 0.2 * i for i in range(8)]}
    assert _recommend({"window": 8}, improving, {"cohort": 4}).cohort == 8
    flat = {"durs": [1] * 8, "losses": [3.0] * 8}
    assert _recommend({"window": 8}, flat, {"cohort": 8}).cohort == 4
    steady = _recommend({"window": 8}, flat, {"cohort": 2})
    assert steady.cohort == 2 and steady.reason == "steady"


def test_autoscaler_empty_trace_is_noop():
    plan = AutoscalePlan(cohort=4)
    assert TraceAutoscaler().recommend(Trace(), plan) == plan


def test_observe_equals_the_reference():
    kw = {"durs": [1, 2, 1, 3, 1, 1, 2, 5], "losses": IMPROVING,
          "dropped": 1}
    assert TraceAutoscaler(window=4).observe(_trace(**kw)) == \
        jauto.TraceAutoscaler(window=4).observe(_trace(ref=True, **kw))


def test_make_policy_round_trips_specs():
    assert isinstance(make_policy("full_sync"), FullSync)
    assert make_policy("drop_slowest:2").k == 2
    assert isinstance(make_policy("drop_slowest"), DropSlowestK)
    assert make_policy("deadline:6.5").seconds == 6.5
    assert isinstance(make_policy("deadline:1"), Deadline)
    assert make_policy("async:3").buffer_size == 3
    assert isinstance(make_policy("async"), AsyncBuffer)
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("psychic")


# ---------------------------------------------------------------------------
# autoscale_run
# ---------------------------------------------------------------------------

def _port_maker(trainers, warm_start=False):
    data = make_federated_image_data(num_clients=8, seed=0, device=CPU)
    pq = PQConfig(num_subvectors=288, num_clusters=4, kmeans_iters=2)
    model = FemnistCNN(pq=pq, lam=1e-4, client_batch=8, device=CPU)

    def make_trainer(plan, seg):
        tr = FederatedTrainer(
            model, sgd(0.03), data, cohort=plan.cohort, client_batch=8,
            fleet=mobile_fleet(8, flaky_fraction=0.3, seed=0),
            policy=make_policy(plan.policy),
            downlink_compressor=plan.downlink, warm_start=warm_start,
            error_feedback=warm_start, seed=seg, device=CPU)
        trainers.append(tr)
        return tr
    return make_trainer


def test_autoscale_run_stitches_segments_and_moves_caches():
    trainers = []
    rec = obs.configure(run="autoscale")
    try:
        out = autoscale_run(_port_maker(trainers, warm_start=True),
                            AutoscalePlan(cohort=4), 6, 0,
                            controller=TraceAutoscaler(window=2,
                                                       max_cohort=8),
                            interval=2)
    finally:
        obs.shutdown()
    assert len(trainers) == len(out["traces"]) == 3
    assert len(out["history"]) == 6
    plan_of = [h["plan"] for h in out["history"]]
    assert plan_of == sorted(plan_of) and plan_of[0] == 0
    assert plan_of[-1] == len(out["plans"]) - 1
    assert out["uplink_bytes"] == sum(t.total_uplink_bytes
                                      for t in out["traces"])
    assert out["downlink_bytes"] == sum(t.total_downlink_bytes
                                        for t in out["traces"])
    assert out["simulated_seconds"] == sum(t.simulated_seconds
                                           for t in out["traces"])
    assert sum(h["uplink_bytes"] for h in out["history"]) == \
        out["uplink_bytes"]
    # the client-keyed caches are the previous segment's, carried on
    for prev, nxt in zip(trainers, trainers[1:]):
        assert nxt._client_q is prev._client_q
        assert nxt._ef_memory is prev._ef_memory
    assert trainers[-1]._client_q      # the lineage grew across segments
    moves = [e for e in rec.events if e.get("name") == "autoscale.plan"]
    assert len(moves) == len(out["plans"]) - 1
    assert all(obs.is_registered_event(e["name"]) for e in moves)
    for e, plan in zip(moves, out["plans"][1:]):
        assert e["args"]["cohort"] == plan.cohort
        assert e["args"]["reason"] == plan.reason
    assert np.isfinite([h["loss"] for h in out["history"]]).all()


def _ref_maker():
    data = j_image_data(num_clients=8, seed=0)
    model = JFemnistCNN(pq=JPQConfig(288, 4, kmeans_iters=2),
                        lam=1e-4, client_batch=8)

    def make_trainer(plan, seg):
        return JTrainer(
            model, jsgd(0.03), data, cohort=plan.cohort, client_batch=8,
            fleet=j_mobile_fleet(8, flaky_fraction=0.3, seed=0),
            policy=jauto.make_policy(plan.policy),
            downlink_compressor=plan.downlink, seed=seg)
    return make_trainer


def test_budgeted_run_walks_the_ladder_like_the_reference():
    """A budget below every codec's bytes: rule 3 moves the downlink to
    scalarq(bits=8), then to the chain, in both packages, at the same
    segments, with the same reasons and byte totals."""
    ctl = dict(window=2, max_cohort=8, bytes_budget_per_round=1.0)
    ours = autoscale_run(_port_maker([]), AutoscalePlan(cohort=4), 6, 0,
                         controller=TraceAutoscaler(**ctl), interval=2)
    ref = jauto.autoscale_run(_ref_maker(), jauto.AutoscalePlan(cohort=4),
                              6, jax.random.PRNGKey(0),
                              controller=jauto.TraceAutoscaler(**ctl),
                              interval=2)
    assert [_plan(p) for p in ours["plans"]] == \
        [_plan(p) for p in ref["plans"]]
    assert [p.downlink for p in ours["plans"]] == list(DOWNLINK_LADDER)
    assert [h["plan"] for h in ours["history"]] == \
        [h["plan"] for h in ref["history"]]
    for key in ("uplink_bytes", "downlink_bytes", "simulated_seconds"):
        assert ours[key] == ref[key], key
    for a, b in zip(ours["traces"], ref["traces"]):
        assert [dataclasses.replace(r, metrics={}).__dict__ for r in a] == \
            [dataclasses.replace(r, metrics={}).__dict__ for r in b]

"""The port's run-health layer (``repro_torch/obs/{schema,slo,inspect}.py``
and ``python -m repro_torch.obs``) against the JAX package's, on the CPU.

  * the event-name registry equals the reference's;
  * SLO rules parse as the reference's do, and `trace_signals` /
    `HealthMonitor.evaluate` equal the reference's on the traces of one
    seeded simulation, which is bitwise between the packages
    (``tests/test_torch_simulator.py``): every comparison is exact;
  * the inspector prints the reference's text, character for character,
    for the same JSONL log: the default report, ``--faults``,
    ``--flight``, ``--health``, ``--slo`` and a truncated log (twins of
    ``tests/test_obs.py``'s inspector tests);
  * a recorded chaos run of the port's trainer, graded by
    ``slo_monitor=HealthMonitor()``, carries ``slo_violation`` events, and
    every event name in its log is registered.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.federated import faults as jfaults
from repro.federated import network as jnet
from repro.federated import scheduler as jsched
from repro.federated import topology as jtopo
from repro.obs import inspect as jinspect
from repro.obs import schema as jschema
from repro.obs import slo as jslo
from repro_torch import obs
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import make_federated_image_data
from repro_torch.federated import (DEFAULT_CHAOS, FederatedTrainer,
                                   lognormal_fleet)
from repro_torch.federated import faults as tfaults
from repro_torch.federated import network as tnet
from repro_torch.federated import scheduler as tsched
from repro_torch.federated import topology as ttopo
from repro_torch.federated.trace import RoundRecord, Trace
from repro_torch.models.paper_models import FemnistCNN
from repro_torch.obs import inspect as tinspect
from repro_torch.obs import schema as tschema
from repro_torch.obs import slo as tslo
from repro_torch.optim import sgd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_event_schemas_equal_the_reference():
    assert tschema.EVENT_SCHEMAS == jschema.EVENT_SCHEMAS
    assert tslo.SIGNALS == jslo.SIGNALS
    assert obs.is_registered_event("slo_violation")
    assert not obs.is_registered_event("no.such.event")


@pytest.mark.parametrize("spec", ["drop_rate<=0.3", "rounds >= 5 @ 20",
                                  "tail_ratio<=2.5@8", "x.y>=-1e-3"])
def test_parse_rule_round_trips_like_the_reference(spec):
    ours, ref = obs.parse_rule(spec), jslo.parse_rule(spec)
    assert (ours.name, ours.signal, ours.op, ours.threshold, ours.window) \
        == (ref.name, ref.signal, ref.op, ref.threshold, ref.window)
    again = obs.parse_rule(f"{ours.signal}{ours.op}{ours.threshold!r}"
                           + (f"@{ours.window}" if ours.window else ""))
    assert (again.signal, again.op, again.threshold, again.window) == \
        (ours.signal, ours.op, ours.threshold, ours.window)


def test_parse_rule_rejects_what_the_reference_rejects():
    for bad in ("drop_rate == 0.3", "not a rule", "<=3"):
        with pytest.raises(ValueError):
            obs.parse_rule(bad)
        with pytest.raises(ValueError):
            jslo.parse_rule(bad)


# ---------------------------------------------------------------------------
# SLO signals on one seeded simulation in each package
# ---------------------------------------------------------------------------

def _sim(net, sched, faults, topo, policy, rounds=10):
    """A stub-executor scheduler run (the simulator alone) under a chaos
    plan and a two-tier topology: a cohort stream fixed across packages."""
    fleet = net.lognormal_fleet(24, dropout_prob=0.1, seed=3)
    rng = np.random.default_rng(99)
    cohorts = [rng.choice(24, 8, replace=False) for _ in range(rounds + 64)]
    policies = {"full_sync": sched.FullSync(),
                "drop_slowest": sched.DropSlowestK(2)}
    s = sched.Scheduler(fleet=fleet, policy=policies[policy], seed=1,
                        topology=topo.TwoTierTopology(num_edges=3, seed=0),
                        faults=faults.FaultPlan(seed=3, crash_rate=0.3,
                                                max_retries=1))
    return s.run(rounds, sample_cohort=lambda rd: cohorts[rd],
                 uplink_bytes=1000, downlink_bytes=4000,
                 execute=lambda i, parts, w: {"loss": float(len(parts))},
                 wire_kinds=("pq", "dense"))


def _results(results):
    return [(r.rule.name, r.rule.signal, r.rule.op, r.rule.threshold,
             r.rule.window, r.value, r.ok) for r in results]


@pytest.mark.parametrize("policy", ["full_sync", "drop_slowest"])
def test_signals_and_health_equal_the_reference(policy):
    ours = _sim(tnet, tsched, tfaults, ttopo, policy)
    ref = _sim(jnet, jsched, jfaults, jtopo, policy)
    for window in (None, 3):
        assert tslo.trace_signals(ours, window) == \
            jslo.trace_signals(ref, window)
    specs = ("rounds>=100", "retry_byte_overhead<=0.01@4",
             "edge_uplink_bytes_per_round<=1", "ghost<=1")
    tmon = obs.HealthMonitor(list(obs.DEFAULT_SLOS)
                             + [obs.parse_rule(s) for s in specs])
    jmon = jslo.HealthMonitor(list(jslo.DEFAULT_SLOS)
                              + [jslo.parse_rule(s) for s in specs])
    got, want = _results(tmon.evaluate(ours)), _results(jmon.evaluate(ref))
    assert got == want
    assert any(not ok for *_, ok in got)      # the rule set bites
    assert [r.describe() for r in tmon.evaluate(ours)] == \
        [r.describe() for r in jmon.evaluate(ref)]
    rows = tinspect._round_rows([{"type": "round", "t0": r.t_start,
                                  "t1": r.t_end,
                                  "args": {"round": r.round,
                                           "participants":
                                               len(r.participants),
                                           "dropped": len(r.dropped),
                                           "uplink_bytes": r.uplink_bytes,
                                           "downlink_bytes":
                                               r.downlink_bytes,
                                           "ledger": r.ledger,
                                           "faults": r.faults}}
                                 for r in ours])
    assert tslo.signals_from_rows(rows, 4) == \
        jslo.signals_from_rows(rows, 4)
    assert _results(tmon.evaluate_rows(rows)) == \
        _results(jmon.evaluate_rows(rows))


def _record(round, t0, t1, loss=None):
    return RoundRecord(round=round, t_start=t0, t_end=t1,
                       participants=(0, 1), dropped=(), uplink_bytes=100,
                       downlink_bytes=200,
                       metrics={} if loss is None else {"loss": loss})


def test_health_monitor_grades_a_trace():
    trace = Trace(records=[_record(0, 0.0, 1.0), _record(1, 1.0, 2.0)])
    results = obs.HealthMonitor().evaluate(trace)
    assert [r.rule.name for r in results] == \
        [r.name for r in obs.DEFAULT_SLOS]
    assert all(r.ok for r in results)
    bad = obs.HealthMonitor(rules=(
        obs.SloRule("floor", "rounds", ">=", 3),)).check(trace)[0]
    assert not bad.ok and bad.value == 2.0
    assert bad.describe().startswith("FAIL")
    res = obs.HealthMonitor(rules=(
        obs.SloRule("ghost", "no_such_signal", "<=", 1.0),)).evaluate(trace)
    assert res[0].value is None and res[0].ok and "n/a" in res[0].describe()


# ---------------------------------------------------------------------------
# a recorded chaos run and the inspector
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chaos_log(tmp_path_factory):
    """One chaos run of the port's trainer, recorded with the health
    monitor on (the femnist example's --chaos --emit-trace wiring)."""
    obs.shutdown()
    rec = obs.configure(run="chaos", meta={"suite": "unit"})
    try:
        data = make_federated_image_data(num_clients=8, seed=0,
                                         device="cpu")
        pq = PQConfig(num_subvectors=288, num_clusters=4, kmeans_iters=2)
        model = FemnistCNN(pq=pq, lam=1e-4, device="cpu")
        tr = FederatedTrainer(
            model, sgd(0.03), data, cohort=4, client_batch=8, quantize=True,
            seed=0, fleet=lognormal_fleet(8, seed=0),
            fault_plan=DEFAULT_CHAOS, device="cpu",
            slo_monitor=obs.HealthMonitor(
                list(obs.DEFAULT_SLOS)
                + [obs.SloRule("impossible", "rounds", ">=", 1000)]))
        tr.run(6, 0)
    finally:
        obs.shutdown()
    path = tmp_path_factory.mktemp("chaos") / "run.jsonl"
    rec.write_jsonl(path)
    return {"events": rec.events, "path": path}


def _both(capsys, argv):
    """(exit code, stdout, stderr) of the port's and the reference's
    inspector on the same arguments."""
    out = []
    for main in (tinspect.main, jinspect.main):
        code = main([str(a) for a in argv])
        cap = capsys.readouterr()
        out.append((code, cap.out, cap.err))
    return out


def test_chaos_log_events_are_registered(chaos_log):
    events = chaos_log["events"]
    names = {e["name"] for e in events if e.get("type") == "event"}
    assert {"slo_violation", "fault.round", "flight.rollup"} <= names
    assert all(obs.is_registered_event(n) for n in names), \
        sorted(n for n in names if not obs.is_registered_event(n))
    violations = [e for e in events if e.get("name") == "slo_violation"]
    assert len(violations) == 1
    assert violations[0]["args"]["rule"] == "impossible"
    assert violations[0]["args"]["value"] == 6.0


@pytest.mark.parametrize("flags", [[], ["--faults"], ["--health"],
                                   ["--slo", "rounds>=100", "--slo",
                                    "drop_rate<=0.01@3"],
                                   ["--json", "--target", "4.0"],
                                   ["--rows", "3"]],
                         ids=["report", "faults", "health", "slo", "json",
                              "rows"])
def test_inspector_text_equals_the_reference(chaos_log, capsys, flags):
    ours, ref = _both(capsys, [chaos_log["path"], *flags])
    assert ours[0] == 0
    if flags[:1] == ["--json"]:   # the span timings are the process's own
        a, b = json.loads(ours[1]), json.loads(ref[1])
        a.pop("spans"), b.pop("spans")
        assert a == b
    else:
        assert ours == ref
    if flags[:1] == ["--health"]:
        assert "corruption-detected" in ours[1]


def test_inspector_flight_drilldown_equals_the_reference(chaos_log, capsys):
    events = chaos_log["events"]
    fid = next(e["args"]["flight_id"] for e in events
               if e.get("name") == "flight.quarantined")
    ours, ref = _both(capsys, [chaos_log["path"], "--flight", fid])
    assert ours == ref and ours[0] == 0 and fid in ours[1]
    client = fid.split("-")[1][1:]
    assert _both(capsys, [chaos_log["path"], "--flight", client])[0][0] == 0
    ours, ref = _both(capsys, [chaos_log["path"], "--flight", "r9-c9-s9"])
    assert ours == ref and ours[0] == 1 and "r9-c9-s9" in ours[1]


def test_inspector_errors_equal_the_reference(chaos_log, capsys, tmp_path):
    ours, ref = _both(capsys, [chaos_log["path"], "--slo", "not a rule"])
    assert ours == ref and ours[0] == 2
    ours, ref = _both(capsys, [tmp_path / "missing.jsonl"])
    assert ours[0] == ref[0] == 2


def test_inspector_warns_but_renders_truncated_logs(tmp_path, capsys):
    rec = obs.configure(run="cut")
    obs.log_trace(Trace(records=[_record(0, 0.0, 1.0, loss=1.0)]))
    obs.shutdown()
    path = tmp_path / "run.jsonl"
    rec.write_jsonl(path)
    with open(path, "a") as fh:
        fh.write('{"truncat')
    ours, ref = _both(capsys, [path])
    assert ours[0] == 0 and "run: cut" in ours[1]
    assert "skipped 1 unparseable line" in ours[2]
    # the report's span rows are timings of the process that wrote the
    # log: the same file, so the same text
    assert ours == ref


def test_python_dash_m_runs_the_inspector(chaos_log):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          str(chaos_log["path"]), "--faults", "--health"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "SLO health:" in out.stdout

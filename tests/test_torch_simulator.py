"""Parity of the port's simulator (``repro_torch/federated/{network,
faults,topology,scheduler,trace}.py`` and ``repro_torch/obs``) with the
JAX package's. All of it is numpy on the host (PCG64 streams and the fault
plan's own hash stream), so every comparison is bitwise: fleets, fault
draws, the topology's clustering, scheduler traces for the four policies
under both backends (flight frames included), and the obs event log apart
from its host wall-clock fields.
"""

import math

import numpy as np
import pytest

from repro import obs as jobs
from repro.federated import faults as jfaults
from repro.federated import network as jnet
from repro.federated import scheduler as jsched
from repro.federated import topology as jtopo
from repro_torch import obs as tobs
from repro_torch.federated import faults as tfaults
from repro_torch.federated import network as tnet
from repro_torch.federated import scheduler as tsched
from repro_torch.federated import topology as ttopo

FLEET_COLS = ("uplink_bps", "downlink_bps", "latency_s",
              "compute_multiplier", "dropout_prob")


def _fleets(net):
    return {
        "ideal": net.uniform_fleet(12),
        "uniform_dropout": net.uniform_fleet(
            12, net.ClientProfile(dropout_prob=0.2)),
        "lognormal": net.lognormal_fleet(12, median_uplink_bps=2e6,
                                         dropout_prob=0.1, seed=3),
        "mobile": net.mobile_fleet(12, flaky_fraction=0.5, seed=7),
    }


def _policies(sched):
    return {
        "full_sync": sched.FullSync(),
        "drop_slowest_3": sched.DropSlowestK(3),
        "deadline_2.5": sched.Deadline(2.5),
        "async_4": sched.AsyncBuffer(4),
    }


def _plans(faults):
    return {
        "none": None,
        "chaos": faults.DEFAULT_CHAOS,
        "crashy": faults.FaultPlan(seed=3, crash_rate=0.3, max_retries=1,
                                   reorder_rate=0.5, reorder_max_s=1.5),
    }


# ---------------------------------------------------------------------------
# fleets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ideal", "uniform_dropout", "lognormal",
                                  "mobile"])
def test_fleets_are_bitwise_the_reference(name):
    ours, ref = _fleets(tnet)[name], _fleets(jnet)[name]
    for col in FLEET_COLS:
        np.testing.assert_array_equal(getattr(ours, col), getattr(ref, col))
    ids = np.array([0, 5, 11, 3])
    np.testing.assert_array_equal(
        ours.round_trip_seconds(ids, 636, 147456, 1.0),
        ref.round_trip_seconds(ids, 636, 147456, 1.0))
    np.testing.assert_array_equal(
        ours.downlink_compute_seconds(ids, 11122, 1.0),
        ref.downlink_compute_seconds(ids, 11122, 1.0))
    assert ours[3] == tnet.ClientProfile(*(float(getattr(ref, c)[3])
                                           for c in FLEET_COLS))
    assert tnet.transfer_seconds(636, 1e6, 0.15) == \
        jnet.transfer_seconds(636, 1e6, 0.15)


def test_fleet_validation_matches_reference():
    for mod in (tnet, jnet):
        with pytest.raises(ValueError, match="12 profiles for 13"):
            mod.validate_fleet(mod.uniform_fleet(12), 13)
        with pytest.raises(ValueError, match="bandwidth"):
            mod.ClientFleet.broadcast(mod.IDEAL, 3).__class__(
                *[np.array([0.0])] * 2, *[np.array([0.0])] * 3)
    profiles = [tnet.ClientProfile(uplink_bps=1e6 * (i + 1), latency_s=0.01)
                for i in range(4)]
    ours = tnet.ClientFleet.from_profiles(profiles)
    ref = jnet.ClientFleet.from_profiles(
        [jnet.ClientProfile(uplink_bps=1e6 * (i + 1), latency_s=0.01)
         for i in range(4)])
    for col in FLEET_COLS:
        np.testing.assert_array_equal(getattr(ours, col), getattr(ref, col))


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["chaos", "crashy"])
def test_fault_plan_draws_are_bitwise_the_reference(plan):
    ours = tfaults.make_injector(_plans(tfaults)[plan])
    ref = jfaults.make_injector(_plans(jfaults)[plan])
    cids = np.arange(40, dtype=np.int64)
    seqs = np.arange(100, 140, dtype=np.int64)
    for rd in range(6):
        for fn in ("crash_attempts_sync", "corrupt_mask", "poison_mask"):
            np.testing.assert_array_equal(getattr(ours, fn)(rd, cids),
                                          getattr(ref, fn)(rd, cids))
        for mode_rd, cid in ((rd, 7), (rd, 31)):
            payload = bytes(range(64)) * 3
            assert ours.corrupt_payload(payload, mode_rd, cid) == \
                ref.corrupt_payload(payload, mode_rd, cid)
        assert ours.server_killed(rd) == ref.server_killed(rd)
        assert ours.down_edges(float(rd)) == ref.down_edges(float(rd))
    np.testing.assert_array_equal(ours.crash_attempts_async(seqs, cids),
                                  ref.crash_attempts_async(seqs, cids))
    np.testing.assert_array_equal(ours.reorder_jitter(cids, seqs),
                                  ref.reorder_jitter(cids, seqs))
    crashes = ours.crash_attempts_sync(0, cids)
    gone = crashes > _plans(tfaults)[plan].max_retries
    rt = np.linspace(0.5, 3.0, 40)
    np.testing.assert_array_equal(ours.retry_overhead(crashes, rt),
                                  ref.retry_overhead(crashes, rt))
    np.testing.assert_array_equal(
        tfaults.FaultInjector.extra_downlinks(crashes, gone),
        jfaults.FaultInjector.extra_downlinks(crashes, gone))


def test_fault_plan_fields_and_kills_match_reference():
    assert tfaults.DEFAULT_CHAOS.__dict__ == jfaults.DEFAULT_CHAOS.__dict__
    plan = dict(seed=1, server_kill_rounds=(2, 5), edge_outages=((0, 1, 3),))
    ours = tfaults.FaultPlan(**plan).disarm_kills_through(2)
    ref = jfaults.FaultPlan(**plan).disarm_kills_through(2)
    assert ours.__dict__ == ref.__dict__ and ours.any_faults
    assert tfaults.make_injector(None) is None
    assert (tfaults.make_injector(tfaults.FaultPlan()) is None) == \
        (jfaults.make_injector(jfaults.FaultPlan()) is None)
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError, match="crash_rate"):
            mod.FaultPlan(crash_rate=2.0)


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("edges", [3, 16])
def test_topology_clustering_is_bitwise_the_reference(edges):
    ours = ttopo.TwoTierTopology(num_edges=edges, seed=4)
    ref = jtopo.TwoTierTopology(num_edges=edges, seed=4)
    ours.ensure(40)
    ref.ensure(40)
    np.testing.assert_array_equal(ours.locations, ref.locations)
    np.testing.assert_array_equal(ours.cluster_of, ref.cluster_of)
    np.testing.assert_array_equal(ours.centers, ref.centers)
    assert ours.meta() == ref.meta()
    pts = ttopo.simulate_locations(30, hotspots=5, seed=2)
    np.testing.assert_array_equal(
        pts, jtopo.simulate_locations(30, hotspots=5, seed=2))
    for a, b in zip(ttopo.kmeans_points(pts, 4, seed=1),
                    jtopo.kmeans_points(pts, 4, seed=1)):
        np.testing.assert_array_equal(a, b)
    ids = np.arange(0, 40, 3)
    np.testing.assert_array_equal(ours.rehome(ids, (0,)),
                                  ref.rehome(ids, (0,)))
    assert ours.edge_payload_bytes(636) == ref.edge_payload_bytes(636)
    assert ours.relay_hop_seconds(636) == ref.relay_hop_seconds(636)


# ---------------------------------------------------------------------------
# scheduler traces
# ---------------------------------------------------------------------------

def _run(net, sched, faults, topo, fleet_name, policy_name, backend,
         plan="none", topology=False, rounds=5, cohort=5):
    """One scheduler run with a stub execute and a cohort stream that is
    deterministic across calls."""
    fleet = _fleets(net)[fleet_name]
    rng = np.random.default_rng(99)
    cohorts = [rng.choice(len(fleet), cohort, replace=False)
               for _ in range(rounds + 64)]
    top = topo.TwoTierTopology(num_edges=3, seed=1) if topology else None
    if top is not None:
        top.ensure(len(fleet))
    s = sched.Scheduler(fleet=fleet, policy=_policies(sched)[policy_name],
                        seed=0, backend=backend, topology=top,
                        faults=_plans(faults)[plan])
    return s.run(rounds, sample_cohort=lambda rd: cohorts[rd],
                 uplink_bytes=636, downlink_bytes=11122,
                 execute=lambda i, parts, w: {"loss": float(len(parts))},
                 wire_kinds=("pq", "sparse"))


def _assert_traces_equal(a, b):
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert ra.__dict__ == rb.__dict__   # exact floats, tuples, ledger
    assert len(a.flights) == len(b.flights)
    for fa, fb in zip(a.flights, b.flights):
        assert (fa.round, fa.kind) == (fb.round, fb.kind)
        for col in fa._COLS:
            np.testing.assert_array_equal(getattr(fa, col),
                                          getattr(fb, col))
    assert a.cursor == b.cursor
    assert a.summary() == b.summary()


@pytest.mark.parametrize("backend", ["heapq", "vector"])
@pytest.mark.parametrize("policy", ["full_sync", "drop_slowest_3",
                                    "deadline_2.5", "async_4"])
def test_scheduler_traces_are_bitwise_the_reference(policy, backend):
    """Four policies x two backends, over two fleets: the port's trace is
    the reference's, record for record and flight frame for flight frame,
    and the port's two backends agree with each other."""
    for fleet in ("lognormal", "mobile"):
        ours = _run(tnet, tsched, tfaults, ttopo, fleet, policy, backend)
        ref = _run(jnet, jsched, jfaults, jtopo, fleet, policy, backend)
        _assert_traces_equal(ours, ref)
        other = "vector" if backend == "heapq" else "heapq"
        _assert_traces_equal(
            ours, _run(tnet, tsched, tfaults, ttopo, fleet, policy, other))


@pytest.mark.parametrize("policy", ["full_sync", "async_4"])
@pytest.mark.parametrize("plan", ["chaos", "crashy"])
def test_scheduler_traces_under_faults_and_topology(policy, plan):
    """Crash retries, reorder jitter and a two-tier topology: still the
    reference's trace, bitwise, in both backends."""
    for backend in ("heapq", "vector"):
        ours = _run(tnet, tsched, tfaults, ttopo, "mobile", policy, backend,
                    plan=plan, topology=True)
        ref = _run(jnet, jsched, jfaults, jtopo, "mobile", policy, backend,
                   plan=plan, topology=True)
        _assert_traces_equal(ours, ref)


def test_ideal_scheduler_and_cursor_resume_match_reference():
    """``ideal_scheduler`` and the ``cursor`` / ``on_round`` hooks: a run
    resumed from a mid-run cursor continues the reference's clock and RNG
    stream exactly."""
    def drive(mod, cursor=None, rounds=6):
        seen = []
        s = mod.ideal_scheduler(10, seed=2)
        rng = np.random.default_rng(5)
        cohorts = [rng.choice(10, 4, replace=False) for _ in range(rounds)]
        tr = s.run(rounds, sample_cohort=lambda rd: cohorts[rd],
                   uplink_bytes=10, downlink_bytes=20,
                   execute=lambda i, p, w: {}, cursor=cursor,
                   on_round=lambda rd, cur: seen.append((rd, dict(cur))))
        return tr, seen

    ours, seen_o = drive(tsched)
    ref, seen_r = drive(jsched)
    _assert_traces_equal(ours, ref)
    assert [rd for rd, _ in seen_o] == [rd for rd, _ in seen_r]
    cur = seen_o[2][1]
    a, _ = drive(tsched, cursor=cur)
    b, _ = drive(jsched, cursor=seen_r[2][1])
    _assert_traces_equal(a, b)
    assert [r.round for r in a] == [3, 4, 5]


# ---------------------------------------------------------------------------
# obs: the event log
# ---------------------------------------------------------------------------

_WALL = ("t", "t0", "t1")


def _strip(ev):
    """An event without its host wall-clock fields (virtual-lane times are
    simulated and stay)."""
    ev = dict(ev)
    if ev.get("lane") != "virtual":
        for k in _WALL:
            ev.pop(k, None)
    return ev


@pytest.mark.parametrize("policy", ["full_sync", "async_4"])
def test_obs_jsonl_events_match_reference(policy, tmp_path):
    """The same scheduler run, recorded by each package's ``obs`` and
    written as JSONL: the same events in the same order, apart from host
    wall-clock fields."""
    logs = []
    for obs, net, sched, faults, topo in (
            (tobs, tnet, tsched, tfaults, ttopo),
            (jobs, jnet, jsched, jfaults, jtopo)):
        obs.configure(run="parity", meta={"policy": policy})
        try:
            tr = _run(net, sched, faults, topo, "mobile", policy, "vector",
                      plan="chaos", topology=True)
            tr.meta.update({"uplink_bytes_per_client": 636})
            obs.log_trace(tr)
        finally:
            rec = obs.shutdown()
        path = tmp_path / f"{obs.__name__}.jsonl"
        rec.write_jsonl(path)
        logs.append([_strip(e) for e in obs.read_jsonl(path)])
        assert obs.to_perfetto(rec.events)["traceEvents"]
    ours, ref = logs
    assert len(ours) == len(ref) > 10
    for a, b in zip(ours, ref):
        assert a == b


def test_obs_spans_metrics_and_flight_toggle():
    """Spans are no-ops without a recorder; the metrics helpers and the
    flight toggle match the reference's."""
    import jax.numpy as jnp
    import torch
    assert tobs.span("x") is tobs.spans._NULL_SPAN and not tobs.enabled()
    x = np.array([-0.5, 0.1, 0.26, 0.74, 0.99, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        tobs.histogram(torch.from_numpy(x), bins=4).numpy(),
        np.asarray(jobs.histogram(jnp.asarray(x), bins=4)))
    # an f32 sum: summation order may move the last ulps (rtol 1e-6)
    assert math.isclose(float(tobs.counter(torch.from_numpy(x))),
                        float(jobs.counter(jnp.asarray(x))), rel_tol=1e-6)
    assert float(tobs.gauge(2.5)) == float(jobs.gauge(2.5))
    prev = tobs.set_flights(False)
    try:
        assert not tobs.flights_enabled()
        tr = _run(tnet, tsched, tfaults, ttopo, "mobile", "full_sync",
                  "vector")
        assert tr.flights == []
    finally:
        tobs.set_flights(prev)
    buf = tobs.MetricsBuffer()
    buf.record({"loss": torch.tensor(1.5), "hist": torch.arange(3.0),
                "ratio": 4})
    buf.record({"loss": torch.tensor(0.25)})
    assert buf.flush() == [{"loss": 1.5, "hist": [0.0, 1.0, 2.0],
                            "ratio": 4.0}, {"loss": 0.25}]
    assert len(buf) == 0 and buf.flush() == []
    assert math.isclose(tnet.transfer_seconds(8, 64.0), 1.0)

"""Virtual-clock round scheduler for heterogeneous federated fleets.

Twin of ``repro/federated/scheduler.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.federated`` imports jax.

The scheduler owns *time and participation*; it never touches model math.
Each round it asks the caller for a cohort, simulates every client's
round trip on the virtual clock —

    downlink(broadcast) -> local compute x multiplier -> uplink(payload)

— draws dropouts, applies a participation ``Policy`` to decide which
uploads the server aggregates and when the round ends, and then invokes
the caller's ``execute`` hook with the surviving participants. The hook
runs the actual training update; the scheduler records what the
wire and the clock saw into a `Trace`.

Policies
--------
  * ``FullSync``       — wait for every non-dropped upload (the classic
                         synchronous round; the pre-subsystem behavior
                         under the IDEAL profile).
  * ``DropSlowestK``   — over-provision and cut the k slowest uploads
                         (bounded-straggler synchronous FL).
  * ``Deadline``       — hard per-round wall-clock budget; whatever
                         missed it is dropped.
  * ``AsyncBuffer``    — FedBuff-style asynchrony: clients run
                         continuously, the server updates whenever
                         ``buffer_size`` uploads have accumulated. The
                         scheduler hands ``execute`` one staleness weight
                         PER CONTRIBUTION; `FederatedTrainer` applies them
                         per client gradient split (exact FedBuff — see
                         ``core/fedlite.make_weighted_step``), not as a
                         cohort-mean scale on the fused update.

Backends
--------
Two interchangeable event cores produce **bitwise-identical traces**
(tests/test_fleet_scale.py sweeps fleet x policy x cohort asserting it):

  * ``backend="heapq"``  — the original per-arrival Python event loop.
    Every cohort member becomes heap entries and `ClientProfile` method
    calls; O(cohort) Python objects per round. Kept as the reference
    implementation and parity oracle — it is the executable spec.
  * ``backend="vector"`` — the fleet-scale core. The fleet is a
    struct-of-arrays `ClientFleet`; per-round dropout draws, the whole
    cohort's downlink/compute/uplink times, and the policy cut run as
    array ops (one stable argsort + an O(1) prefix cut — the sort
    subsumes the ``np.partition`` selection DropSlowestK alone would
    need, because the trace records participants in arrival order).
    Python appears only at round boundaries: ~10k-client rounds over a
    10^6-client fleet cost milliseconds, not seconds
    (``benchmarks/bench_network.py --fleet-scale`` tracks it).
    `AsyncBuffer` cannot be a pure per-round array op — each completion
    triggers a refill whose dispatch time depends on completion order —
    so its vector core keeps a *lean* heap of ``(time, seq)`` scalar
    tuples while everything per-dispatch (client stream, dropout draws,
    round-trip times, staleness at flush) is precomputed in vectorized
    waves; seq order == stream order == RNG draw order makes that exact.

Parity rests on three invariants, pinned by tests: numpy float64
elementwise ops are the same IEEE doubles as Python's scalar float ops
when associated identically (`ClientFleet.round_trip_seconds` keeps the
``(downlink + compute) + uplink`` order); one ``Generator.random(n)``
call consumes the identical PCG64 stream as ``n`` scalar draws; and a
stable argsort on arrival times reproduces heap pop order because heap
ties break on the cohort sequence number.

Topology: with ``topology=TwoTierTopology(...)`` uploads terminate on
location-clustered edge aggregators that pre-combine their cluster's
payloads before one edge->server backhaul hop (async: store-and-forward
relay) — per-tier times on the virtual clock, per-tier
``edge_uplink/server_uplink`` ledger entries. Both backends call the
same `TwoTierTopology` array helpers, so parity is preserved under a
topology by construction (see ``federated/topology.py``).

Determinism: given the same seed, fleet, policy, cohort stream and
backend, the trace is identical — asserted by tests/test_scheduler.py.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from repro_torch import obs
from repro_torch.obs import flight
from repro_torch.federated.faults import FaultPlan, ServerKilled, make_injector
from repro_torch.federated.network import ClientFleet, ClientProfile
from repro_torch.federated.trace import RoundRecord, Trace


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One completed client upload as seen by the server.

    ``shard`` is the execution placement — which slice of the cohort
    executor's ``clients`` device axis ran this participant's math
    (``federated/executor.py``; 0 for the single-device stacked path).
    Assigned by the executor's ``place`` hook just before ``execute`` and
    recorded per round in ``RoundRecord.shards``.
    """
    client: int
    version: int        # server model version the client computed against
    t_arrival: float    # sim seconds when the upload finished
    shard: int = 0      # executor shard the participant was placed on


# ---------------------------------------------------------------------------
# participation policies
# ---------------------------------------------------------------------------
#
# Each sync policy implements two equivalent cuts:
#   split(arrivals, t_start)          — reference: list of Arrival objects,
#                                       already sorted by (t_arrival, seq).
#   split_vector(t_sorted, t_start)   — vector core: the sorted arrival-time
#                                       array; returns (keep_count, t_end)
#                                       where survivors are the first
#                                       ``keep_count`` sorted entries.
# The prefix-cut form exists because the scheduler hands every policy the
# *stably sorted* arrival vector (the trace needs arrival order anyway), so
# all three cuts are O(1)/O(log n) index arithmetic on it.

class FullSync:
    """Aggregate every upload that was not lost to dropout."""
    name = "full_sync"

    def split(self, arrivals: List[Arrival], t_start: float):
        t_end = max((a.t_arrival for a in arrivals), default=t_start)  # fedlint: disable=python-loop-over-fleet
        return list(arrivals), [], t_end

    def split_vector(self, t_sorted: np.ndarray, t_start: float):
        n = int(t_sorted.shape[0])
        return n, (float(t_sorted[-1]) if n else t_start)


class DropSlowestK:
    """Cut the k slowest uploads; the round closes with the survivors.

    Edge semantics (pinned by tests in BOTH backends):

      * ``k >= len(arrivals)`` keeps exactly ONE survivor — the fastest
        upload — never zero: ``keep = max(len - k, 1)``. Cutting the
        whole cohort would leave the server aggregating nothing while
        still paying the round, so over-provisioned ``k`` degrades to
        "fastest client wins" rather than a silent no-op round.
      * Empty arrivals (the entire cohort dropped out before uploading)
        keep zero and the round ends at ``t_start`` — there was never an
        upload to wait for.
    """

    def __init__(self, k: int):
        if k < 0:
            raise ValueError("k must be >= 0")
        self.k = k
        self.name = f"drop_slowest_{k}"

    def split(self, arrivals: List[Arrival], t_start: float):
        ordered = sorted(arrivals, key=lambda a: a.t_arrival)
        keep = max(len(ordered) - self.k, 1) if ordered else 0
        survivors, cut = ordered[:keep], ordered[keep:]
        t_end = survivors[-1].t_arrival if survivors else t_start
        return survivors, cut, t_end

    def split_vector(self, t_sorted: np.ndarray, t_start: float):
        # selection needs no np.partition: t_sorted arrives fully sorted
        n = int(t_sorted.shape[0])
        keep = max(n - self.k, 1) if n else 0
        return keep, (float(t_sorted[keep - 1]) if keep else t_start)


class Deadline:
    """Hard wall-clock budget per round; late uploads are dropped.

    An upload landing exactly on the cutoff survives (``<=``). With no
    arrivals at all the round still ends at the cutoff — the server
    waits out its budget before deciding nobody came.
    """

    def __init__(self, seconds: float):
        if seconds <= 0:
            raise ValueError("deadline must be positive")
        self.seconds = seconds
        self.name = f"deadline_{seconds:g}s"

    def split(self, arrivals: List[Arrival], t_start: float):
        cutoff = t_start + self.seconds
        survivors = [a for a in arrivals if a.t_arrival <= cutoff]  # fedlint: disable=python-loop-over-fleet
        cut = [a for a in arrivals if a.t_arrival > cutoff]  # fedlint: disable=python-loop-over-fleet
        if cut:
            t_end = cutoff
        else:
            t_end = max((a.t_arrival for a in survivors), default=cutoff)
        return survivors, cut, t_end

    def split_vector(self, t_sorted: np.ndarray, t_start: float):
        n = int(t_sorted.shape[0])
        cutoff = t_start + self.seconds
        keep = int(np.searchsorted(t_sorted, cutoff, side="right"))
        if keep < n:
            return keep, cutoff
        return keep, (float(t_sorted[-1]) if n else cutoff)


class AsyncBuffer:
    """FedBuff-style async aggregation (Nguyen et al. 2022).

    The server updates every ``buffer_size`` arrivals; each contribution
    is discounted by ``staleness_weight(staleness)`` where staleness is
    the number of server updates that happened since the client pulled
    its model. The default ``1/sqrt(1+s)`` is FedBuff's polynomial decay.
    The weights are delivered per contribution (aligned with the buffer
    order) so the executor can discount each client's gradient split by
    its own staleness.
    """

    def __init__(self, buffer_size: int = 4,
                 staleness_weight: Optional[Callable[[int], float]] = None):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self.buffer_size = buffer_size
        self.staleness_weight = staleness_weight or \
            (lambda s: 1.0 / math.sqrt(1.0 + s))
        self.name = f"async_buffer_{buffer_size}"


Policy = Any  # FullSync | DropSlowestK | Deadline | AsyncBuffer

# execute(update_idx, participants, staleness_weights) -> metrics (may stay
# on device; the caller converts at end of run)
ExecuteFn = Callable[[int, Sequence[Arrival], Sequence[float]], Dict]

_BACKENDS = ("auto", "vector", "heapq")


@dataclasses.dataclass
class Scheduler:
    """Round driver over a fixed fleet (`ClientFleet` or profile list).

    ``uplink_bytes`` / ``downlink_bytes`` are the measured per-client
    payload sizes (wire-codec bytes for FedLite, raw activation bytes for
    SplitFed, parameter bytes for FedAvg) — static per run because the
    payload layout is shape-determined.

    ``backend`` selects the event core: ``"vector"`` (fleet-scale array
    core), ``"heapq"`` (per-arrival reference), or ``"auto"`` (vector
    whenever the policy provides ``split_vector`` or is `AsyncBuffer`;
    custom policies exposing only ``split`` fall back to the reference
    loop). Both produce bitwise-identical traces.

    ``topology`` (optional, e.g. `TwoTierTopology`) inserts an edge
    aggregation tier between clients and server — see the module
    docstring and ``federated/topology.py``.

    ``faults`` (optional `FaultPlan`) arms deterministic fault injection:
    mid-round client crashes with bounded retry-and-backoff in virtual
    time (retry downlinks hit the ledger under ``retry_downlink/<kind>``,
    budget-exhausted clients are dropped for the round), async arrival
    jitter, edge outage windows (clients re-home), and a `ServerKilled`
    raise at configured rounds. Fault decisions are stateless hashes —
    they never consume the scheduler RNG — so an all-quiet plan is
    bitwise-identical to no plan, and both backends stay parity-exact
    under any plan (``federated/faults.py``).
    """
    fleet: Sequence[ClientProfile]
    policy: Policy = dataclasses.field(default_factory=FullSync)
    client_step_seconds: float = 1.0
    server_step_seconds: float = 0.0
    seed: int = 0
    backend: str = "auto"
    topology: Optional[Any] = None
    faults: Optional[FaultPlan] = None

    def run(self, rounds: int, *,
            sample_cohort: Callable[[int], Sequence[int]],
            uplink_bytes: int,
            downlink_bytes: int,
            execute: ExecuteFn,
            placement: Optional[Callable[[Sequence[Arrival]],
                                         Sequence[Arrival]]] = None,
            wire_kinds: Optional[Tuple[str, str]] = None,
            cursor: Optional[Dict[str, Any]] = None,
            on_round: Optional[Callable[[int, Dict[str, Any]], None]] = None,
            ) -> Trace:
        """Drive ``rounds`` server updates.

        ``placement`` (optional) maps each update's surviving participants
        to shard-annotated `Arrival`s just before ``execute`` — the cohort
        executor's ``place`` hook — so the cohort the executor runs and
        the cohort the trace records carry the same device placement.

        ``wire_kinds`` (optional) is the ``(uplink, downlink)`` wire-kind
        pair behind the per-client payload bytes ("pq", "dense",
        "sparse", "scalar", "pq-delta"); when given, every `RoundRecord`
        carries a ``ledger`` of per-direction, per-kind byte totals —
        split into ``edge_uplink``/``server_uplink`` tiers when a
        topology is installed.

        ``cursor`` / ``on_round`` are the crash-recovery hooks (sync
        policies only — async in-flight heaps are not checkpointable).
        A cursor ``{"round", "t", "rng"}`` resumes the virtual clock and
        RNG stream exactly where a previous run's cursor left them;
        ``rounds`` stays the absolute end index. ``on_round(rd, cursor)``
        fires after each completed round with the cursor that would
        resume AFTER it — what a checkpoint must save. The returned
        trace's ``cursor`` field holds the final resume point.
        """
        place = placement or (lambda parts: list(parts))
        # flight shard attribution only happens under a real placement
        # hook: without one every Arrival carries the default shard and
        # the per-flight column keeps its -1 "unplaced" marker — skipping
        # the id-matching scatter entirely on placement-free runs
        self._attribute_shards = placement is not None
        if self.topology is not None:
            self.topology.ensure(len(self.fleet))
        backend = self._resolve_backend()
        is_async = isinstance(self.policy, AsyncBuffer)
        inj = make_injector(self.faults)
        if is_async:
            if cursor is not None or on_round is not None:
                raise ValueError(
                    "cursor/on_round checkpoint-resume is only supported "
                    "for synchronous policies: the async in-flight heap "
                    "is not part of the checkpointable state")
            runner = self._run_async_vector if backend == "vector" \
                else self._run_async
            return runner(rounds, sample_cohort, uplink_bytes,
                          downlink_bytes, execute, place, wire_kinds, inj)
        runner = self._run_sync_vector if backend == "vector" \
            else self._run_sync
        return runner(rounds, sample_cohort, uplink_bytes, downlink_bytes,
                      execute, place, wire_kinds, inj, cursor, on_round)

    def _resolve_backend(self) -> str:
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown scheduler backend {self.backend!r}; "
                f"expected one of {_BACKENDS}")
        vectorizable = isinstance(self.policy, AsyncBuffer) or \
            hasattr(self.policy, "split_vector")
        if self.backend == "vector" and not vectorizable:
            raise ValueError(
                f"policy {getattr(self.policy, 'name', self.policy)!r} has "
                "no split_vector; use backend='heapq' or 'auto'")
        if self.backend == "auto":
            return "vector" if vectorizable else "heapq"
        return self.backend

    # ---- shared -----------------------------------------------------------
    def _round_trip(self, p: ClientProfile, uplink_bytes: int,
                    downlink_bytes: int) -> float:
        return (p.downlink_seconds(downlink_bytes)
                + p.compute_seconds(self.client_step_seconds)
                + p.uplink_seconds(uplink_bytes))

    @staticmethod
    def _ledger(wire_kinds: Optional[Tuple[str, str]],
                uplink_total: int, downlink_total: int,
                tier_bytes: Optional[Tuple[int, int]] = None,
                retry_bytes: int = 0) -> Dict[str, int]:
        """Per-direction, per-wire-kind byte entries for one record.

        Flat star topology keys uplink traffic as ``uplink/<kind>``;
        under a two-tier topology the same traffic splits into
        ``edge_uplink/<kind>`` (client->edge, every completed upload) and
        ``server_uplink/<kind>`` (edge->server backhaul) via
        ``tier_bytes=(edge_total, server_total)``. ``retry_bytes`` is the
        fault-injected crash-retry re-broadcast traffic, ledgered under
        its own ``retry_downlink/<kind>`` key so wasted bytes are
        auditable separately from the first dispatch.
        """
        if wire_kinds is None:
            return {}
        up_kind, down_kind = wire_kinds
        if tier_bytes is None:
            entries = {f"uplink/{up_kind}": uplink_total}
        else:
            entries = {f"edge_uplink/{up_kind}": tier_bytes[0],
                       f"server_uplink/{up_kind}": tier_bytes[1]}
        entries[f"downlink/{down_kind}"] = downlink_total
        if retry_bytes:
            entries[f"retry_downlink/{down_kind}"] = retry_bytes
        return entries

    def _sync_uplink_accounting(self, n_arrivals: int, uplink_bytes: int,
                                survivor_clients: np.ndarray,
                                survivor_t: np.ndarray, t_policy_end: float,
                                down_edges: Sequence[int] = (),
                                ) -> Tuple[float, int, Optional[Tuple[int, int]],
                                           Optional[int]]:
        """Apply the topology tier (if any) to one sync round's cut.

        Returns ``(t_end, uplink_total, tier_bytes, edges)`` — shared by
        both backends so their topology arithmetic is the same code.
        ``down_edges`` (fault injection) marks edge aggregators in an
        outage window; their clients re-home inside ``sync_round``.
        """
        flat_total = n_arrivals * uplink_bytes
        if self.topology is None:
            return float(t_policy_end), flat_total, None, None
        t_end, edges, server_bytes = self.topology.sync_round(
            survivor_clients, survivor_t, t_policy_end, uplink_bytes,
            down_edges=down_edges)
        return t_end, flat_total + server_bytes, \
            (flat_total, server_bytes), edges

    # ---- synchronous policies: reference heapq backend --------------------
    def _run_sync(self, rounds, sample_cohort, uplink_bytes, downlink_bytes,
                  execute, place, wire_kinds=None, inj=None, cursor=None,
                  on_round=None) -> Trace:
        rng = np.random.default_rng(self.seed)
        trace = Trace()
        t = 0.0
        start = 0
        if cursor is not None:
            start = int(cursor["round"])
            t = float(cursor["t"])
            rng.bit_generator.state = cursor["rng"]
        crash_on = inj is not None and inj.plan.crash_rate > 0
        rec_fl = flight.flights_enabled()
        for rd in range(start, rounds):
            if inj is not None and inj.server_killed(rd):
                raise ServerKilled(rd)
            faults: Dict[str, int] = {}
            with obs.span("scheduler.round", cat="scheduler", round=rd):
                ids = [int(c) for c in sample_cohort(rd)]
                dropouts: List[int] = []
                heap: List[Tuple[float, int, int]] = []
                gone_ids: List[int] = []
                retry_dl = 0
                # per-cohort-position arrival times for the flight frame
                # (NaN = dropout / retry budget exhausted); filled with the
                # exact scalars pushed on the heap, so the recorded column
                # is bitwise-identical to the vector backend's array form
                arr_by_pos = np.full(len(ids), np.nan) if rec_fl else None
                if not crash_on:
                    for seq, cid in enumerate(ids):
                        p = self.fleet[cid]
                        if rng.random() < p.dropout_prob:
                            dropouts.append(cid)
                            continue
                        dt = self._round_trip(p, uplink_bytes, downlink_bytes)
                        t_arr = t + dt
                        heapq.heappush(heap, (t_arr, seq, cid))
                        if arr_by_pos is not None:
                            arr_by_pos[seq] = t_arr
                else:
                    # benign dropout draws FIRST (same RNG order as the
                    # fault-free path), then stateless crash/retry draws
                    # over the live set — collect-then-push so the retry
                    # arithmetic runs through the same vectorized helper
                    # as the vector backend
                    live: List[Tuple[int, int, float, float]] = []
                    for seq, cid in enumerate(ids):
                        p = self.fleet[cid]
                        if rng.random() < p.dropout_prob:
                            dropouts.append(cid)
                            continue
                        live.append((
                            seq, cid,
                            self._round_trip(p, uplink_bytes, downlink_bytes),
                            p.downlink_seconds(downlink_bytes)
                            + p.compute_seconds(self.client_step_seconds)))
                    crashes = inj.crash_attempts_sync(
                        rd, np.asarray([c for _, c, _, _ in live], np.int64))
                    extra, gone = inj.retry_overhead(
                        crashes, np.asarray([dc for *_, dc in live]))
                    xdl = inj.extra_downlinks(crashes, gone)
                    retry_dl = int(xdl.sum())
                    for (seq, cid, dt, _), ex, g in zip(live, extra, gone):
                        if g:
                            gone_ids.append(cid)
                            continue
                        t_arr = t + (float(ex) + dt)
                        heapq.heappush(heap, (t_arr, seq, cid))
                        if arr_by_pos is not None:
                            arr_by_pos[seq] = t_arr
                    n_crashes = int(crashes.sum())
                    if n_crashes:
                        faults["crashes"] = n_crashes
                        faults["retries"] = retry_dl
                    if gone_ids:
                        faults["crash_dropped"] = len(gone_ids)
                arrivals: List[Arrival] = []
                arrival_seqs: List[int] = []
                while heap:
                    t_arr, sq, cid = heapq.heappop(heap)
                    arrivals.append(Arrival(cid, rd, t_arr))
                    arrival_seqs.append(sq)
                survivors, cut, t_end = self.policy.split(arrivals, t)
                down = inj.down_edges(t) \
                    if inj is not None and self.topology is not None else ()
                t_end, uplink_total, tier_bytes, edges = \
                    self._sync_uplink_accounting(
                        len(arrivals), uplink_bytes,
                        np.asarray([a.client for a in survivors], np.int64),
                        np.asarray([a.t_arrival for a in survivors]), t_end,
                        down)
                if down:
                    faults["edges_down"] = len(down)
                    rehomed = getattr(self.topology, "last_rehomed", 0)
                    if rehomed:
                        faults["rehomed"] = rehomed
                t_end += self.server_step_seconds
                fl_frame = None
                if rec_fl:
                    # survivors/cut are the SAME Arrival objects the pop
                    # loop appended (policies sort/filter, never copy), so
                    # identity maps each back to its cohort position
                    seq_of = {id(a): s for a, s in
                              zip(arrivals, arrival_seqs)}  # fedlint: disable=python-loop-over-fleet
                    fl_kw = {}
                    if crash_on:
                        fl_kw = dict(
                            live_pos=np.asarray([sq for sq, *_ in live],
                                                np.int64),
                            crashes=crashes, extra_downlinks=xdl,
                            retry_seconds=extra, gone=gone)
                    fl_frame = flight.sync_frame(
                        rd, t, np.asarray(ids, np.int64), arr_by_pos,
                        np.asarray([seq_of[id(a)] for a in survivors],
                                   np.int64),
                        np.asarray([seq_of[id(a)] for a in cut], np.int64),
                        topology=self.topology, down_edges=down, **fl_kw)
                survivors = place(survivors)
                if fl_frame is not None and self._attribute_shards:
                    flight.assign_shards(fl_frame, survivors)
                metrics = execute(rd, survivors, [1.0] * len(survivors)) \
                    if survivors else {}
            span_extra = {} if edges is None else {"edges": edges}
            obs.virtual_span("scheduler.round", t, t_end, round=rd,
                             participants=len(survivors),
                             dropped=len(dropouts) + len(gone_ids) + len(cut),
                             **span_extra)
            if cut:
                obs.event("policy.cut", cat="scheduler", lane="virtual",
                          t=t_end, round=rd,
                          policy=getattr(self.policy, "name", "?"),
                          cut=[a.client for a in cut])
            if faults:
                obs.event("fault.round", cat="faults", lane="virtual",
                          t=t_end, round=rd, **faults)
            trace.append(RoundRecord(
                round=rd, t_start=t, t_end=t_end,
                participants=tuple(a.client for a in survivors),
                dropped=tuple(dropouts) + tuple(gone_ids)
                + tuple(a.client for a in cut),
                # every completed upload crossed a wire, aggregated or not;
                # under a topology this is both tiers' traffic
                uplink_bytes=uplink_total,
                downlink_bytes=(len(ids) + retry_dl) * downlink_bytes,
                staleness=(0,) * len(survivors),
                shards=tuple(a.shard for a in survivors),
                metrics=metrics,
                ledger=self._ledger(wire_kinds, uplink_total,
                                    len(ids) * downlink_bytes, tier_bytes,
                                    retry_dl * downlink_bytes),
                faults=faults))
            if fl_frame is not None:
                trace.flights.append(fl_frame)
            t = t_end
            if on_round is not None:
                on_round(rd, {"round": rd + 1, "t": t,
                              "rng": rng.bit_generator.state})
        trace.cursor = {"round": rounds, "t": t,
                        "rng": rng.bit_generator.state}
        return trace

    # ---- synchronous policies: vectorized fleet-scale backend -------------
    def _run_sync_vector(self, rounds, sample_cohort, uplink_bytes,
                         downlink_bytes, execute, place,
                         wire_kinds=None, inj=None, cursor=None,
                         on_round=None) -> Trace:
        """Whole-cohort array core; Python only at round boundaries.

        Per round: one vectorized dropout draw over the cohort (same RNG
        stream as the reference's per-member scalar draws), one gathered
        round-trip computation over the live members, one stable argsort
        (reproducing heap pop order: ties break on cohort seq in both),
        and an O(1) policy prefix cut. `Arrival` objects materialize for
        survivors only — the executor/trace API stays object-based while
        the 10^4..10^6-element math never touches Python.
        """
        fleet = ClientFleet.from_any(self.fleet)
        rng = np.random.default_rng(self.seed)
        trace = Trace()
        t = 0.0
        start = 0
        if cursor is not None:
            start = int(cursor["round"])
            t = float(cursor["t"])
            rng.bit_generator.state = cursor["rng"]
        crash_on = inj is not None and inj.plan.crash_rate > 0
        rec_fl = flight.flights_enabled()
        for rd in range(start, rounds):
            if inj is not None and inj.server_killed(rd):
                raise ServerKilled(rd)
            faults: Dict[str, int] = {}
            with obs.span("scheduler.round", cat="scheduler", round=rd):
                ids = np.asarray([int(c) for c in sample_cohort(rd)],
                                 dtype=np.int64)
                draws = rng.random(ids.shape[0])
                alive = draws >= fleet.dropout_prob[ids]
                dropouts = ids[~alive]
                live = ids[alive]
                dt = fleet.round_trip_seconds(live, uplink_bytes,
                                              downlink_bytes,
                                              self.client_step_seconds)
                gone_ids = np.empty(0, np.int64)
                retry_dl = 0
                if not crash_on:
                    t_arrivals = t + dt
                    arr_all = t_arrivals
                else:
                    crashes = inj.crash_attempts_sync(rd, live)
                    extra, gone = inj.retry_overhead(
                        crashes, fleet.downlink_compute_seconds(
                            live, downlink_bytes, self.client_step_seconds))
                    xdl = inj.extra_downlinks(crashes, gone)
                    retry_dl = int(xdl.sum())
                    gone_ids = live[gone]
                    arr_all = t + (extra + dt)
                    t_arrivals = arr_all[~gone]
                    live = live[~gone]
                    n_crashes = int(crashes.sum())
                    if n_crashes:
                        faults["crashes"] = n_crashes
                        faults["retries"] = retry_dl
                    if gone_ids.shape[0]:
                        faults["crash_dropped"] = int(gone_ids.shape[0])
                order = np.argsort(t_arrivals, kind="stable")
                t_sorted = t_arrivals[order]
                cid_sorted = live[order]
                keep, t_end = self.policy.split_vector(t_sorted, t)
                n_arrivals = int(t_sorted.shape[0])
                down = inj.down_edges(t) \
                    if inj is not None and self.topology is not None else ()
                t_end, uplink_total, tier_bytes, edges = \
                    self._sync_uplink_accounting(
                        n_arrivals, uplink_bytes, cid_sorted[:keep],
                        t_sorted[:keep], t_end, down)
                if down:
                    faults["edges_down"] = len(down)
                    rehomed = getattr(self.topology, "last_rehomed", 0)
                    if rehomed:
                        faults["rehomed"] = rehomed
                t_end += self.server_step_seconds
                fl_frame = None
                if rec_fl:
                    # scatter the already-computed arrival/fault columns
                    # back to cohort positions — pure array ops, O(cohort)
                    alive_pos = np.nonzero(alive)[0]
                    arr_by_pos = np.full(int(ids.shape[0]), np.nan)
                    if crash_on:
                        arr_by_pos[alive_pos] = np.where(gone, np.nan,
                                                         arr_all)
                        sorted_pos = alive_pos[~gone][order]
                        fl_kw = dict(live_pos=alive_pos, crashes=crashes,
                                     extra_downlinks=xdl,
                                     retry_seconds=extra, gone=gone)
                    else:
                        arr_by_pos[alive_pos] = arr_all
                        sorted_pos = alive_pos[order]
                        fl_kw = {}
                    fl_frame = flight.sync_frame(
                        rd, t, ids, arr_by_pos, sorted_pos[:keep],
                        sorted_pos[keep:], topology=self.topology,
                        down_edges=down, **fl_kw)
                survivors = [Arrival(c, rd, ta) for c, ta in
                             zip(cid_sorted[:keep].tolist(),
                                 t_sorted[:keep].tolist())]
                cut_clients = cid_sorted[keep:].tolist()
                survivors = place(survivors)
                if fl_frame is not None and self._attribute_shards:
                    flight.assign_shards(fl_frame, survivors)
                metrics = execute(rd, survivors, [1.0] * len(survivors)) \
                    if survivors else {}
            span_extra = {} if edges is None else {"edges": edges}
            obs.virtual_span("scheduler.round", t, t_end, round=rd,
                             participants=len(survivors),
                             dropped=int(dropouts.shape[0])
                             + int(gone_ids.shape[0]) + len(cut_clients),
                             **span_extra)
            if cut_clients:
                obs.event("policy.cut", cat="scheduler", lane="virtual",
                          t=t_end, round=rd,
                          policy=getattr(self.policy, "name", "?"),
                          cut=cut_clients)
            if faults:
                obs.event("fault.round", cat="faults", lane="virtual",
                          t=t_end, round=rd, **faults)
            trace.append(RoundRecord(
                round=rd, t_start=t, t_end=t_end,
                participants=tuple(a.client for a in survivors),
                dropped=tuple(dropouts.tolist()) + tuple(gone_ids.tolist())
                + tuple(cut_clients),
                uplink_bytes=uplink_total,
                downlink_bytes=(int(ids.shape[0]) + retry_dl)
                * downlink_bytes,
                staleness=(0,) * len(survivors),
                shards=tuple(a.shard for a in survivors),
                metrics=metrics,
                ledger=self._ledger(wire_kinds, uplink_total,
                                    int(ids.shape[0]) * downlink_bytes,
                                    tier_bytes, retry_dl * downlink_bytes),
                faults=faults))
            if fl_frame is not None:
                trace.flights.append(fl_frame)
            t = t_end
            if on_round is not None:
                on_round(rd, {"round": rd + 1, "t": t,
                              "rng": rng.bit_generator.state})
        trace.cursor = {"round": rounds, "t": t,
                        "rng": rng.bit_generator.state}
        return trace

    # ---- async buffer: reference heapq backend ----------------------------
    def _run_async(self, rounds, sample_cohort, uplink_bytes, downlink_bytes,
                   execute, place, wire_kinds=None, inj=None) -> Trace:
        """FedBuff loop: the initial cohort sets the concurrency; every
        completed (or dropped) slot is refilled with the next client from a
        fresh-cohort stream, so the whole population keeps rotating through
        the in-flight set just as sync rounds resample each round."""
        policy: AsyncBuffer = self.policy
        rng = np.random.default_rng(self.seed)
        trace = Trace()
        # async edges relay each contribution (no pre-combination: staleness
        # weights are per contribution, known only at server flush)
        relay_hop = 0.0 if self.topology is None else \
            self.topology.relay_hop_seconds(uplink_bytes)
        # heap entries: (t_arrival, seq, client, version, was_dropped)
        heap: List[Tuple[float, int, int, int, bool]] = []
        seq = 0
        version = 0
        wave = 0
        queue: List[int] = []
        # per-flush-window fault counters (accounted at dispatch time, the
        # point both backends share; crash keys on the dispatch stream seq)
        fw = {"crashes": 0, "crash_dropped": 0, "retries": 0, "jittered": 0}
        rec_fl = flight.flights_enabled()
        # per-seq flight columns (dispatch order == stream order, matching
        # the vector backend's s_* arrays element by element)
        fl_cid: List[int] = []
        fl_t0: List[float] = []
        fl_drop: List[bool] = []
        fl_crash: List[int] = []
        fl_rdl: List[int] = []
        fl_rs: List[float] = []
        fl_gone: List[bool] = []
        win_done: List[Tuple[int, float]] = []  # (seq, t_pop) this window

        def next_client() -> int:
            nonlocal wave
            if not queue:
                queue.extend(int(c) for c in sample_cohort(wave))
                wave += 1
            return queue.pop(0)

        def dispatch(cid: int, t: float, ver: int):
            nonlocal seq
            p = self.fleet[cid]
            dropped = bool(rng.random() < p.dropout_prob)
            raw_drop = dropped          # pre-override benign dropout draw
            n_crash = n_rdl = 0
            r_s = 0.0
            is_gone = False
            dt = self._round_trip(p, uplink_bytes, downlink_bytes) + relay_hop
            if inj is not None:
                # scalar path == vectorized helpers on singleton arrays
                s_arr = np.asarray([seq], np.int64)
                c_arr = np.asarray([cid], np.int64)
                crashes = inj.crash_attempts_async(s_arr, c_arr)
                extra, gone = inj.retry_overhead(
                    crashes, np.asarray([p.downlink_seconds(downlink_bytes)
                                         + p.compute_seconds(
                                             self.client_step_seconds)]))
                jitter = inj.reorder_jitter(c_arr, s_arr)
                dt = (dt + float(extra[0])) + float(jitter[0])
                n_crash = int(crashes[0])
                n_rdl = int(inj.extra_downlinks(crashes, gone)[0])
                r_s = float(extra[0])
                is_gone = bool(gone[0])
                fw["crashes"] += n_crash
                fw["retries"] += n_rdl
                if jitter[0] > 0:
                    fw["jittered"] += 1
                if is_gone:
                    fw["crash_dropped"] += 1
                    dropped = True   # retry budget exhausted: lost slot
            if rec_fl:
                fl_cid.append(cid)
                fl_t0.append(t)
                fl_drop.append(raw_drop)
                fl_crash.append(n_crash)
                fl_rdl.append(n_rdl)
                fl_rs.append(r_s)
                fl_gone.append(is_gone)
            heapq.heappush(heap, (t + dt, seq, cid, ver, dropped))
            seq += 1

        for cid in sample_cohort(wave):
            dispatch(int(cid), 0.0, version)
        wave += 1

        buffer: List[Arrival] = []
        dropped_accum: List[int] = []
        dispatches = len(heap)   # downlink pushes since last flush
        t_round_start = 0.0
        updates = 0
        # termination guard: a fleet that only ever drops out would otherwise
        # spin the virtual clock forever without filling the buffer
        consecutive_drops = 0
        max_consecutive_drops = max(1000, 10 * len(self.fleet))
        while updates < rounds and heap:
            t_arr, sq, cid, ver, was_dropped = heapq.heappop(heap)
            if was_dropped:
                if rec_fl:
                    win_done.append((sq, t_arr))
                dropped_accum.append(cid)
                dispatch(next_client(), t_arr, version)
                dispatches += 1
                consecutive_drops += 1
                if consecutive_drops >= max_consecutive_drops:
                    logger.warning(
                        "async scheduler: %d consecutive dropouts with no "
                        "progress after %d updates; stopping early",
                        consecutive_drops, updates)
                    break
                continue
            consecutive_drops = 0
            buffer.append(Arrival(cid, ver, t_arr))
            if rec_fl:
                win_done.append((sq, t_arr))
            if len(buffer) >= policy.buffer_size:
                if inj is not None and inj.server_killed(updates):
                    raise ServerKilled(updates)
                t_end = t_arr + self.server_step_seconds
                # place BEFORE computing weights so staleness stays aligned
                # with the (possibly reordered) cohort execute receives
                buffer = place(buffer)
                staleness = [version - a.version for a in buffer]
                weights = [policy.staleness_weight(s) for s in staleness]
                with obs.span("scheduler.flush", cat="scheduler",
                              update=updates, buffered=len(buffer)):
                    metrics = execute(updates, buffer, weights)
                obs.virtual_span("scheduler.flush", t_round_start, t_end,
                                 update=updates, buffered=len(buffer),
                                 staleness_max=max(staleness))
                fl_frame = None
                if rec_fl:
                    # frame over the flights that TERMINATED this window
                    # (fault counters accrue at dispatch time instead, so
                    # async ledger<->flight reconciliation is approximate;
                    # sync rounds reconcile exactly — see repro.obs.flight)
                    fl_frame = flight.async_frame(
                        updates, win_done, fl_cid, fl_t0, fl_drop,
                        fl_crash, fl_rdl, fl_rs, fl_gone,
                        topology=self.topology)
                    if self._attribute_shards:
                        flight.assign_shards(fl_frame, buffer)
                version += 1
                dispatch(next_client(), t_arr, version)  # slot sees new model
                dispatches += 1
                flat_total = len(buffer) * uplink_bytes
                tier_bytes = None if self.topology is None else \
                    (flat_total, flat_total)   # relayed 1:1, no combine
                uplink_total = flat_total if tier_bytes is None else \
                    tier_bytes[0] + tier_bytes[1]
                retry_dl = fw["retries"]
                faults = {k: v for k, v in fw.items() if v}
                if faults:
                    obs.event("fault.flush", cat="faults", lane="virtual",
                              t=t_end, round=updates, **faults)
                trace.append(RoundRecord(
                    round=updates, t_start=t_round_start, t_end=t_end,
                    participants=tuple(a.client for a in buffer),
                    dropped=tuple(dropped_accum),
                    uplink_bytes=uplink_total,
                    downlink_bytes=(dispatches + retry_dl) * downlink_bytes,
                    staleness=tuple(staleness),
                    shards=tuple(a.shard for a in buffer),
                    metrics=metrics,
                    ledger=self._ledger(wire_kinds, uplink_total,
                                        dispatches * downlink_bytes,
                                        tier_bytes,
                                        retry_bytes=retry_dl * downlink_bytes),
                    faults=faults))
                if fl_frame is not None:
                    trace.flights.append(fl_frame)
                buffer, dropped_accum, dispatches = [], [], 0
                win_done = []
                fw = {k: 0 for k in fw}
                t_round_start = t_end
                updates += 1
            else:
                dispatch(next_client(), t_arr, version)
                dispatches += 1
        return trace

    # ---- async buffer: vectorized fleet-scale backend ---------------------
    def _run_async_vector(self, rounds, sample_cohort, uplink_bytes,
                          downlink_bytes, execute, place,
                          wire_kinds=None, inj=None) -> Trace:
        """Lean-heap FedBuff core over a vectorized dispatch stream.

        Asynchrony is inherently sequential — each completion triggers a
        refill dispatch whose time depends on completion order — so a
        heap survives; but its entries shrink to ``(time, seq)`` scalar
        tuples and ALL per-dispatch work is precomputed in waves:
        dispatch order consumes the cohort stream FIFO, so seq == stream
        index == RNG draw order, and each wave's dropout draws and round
        trips are single array ops. Staleness at flush is vectorized
        against the per-seq version array. Fault draws hash on the stream
        seq (never the RNG), so each wave's crash/retry/jitter columns
        are one vectorized injector call, bitwise-matching the heapq
        backend's singleton-array calls element by element.
        """
        policy: AsyncBuffer = self.policy
        fleet = ClientFleet.from_any(self.fleet)
        rng = np.random.default_rng(self.seed)
        trace = Trace()
        relay_hop = 0.0 if self.topology is None else \
            self.topology.relay_hop_seconds(uplink_bytes)

        # dispatch stream, extended one vectorized wave at a time
        s_cid = np.empty(0, np.int64)     # stream idx -> client id
        s_drop = np.empty(0, bool)        # stream idx -> dropout draw
        s_dt = np.empty(0, np.float64)    # stream idx -> round-trip time
        s_ver: List[int] = []             # stream idx -> model version seen
        # fault columns (only populated when inj is active)
        s_gone = np.empty(0, bool)        # retry budget exhausted -> lost
        s_crash = np.empty(0, np.int64)   # crashed attempts before success
        s_retry = np.empty(0, np.int64)   # extra downlink dispatches
        s_jit = np.empty(0, bool)         # reorder jitter applied
        wave = 0
        consumed = 0                      # next unused stream index
        fw = {"crashes": 0, "crash_dropped": 0, "retries": 0, "jittered": 0}
        rec_fl = flight.flights_enabled()
        s_t0: List[float] = []            # stream idx -> dispatch time
        s_extra = np.empty(0, np.float64)  # stream idx -> retry seconds
        win_done: List[Tuple[int, float]] = []  # (seq, t_pop) this window

        def extend_stream():
            nonlocal s_cid, s_drop, s_dt, wave
            nonlocal s_gone, s_crash, s_retry, s_jit, s_extra
            ids = np.asarray([int(c) for c in sample_cohort(wave)],
                             dtype=np.int64)
            wave += 1
            draws = rng.random(ids.shape[0])
            dts = fleet.round_trip_seconds(ids, uplink_bytes, downlink_bytes,
                                           self.client_step_seconds) \
                + relay_hop
            if inj is not None and ids.shape[0]:
                base = s_cid.shape[0]
                seqs = np.arange(base, base + ids.shape[0], dtype=np.int64)
                crashes = inj.crash_attempts_async(seqs, ids)
                extra, gone = inj.retry_overhead(
                    crashes, fleet.downlink_compute_seconds(
                        ids, downlink_bytes, self.client_step_seconds))
                jitter = inj.reorder_jitter(ids, seqs)
                dts = (dts + extra) + jitter
                s_gone = np.concatenate([s_gone, gone])
                s_crash = np.concatenate([s_crash, crashes])
                s_retry = np.concatenate(
                    [s_retry, inj.extra_downlinks(crashes, gone)])
                s_jit = np.concatenate([s_jit, jitter > 0])
                if rec_fl:
                    s_extra = np.concatenate([s_extra, extra])
            s_cid = np.concatenate([s_cid, ids])
            s_drop = np.concatenate([s_drop, draws < fleet.dropout_prob[ids]])
            s_dt = np.concatenate([s_dt, dts])
            return int(ids.shape[0])

        heap: List[Tuple[float, int]] = []   # (t_arrival, seq)

        def dispatch(t: float, ver: int):
            """Launch the next stream client at virtual time ``t``."""
            nonlocal consumed
            while consumed >= s_cid.shape[0]:
                if extend_stream() == 0:
                    raise ValueError("sample_cohort returned an empty cohort "
                                     "while async slots need refilling")
            s = consumed
            consumed += 1
            s_ver.append(ver)
            if rec_fl:
                s_t0.append(t)
            if inj is not None:
                # counters accrue at consume time — the point the heapq
                # backend draws the same hashes on singleton arrays
                fw["crashes"] += int(s_crash[s])
                fw["retries"] += int(s_retry[s])
                if s_jit[s]:
                    fw["jittered"] += 1
                if s_gone[s]:
                    fw["crash_dropped"] += 1
            heapq.heappush(heap, (t + float(s_dt[s]), s))

        first_wave = extend_stream()
        for _ in range(first_wave):
            dispatch(0.0, 0)

        version = 0
        buffer: List[Tuple[float, int]] = []   # (t_arrival, stream idx)
        dropped_accum: List[int] = []
        dispatches = len(heap)
        t_round_start = 0.0
        updates = 0
        consecutive_drops = 0
        max_consecutive_drops = max(1000, 10 * len(fleet))
        while updates < rounds and heap:
            t_arr, s = heapq.heappop(heap)
            if s_drop[s] or (inj is not None and s_gone[s]):
                if rec_fl:
                    win_done.append((s, t_arr))
                dropped_accum.append(int(s_cid[s]))
                dispatch(t_arr, version)
                dispatches += 1
                consecutive_drops += 1
                if consecutive_drops >= max_consecutive_drops:
                    logger.warning(
                        "async scheduler: %d consecutive dropouts with no "
                        "progress after %d updates; stopping early",
                        consecutive_drops, updates)
                    break
                continue
            consecutive_drops = 0
            buffer.append((t_arr, s))
            if rec_fl:
                win_done.append((s, t_arr))
            if len(buffer) >= policy.buffer_size:
                if inj is not None and inj.server_killed(updates):
                    raise ServerKilled(updates)
                t_end = t_arr + self.server_step_seconds
                cohort = [Arrival(int(s_cid[i]), s_ver[i], ta)
                          for ta, i in buffer]
                cohort = place(cohort)
                stal = version - np.asarray([a.version for a in cohort])
                staleness = [int(x) for x in stal]
                weights = [policy.staleness_weight(x) for x in staleness]
                with obs.span("scheduler.flush", cat="scheduler",
                              update=updates, buffered=len(cohort)):
                    metrics = execute(updates, cohort, weights)
                obs.virtual_span("scheduler.flush", t_round_start, t_end,
                                 update=updates, buffered=len(cohort),
                                 staleness_max=max(staleness))
                fl_frame = None
                if rec_fl:
                    armed = inj is not None
                    fl_frame = flight.async_frame(
                        updates, win_done, s_cid, s_t0, s_drop,
                        s_crash if armed else None,
                        s_retry if armed else None,
                        s_extra if armed else None,
                        s_gone if armed else None,
                        topology=self.topology)
                    if self._attribute_shards:
                        flight.assign_shards(fl_frame, cohort)
                version += 1
                dispatch(t_arr, version)   # refilled slot sees new model
                dispatches += 1
                flat_total = len(cohort) * uplink_bytes
                tier_bytes = None if self.topology is None else \
                    (flat_total, flat_total)
                uplink_total = flat_total if tier_bytes is None else \
                    tier_bytes[0] + tier_bytes[1]
                retry_dl = fw["retries"]
                faults = {k: v for k, v in fw.items() if v}
                if faults:
                    obs.event("fault.flush", cat="faults", lane="virtual",
                              t=t_end, round=updates, **faults)
                trace.append(RoundRecord(
                    round=updates, t_start=t_round_start, t_end=t_end,
                    participants=tuple(a.client for a in cohort),
                    dropped=tuple(dropped_accum),
                    uplink_bytes=uplink_total,
                    downlink_bytes=(dispatches + retry_dl) * downlink_bytes,
                    staleness=tuple(staleness),
                    shards=tuple(a.shard for a in cohort),
                    metrics=metrics,
                    ledger=self._ledger(wire_kinds, uplink_total,
                                        dispatches * downlink_bytes,
                                        tier_bytes,
                                        retry_bytes=retry_dl * downlink_bytes),
                    faults=faults))
                if fl_frame is not None:
                    trace.flights.append(fl_frame)
                buffer, dropped_accum, dispatches = [], [], 0
                win_done = []
                fw = {k: 0 for k in fw}
                t_round_start = t_end
                updates += 1
            else:
                dispatch(t_arr, version)
                dispatches += 1
        return trace


def ideal_scheduler(num_clients: int, *, seed: int = 0) -> Scheduler:
    """The pre-subsystem simulation: identical infinitely-fast clients,
    no dropout, full synchronization — bitwise-preserves the original
    `FederatedTrainer` trajectory (tests/test_scheduler.py)."""
    from repro_torch.federated.network import uniform_fleet
    return Scheduler(fleet=uniform_fleet(num_clients), policy=FullSync(),
                     client_step_seconds=1.0, seed=seed)

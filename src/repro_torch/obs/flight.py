"""Contribution flight recorder: per-contribution causal lifecycle.

Twin of ``repro/obs/flight.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.obs`` imports jax.

A **flight** is one cohort contribution's journey through a round:

    sampled -> placed (edge / executor shard) -> uplink in flight ->
    {retry(n) / re-home / quarantined / dropped} -> edge pre-combine ->
    server aggregate

Every flight gets a stable ``flight_id`` — ``r<round>-c<client>-s<seq>``
where ``seq`` is the cohort position (sync) or the dispatch-stream index
(async). All three components are backend-invariant (heap ties break on
seq; the vector core sorts stably; the async stream is consumed FIFO in
both backends), so the heapq and vector schedulers produce **identical
flight sets** — asserted in tests/test_fleet_scale.py.

Recording is column-oriented and O(cohort) per round: each server update
appends one `FlightFrame` (a struct-of-arrays over the round's sampled
contributions) to ``Trace.flights``. The scheduler assembles frames from
the SAME arrays its vector core already computes — no per-client Python
in the hot path (fedlint's ``python-loop-over-fleet`` stays clean) — and
the heapq reference backend scatters its per-arrival scalars into
bitwise-identical columns. Frames survive kill-and-resume: they ride the
`federated/recovery.py` snapshot meta json via `to_json`/`from_json`.

The obs event log stays *sublinear* in the fleet: `log_frames` (called
from ``obs.log_trace``) emits one ``flight.rollup`` event per frame
(state counts + per-edge histograms via ``np.bincount``) plus a
deterministic, hash-reservoir sample of **exemplar** flights whose full
lifecycle becomes linked events — fault-affected flights (retried,
re-homed, quarantined, cut, crash-dropped) are prioritized so a chaos
run always has drill-down material for ``python -m repro.obs --flight``.
Exemplar events share a ``flight_id`` arg; the Perfetto exporter turns
that into flow events linking the virtual-lane retry/uplink spans to the
host-lane server span (``obs/export.py``).

Async caveat: flights enter their frame when they *terminate* (heap
pop), while the scheduler's retry counters accrue at *dispatch* time, so
per-flush retry columns reconcile with the ``retry_downlink/<kind>``
ledger only for synchronous policies (exact, tested); async runs assert
backend parity instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "FlightFrame", "STATE_NAMES", "S_DROPPED_OUT", "S_CRASH_DROPPED",
    "S_CUT", "S_AGGREGATED", "S_QUARANTINED", "S_VOIDED",
    "flights_enabled", "set_flights", "make_flight_id", "sync_frame",
    "async_frame", "edge_columns", "assign_shards", "apply_screening",
    "select_exemplars", "log_frames",
]

# terminal lifecycle states (int8 column codes)
S_DROPPED_OUT = np.int8(1)    # lost to the benign dropout draw
S_CRASH_DROPPED = np.int8(2)  # crash retry budget exhausted
S_CUT = np.int8(3)            # arrived, cut by the straggler policy
S_AGGREGATED = np.int8(4)     # aggregated into the server update
S_QUARANTINED = np.int8(5)    # server screen: corrupt/poisoned payload
S_VOIDED = np.int8(6)         # survived screening, round below quorum

STATE_NAMES: Dict[int, str] = {
    int(S_DROPPED_OUT): "dropped_out",
    int(S_CRASH_DROPPED): "crash_dropped",
    int(S_CUT): "cut",
    int(S_AGGREGATED): "aggregated",
    int(S_QUARANTINED): "quarantined",
    int(S_VOIDED): "voided",
}

_ENABLED = True


def flights_enabled() -> bool:
    """Whether schedulers should capture flight frames (default on —
    capture is a handful of O(cohort) array ops per round)."""
    return _ENABLED


def set_flights(on: bool) -> bool:
    """Toggle flight capture; returns the previous setting. The off mode
    exists for A/B overhead measurement (``bench_network --fleet-scale``
    asserts recording stays within 1.15x of the bare scheduler)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def make_flight_id(rd: int, client: int, seq: int) -> str:
    return f"r{rd}-c{client}-s{seq}"


@dataclasses.dataclass(eq=False)
class FlightFrame:
    """One server update's flights as column arrays (struct-of-arrays).

    Rows are in cohort order (sync: ``seq`` == cohort position) or
    dispatch-stream order (async: ``seq`` == stream index, covering the
    flights that *terminated* in this flush window). ``t_arrival`` is
    NaN for flights that never completed an upload; ``edge`` / ``shard``
    are -1 for flat-star topologies / never-placed flights.
    """
    round: int
    kind: str                     # "sync" | "async"
    client: np.ndarray            # int64
    seq: np.ndarray               # int64 — the stable id component
    t_sampled: np.ndarray         # float64, virtual dispatch time
    t_arrival: np.ndarray         # float64, NaN = never arrived
    retries: np.ndarray           # int64, crashed attempts before success
    retry_downlinks: np.ndarray   # int64, extra model re-broadcasts
    retry_s: np.ndarray           # float64, virtual seconds of retry overhead
    edge: np.ndarray              # int64, aggregator placement (-1 = flat)
    rehomed: np.ndarray           # bool, failed over to a live edge
    shard: np.ndarray             # int64, executor shard (-1 = not placed)
    state: np.ndarray             # int8, S_* terminal state

    _FLOAT_COLS = ("t_sampled", "t_arrival", "retry_s")
    _COLS = ("client", "seq", "t_sampled", "t_arrival", "retries",
             "retry_downlinks", "retry_s", "edge", "rehomed", "shard",
             "state")

    def __len__(self) -> int:
        return int(self.client.shape[0])

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FlightFrame):
            return NotImplemented
        if (self.round, self.kind) != (other.round, other.kind):
            return False
        for c in self._COLS:
            a, b = getattr(self, c), getattr(other, c)
            eq = np.array_equal(a, b, equal_nan=c in self._FLOAT_COLS)
            if not eq:
                return False
        return True

    def flight_id(self, i: int) -> str:
        return make_flight_id(self.round, int(self.client[i]),
                              int(self.seq[i]))

    def state_counts(self) -> Dict[str, int]:
        counts = np.bincount(self.state, minlength=7)
        return {STATE_NAMES[s]: int(counts[s])
                for s in STATE_NAMES if counts[s]}

    def to_json(self) -> Dict[str, Any]:
        """JSON-safe column dict (NaN arrival -> None; checkpoint meta
        files must stay strict-JSON parseable)."""
        arr = [None if np.isnan(x) else float(x)
               for x in self.t_arrival.tolist()]
        return {
            "round": self.round, "kind": self.kind,
            "client": self.client.tolist(), "seq": self.seq.tolist(),
            "t_sampled": self.t_sampled.tolist(), "t_arrival": arr,
            "retries": self.retries.tolist(),
            "retry_downlinks": self.retry_downlinks.tolist(),
            "retry_s": self.retry_s.tolist(), "edge": self.edge.tolist(),
            "rehomed": self.rehomed.tolist(), "shard": self.shard.tolist(),
            "state": self.state.tolist(),
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FlightFrame":
        arr = np.asarray([np.nan if x is None else x
                          for x in d["t_arrival"]], np.float64)
        return cls(
            round=int(d["round"]), kind=str(d["kind"]),
            client=np.asarray(d["client"], np.int64),
            seq=np.asarray(d["seq"], np.int64),
            t_sampled=np.asarray(d["t_sampled"], np.float64),
            t_arrival=arr,
            retries=np.asarray(d["retries"], np.int64),
            retry_downlinks=np.asarray(d["retry_downlinks"], np.int64),
            retry_s=np.asarray(d["retry_s"], np.float64),
            edge=np.asarray(d["edge"], np.int64),
            rehomed=np.asarray(d["rehomed"], bool),
            shard=np.asarray(d["shard"], np.int64),
            state=np.asarray(d["state"], np.int8),
        )


# ---------------------------------------------------------------------------
# frame assembly (shared by both scheduler backends)
# ---------------------------------------------------------------------------

def edge_columns(topology, ids: np.ndarray,
                 down_edges: Sequence[int] = (),
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-flight ``(edge, rehomed)`` placement columns for one cohort.

    Uses the topology's own ``rehome`` failover math under an outage
    window so the flight's recorded edge is where the upload actually
    terminated; ``last_rehomed`` (the scheduler's survivor-only fault
    counter) is saved and restored around the whole-cohort call.
    """
    n = int(ids.shape[0])
    if topology is None or getattr(topology, "cluster_of", None) is None:
        return np.full(n, -1, np.int64), np.zeros(n, bool)
    base = topology.cluster_of[ids].astype(np.int64)
    if not down_edges:
        return base, np.zeros(n, bool)
    saved = topology.last_rehomed
    eff = topology.rehome(ids, down_edges).astype(np.int64)
    topology.last_rehomed = saved
    return eff, eff != base


def sync_frame(rd: int, t_start: float, ids: np.ndarray,
               arr_by_pos: np.ndarray, agg_pos: np.ndarray,
               cut_pos: np.ndarray, *,
               live_pos: Optional[np.ndarray] = None,
               crashes: Optional[np.ndarray] = None,
               extra_downlinks: Optional[np.ndarray] = None,
               retry_seconds: Optional[np.ndarray] = None,
               gone: Optional[np.ndarray] = None,
               topology=None, down_edges: Sequence[int] = (),
               ) -> FlightFrame:
    """Assemble one synchronous round's frame from cohort-order columns.

    ``arr_by_pos`` is the per-cohort-position arrival time (NaN where the
    member dropped out or exhausted its retry budget); ``agg_pos`` /
    ``cut_pos`` are cohort positions of the policy's survivors and cuts
    in arrival order. The fault columns (``crashes`` etc., indexed over
    ``live_pos`` — the positions that survived the dropout draw) are
    None on crash-free rounds.
    """
    n = int(ids.shape[0])
    retries = np.zeros(n, np.int64)
    retry_dl = np.zeros(n, np.int64)
    retry_s = np.zeros(n, np.float64)
    state = np.full(n, S_DROPPED_OUT, np.int8)
    if live_pos is not None and crashes is not None:
        retries[live_pos] = crashes
        retry_dl[live_pos] = extra_downlinks
        retry_s[live_pos] = retry_seconds
        if gone is not None:
            state[live_pos[gone]] = S_CRASH_DROPPED
    state[cut_pos] = S_CUT
    state[agg_pos] = S_AGGREGATED
    edge, rehomed = edge_columns(topology, ids, down_edges)
    return FlightFrame(
        round=int(rd), kind="sync",
        client=ids.astype(np.int64, copy=False),
        seq=np.arange(n, dtype=np.int64),
        t_sampled=np.full(n, float(t_start)),
        t_arrival=arr_by_pos,
        retries=retries, retry_downlinks=retry_dl, retry_s=retry_s,
        edge=edge, rehomed=rehomed,
        shard=np.full(n, -1, np.int64), state=state)


def _gather(col, seqs: np.ndarray, dtype):
    """Stream-column gather by seq: O(window) for list-backed columns
    (the heapq backend's per-dispatch appends), fancy indexing for the
    vector backend's arrays. ``col=None`` means the column was never
    populated (no fault injection) -> zeros."""
    if col is None:
        return np.zeros(seqs.shape[0], dtype)
    if isinstance(col, np.ndarray):
        return col[seqs].astype(dtype, copy=False)
    return np.asarray([col[s] for s in seqs.tolist()], dtype)


def async_frame(update: int, done: Sequence[Tuple[int, float]],
                cid, t0, drop, crash, retry_dl, retry_s, gone,
                topology=None) -> FlightFrame:
    """Assemble one async flush window's frame.

    ``done`` holds ``(seq, t_pop)`` for every flight that terminated in
    this window (buffered for aggregation OR dropped), in heap-pop
    order; rows are sorted by seq so both backends emit the identical
    frame. The remaining args are per-seq stream columns (lists in the
    heapq backend, arrays in the vector backend; fault columns None when
    no injector is armed).
    """
    seqs = np.asarray([s for s, _ in done], np.int64)
    tpop = np.asarray([tp for _, tp in done], np.float64)
    order = np.argsort(seqs, kind="stable")
    seqs, tpop = seqs[order], tpop[order]
    n = int(seqs.shape[0])
    client = _gather(cid, seqs, np.int64)
    dropped = _gather(drop, seqs, bool)
    gone_m = _gather(gone, seqs, bool)
    state = np.full(n, S_AGGREGATED, np.int8)
    state[dropped] = S_DROPPED_OUT
    state[gone_m] = S_CRASH_DROPPED      # budget exhaustion wins over dropout
    edge, rehomed = edge_columns(topology, client)
    return FlightFrame(
        round=int(update), kind="async", client=client, seq=seqs,
        t_sampled=_gather(t0, seqs, np.float64), t_arrival=tpop,
        retries=_gather(crash, seqs, np.int64),
        retry_downlinks=_gather(retry_dl, seqs, np.int64),
        retry_s=_gather(retry_s, seqs, np.float64),
        edge=edge, rehomed=rehomed,
        shard=np.full(n, -1, np.int64), state=state)


def assign_shards(frame: FlightFrame, placed: Sequence[Any]) -> None:
    """Scatter the executor's shard placement onto the aggregated
    flights, matching by client id (searchsorted over the aggregated
    subset — duplicate clients in one async flush share attribution)."""
    if not placed or len(frame) == 0:
        return
    pc = np.asarray([a.client for a in placed], np.int64)
    ps = np.asarray([a.shard for a in placed], np.int64)
    agg_idx = np.nonzero(frame.state == S_AGGREGATED)[0]
    if agg_idx.shape[0] == 0:
        return
    sub = frame.client[agg_idx]
    order = np.argsort(sub, kind="stable")
    pos = np.searchsorted(sub[order], pc)
    frame.shard[agg_idx[order[pos]]] = ps


def apply_screening(frames: Sequence[FlightFrame],
                    screen_log: Dict[int, Dict[str, Any]]) -> None:
    """Patch scheduler-built frames with the runtime's server-side
    admission verdicts: quarantined clients flip AGGREGATED ->
    QUARANTINED; a voided round flips the surviving remainder to VOIDED.
    Keyed by update index (`FederatedTrainer._screen_cohort` records
    ``{"quarantined": [client ids], "voided": bool}`` per update)."""
    by_round = {fr.round: fr for fr in frames}
    for rd, entry in screen_log.items():
        fr = by_round.get(rd)
        if fr is None:
            continue
        qcids = entry.get("quarantined") or []
        if qcids:
            agg = fr.state == S_AGGREGATED
            hit = np.isin(fr.client, np.asarray(qcids, np.int64))
            fr.state[agg & hit] = S_QUARANTINED
        if entry.get("voided"):
            fr.state[fr.state == S_AGGREGATED] = S_VOIDED


def retry_downlink_total(frames: Sequence[FlightFrame]) -> int:
    """Extra model re-broadcasts across all recorded flights — for sync
    runs this reconciles exactly with the ``retry_downlink/<kind>``
    ledger entries divided by the per-client downlink payload."""
    return sum(int(fr.retry_downlinks.sum()) for fr in frames)


# ---------------------------------------------------------------------------
# event-log emission: rollups + reservoir exemplars (O(edges + k) per frame)
# ---------------------------------------------------------------------------

_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)
_MIX3 = np.uint64(0x94D049BB133111EB)
_MASK = (1 << 64) - 1


def _hash01(frame: FlightFrame) -> np.ndarray:
    """Deterministic per-flight uniform in [0, 1) keyed on the stable id
    (splitmix64-style finalizer) — the reservoir's tie-breaker, so
    exemplar choice is identical across backends and resumed runs."""
    with np.errstate(over="ignore"):
        x = frame.seq.astype(np.uint64) * _MIX1
        x ^= frame.client.astype(np.uint64) * _MIX2
        x ^= np.uint64((frame.round * 0x632BE59BD9B4E019) & _MASK)
        x ^= x >> np.uint64(31)
        x *= _MIX3
        x ^= x >> np.uint64(29)
    return x.astype(np.float64) / float(2 ** 64)


def select_exemplars(frame: FlightFrame, k: int = 8) -> np.ndarray:
    """Deterministic reservoir sample of ``k`` flight rows, guaranteeing
    at least one exemplar per distinct terminal state plus one retried
    and one re-homed flight (when present); the remaining budget prefers
    fault-affected flights, hash-tie-broken."""
    n = len(frame)
    if n == 0 or k <= 0:
        return np.empty(0, np.int64)
    h = _hash01(frame)
    picked: List[int] = []
    for s in np.unique(frame.state).tolist():     # <= 6 distinct states
        m = frame.state == s
        picked.append(int(np.nonzero(m)[0][np.argmax(h[m])]))
    for m in (frame.retries > 0, frame.rehomed):
        if m.any():
            picked.append(int(np.nonzero(m)[0][np.argmax(h[m])]))
    chosen = set(picked[:k])
    budget = k - len(chosen)
    if budget > 0 and n > len(chosen):
        prio = (frame.state != S_AGGREGATED).astype(np.float64) * 2.0 \
            + (frame.retries > 0) + frame.rehomed
        key = prio + h
        key[np.asarray(sorted(chosen), np.int64)] = -np.inf
        m = min(budget, n - len(chosen))
        top = np.argpartition(key, n - m)[n - m:]
        chosen.update(int(i) for i in top if np.isfinite(key[i]))
    return np.asarray(sorted(chosen), np.int64)


def _frame_t(frame: FlightFrame) -> float:
    finite = frame.t_arrival[np.isfinite(frame.t_arrival)]
    if finite.shape[0]:
        return float(finite.max())
    return float(frame.t_sampled[0]) if len(frame) else 0.0


def _emit_rollup(rec, frame: FlightFrame) -> None:
    args: Dict[str, Any] = {
        "round": frame.round, "kind": frame.kind, "flights": len(frame),
        "states": frame.state_counts(),
        "retries": int(frame.retries.sum()),
        "retry_downlinks": int(frame.retry_downlinks.sum()),
        "rehomed": int(frame.rehomed.sum()),
    }
    m = frame.edge >= 0
    if m.any():
        e = frame.edge[m]
        n_edges = int(e.max()) + 1
        cnt = np.bincount(e, minlength=n_edges)
        rtr = np.bincount(e, weights=frame.retries[m], minlength=n_edges)
        lost = np.bincount(e, weights=(frame.state[m] != S_AGGREGATED),
                           minlength=n_edges)
        args["per_edge"] = {
            str(i): {"flights": int(cnt[i]), "retries": int(rtr[i]),
                     "lost": int(lost[i])}
            for i in range(n_edges) if cnt[i]}
    rec.append({"type": "event", "name": "flight.rollup", "cat": "flights",
                "lane": "virtual", "t": _frame_t(frame), "args": args})


def _emit_exemplar(rec, frame: FlightFrame, i: int) -> None:
    fid = frame.flight_id(i)
    state = STATE_NAMES[int(frame.state[i])]
    common = {"flight_id": fid, "client": int(frame.client[i]),
              "round": frame.round}
    t0 = float(frame.t_sampled[i])
    ta = frame.t_arrival[i]
    ta = t0 if np.isnan(ta) else float(ta)
    rec.append({"type": "event", "name": "flight.sampled", "cat": "flights",
                "lane": "virtual", "t": t0,
                "args": dict(common, seq=int(frame.seq[i]), kind=frame.kind)})
    rec.append({"type": "event", "name": "flight.placed", "cat": "flights",
                "lane": "virtual", "t": t0,
                "args": dict(common, edge=int(frame.edge[i]),
                             shard=int(frame.shard[i]),
                             rehomed=bool(frame.rehomed[i]))})
    rec.append({"type": "span", "name": "flight.uplink", "cat": "flights",
                "lane": "virtual", "t0": t0, "t1": ta,
                "args": dict(common, state=state)})
    retries = int(frame.retries[i])
    if retries:
        rec.append({"type": "span", "name": "flight.retry",
                    "cat": "flights", "lane": "virtual",
                    "t0": t0, "t1": t0 + float(frame.retry_s[i]),
                    "args": dict(common, retries=retries,
                                 retry_downlinks=int(
                                     frame.retry_downlinks[i]))})
    if frame.state[i] in (S_QUARANTINED, S_VOIDED):
        rec.append({"type": "event", "name": "flight.quarantined",
                    "cat": "flights", "lane": "virtual", "t": ta,
                    "args": dict(common, state=state)})
    rec.append({"type": "event", "name": "flight.outcome", "cat": "flights",
                "lane": "virtual", "t": ta,
                "args": dict(common, state=state)})
    # host-lane anchor: the Perfetto exporter links this zero-duration
    # server-side span to the virtual-lane flight spans via a flow chain,
    # tying the two time lanes together for one contribution
    now = rec.now()
    rec.append({"type": "span", "name": "flight.server", "cat": "flights",
                "lane": "host", "t0": now, "t1": now,
                "args": dict(common, state=state)})


def log_frames(rec, frames: Sequence[FlightFrame],
               exemplars_per_frame: int = 8) -> None:
    """Emit each frame's rollup + exemplar lifecycles into a recorder.

    Called by ``obs.log_trace`` at end of run — AFTER the runtime has
    applied its screening verdicts, so quarantined/voided flights are
    exemplar-eligible with their final states.
    """
    for fr in frames:
        _emit_rollup(rec, fr)
        for i in select_exemplars(fr, exemplars_per_frame).tolist():
            _emit_exemplar(rec, fr, i)

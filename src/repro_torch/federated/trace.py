"""Per-round simulation traces: what the virtual clock and the wire saw.

Twin of ``repro/federated/trace.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.federated`` imports jax.

A `Trace` is the measurement product of a scheduler run — one
``RoundRecord`` per *server update* (synchronous round or async buffer
flush) carrying simulated wall-clock, measured uplink/downlink bytes,
which clients participated, which were dropped (dropout or straggler
policy), and the staleness of each contribution. Benchmarks reduce a
trace to the paper-§5 trade-off curves: time-to-target-loss and
bytes-per-round under heterogeneous fleets.

Everything here is plain Python/numpy — records are host-side bookkeeping
written by the scheduler's event loop, never part of the training step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class RoundRecord:
    """One server update as observed by the virtual clock."""
    round: int                       # server update index
    t_start: float                   # sim seconds when the round was dispatched
    t_end: float                     # sim seconds when the server updated
    participants: Tuple[int, ...]    # client ids whose uploads were aggregated
    dropped: Tuple[int, ...]         # sampled but lost: dropout or straggler cut
    uplink_bytes: int                # measured bytes that crossed client->server
    downlink_bytes: int              # server->client bytes (broadcast + cut grads)
    staleness: Tuple[int, ...] = ()  # per-participant model-version lag (async)
    shards: Tuple[int, ...] = ()     # per-participant executor shard placement
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the byte ledger: "<direction>/<wire-kind>" -> bytes this round, e.g.
    # {"uplink/pq": 81920, "downlink/dense": 262144}; empty when the caller
    # did not tell the scheduler which wire kinds crossed (legacy callers)
    ledger: Dict[str, int] = dataclasses.field(default_factory=dict)
    # fault/recovery counters for this round: "<event>" -> count, e.g.
    # {"crashes": 3, "crash_dropped": 1, "retries": 2, "quarantined": 1,
    #  "rehomed": 4, "edges_down": 1, "jittered": 2, "round_voided": 1};
    # empty when no fault injection was active (the common case)
    faults: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Trace:
    """Ordered round records plus whole-run reductions.

    ``meta`` carries run-level context the records do not repeat per row:
    which codec each direction ran (`core/compressors.py` spec names), the
    measured per-client payload bytes behind the per-round totals, the
    cross-round state flags (``warm_start`` / ``error_feedback`` /
    ``stochastic_downlink``), and — when ``pq-delta`` codebook encoding is
    on — the measured codebook-bytes breakdown
    (``codebook_bytes_full`` / ``codebook_bytes_delta`` / ``_reduction``).
    """
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the scheduler's resume point after the last completed round — set by
    # synchronous runners ({"round", "t", "rng"}); what checkpointing saves
    # so a restored run continues the identical virtual clock + RNG stream
    cursor: Optional[Dict[str, object]] = None
    # one `repro.obs.flight.FlightFrame` per server update (column arrays,
    # O(cohort) each) — the per-contribution causal lifecycle behind the
    # aggregate counters above; appended by the scheduler when flight
    # recording is on, patched with screening verdicts by the runtime,
    # snapshotted/restored by federated/recovery.py
    flights: List[object] = dataclasses.field(default_factory=list)

    def append(self, rec: RoundRecord) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    # ---- reductions --------------------------------------------------------
    @property
    def simulated_seconds(self) -> float:
        return self.records[-1].t_end if self.records else 0.0

    @property
    def total_uplink_bytes(self) -> int:
        return sum(r.uplink_bytes for r in self.records)

    @property
    def total_downlink_bytes(self) -> int:
        return sum(r.downlink_bytes for r in self.records)

    @property
    def total_dropped(self) -> int:
        return sum(len(r.dropped) for r in self.records)

    @property
    def mean_staleness(self) -> float:
        s = [x for r in self.records for x in r.staleness]
        return sum(s) / len(s) if s else 0.0

    def ledger_totals(self) -> Dict[str, int]:
        """Whole-run byte totals per "<direction>/<wire-kind>" ledger key."""
        out: Dict[str, int] = {}
        for r in self.records:
            for k, v in r.ledger.items():
                out[k] = out.get(k, 0) + v
        return out

    def fault_totals(self) -> Dict[str, int]:
        """Whole-run fault/recovery event counts (empty without chaos)."""
        out: Dict[str, int] = {}
        for r in self.records:
            for k, v in r.faults.items():
                out[k] = out.get(k, 0) + v
        return out

    def tier_totals(self) -> Dict[str, int]:
        """Whole-run bytes per aggregation tier (the ledger-key direction).

        Flat star runs report ``{"uplink": ..., "downlink": ...}``; under
        a two-tier topology the uplink splits into ``edge_uplink``
        (client->edge last mile) and ``server_uplink`` (edge->server
        backhaul — the PS-link traffic hierarchical aggregation shrinks).
        """
        out: Dict[str, int] = {}
        for r in self.records:
            for k, v in r.ledger.items():
                tier = k.split("/", 1)[0]
                out[tier] = out.get(tier, 0) + v
        return out

    def tier_bytes_per_round(self, tier: str,
                             window: Optional[int] = None) -> float:
        """Mean bytes/round on one tier over the window (0.0 when the run
        recorded no such tier — e.g. ``server_uplink`` without a topology);
        a windowed controller signal for `federated/autoscale.py`."""
        recs = self.window(window)
        if not recs:
            return 0.0
        prefix = tier + "/"
        total = sum(v for r in recs for k, v in r.ledger.items()
                    if k.startswith(prefix))
        return total / len(recs)

    # ---- windowed observations (consumed by federated/autoscale.py) -------
    def window(self, n: Optional[int] = None) -> Sequence[RoundRecord]:
        """The last ``n`` records (all of them for ``None``)."""
        return self.records if n is None else self.records[-n:]

    def duration_percentile(self, q: float,
                            window: Optional[int] = None) -> float:
        """The q-th percentile (0..100, linear interpolation) of per-round
        durations over the window — the straggler-tail signal."""
        recs = self.window(window)
        if not recs:
            return 0.0
        xs = sorted(r.duration for r in recs)
        pos = (len(xs) - 1) * min(max(q, 0.0), 100.0) / 100.0
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def tail_ratio(self, window: Optional[int] = None) -> float:
        """p95/p50 of round durations — >~2 means a straggler-dominated
        round time (the autoscaler's primary trigger)."""
        p50 = self.duration_percentile(50.0, window)
        return self.duration_percentile(95.0, window) / p50 if p50 > 0 else 1.0

    def drop_rate(self, window: Optional[int] = None) -> float:
        """Fraction of sampled uploads that were lost (dropout or straggler
        cut) over the window."""
        recs = self.window(window)
        lost = sum(len(r.dropped) for r in recs)
        total = lost + sum(len(r.participants) for r in recs)
        return lost / total if total else 0.0

    def bytes_per_round(self, window: Optional[int] = None,
                        direction: str = "total") -> float:
        recs = self.window(window)
        if not recs:
            return 0.0
        up = sum(r.uplink_bytes for r in recs)
        down = sum(r.downlink_bytes for r in recs)
        total = {"uplink": up, "downlink": down, "total": up + down}[direction]
        return total / len(recs)

    def loss_slope(self, window: Optional[int] = None,
                   key: str = "loss") -> float:
        """Mean per-round change of ``metrics[key]`` over the window
        (negative = still improving; ~0 = plateaued)."""
        xs = [r.metrics[key] for r in self.window(window) if key in r.metrics]
        if len(xs) < 2:
            return 0.0
        return (xs[-1] - xs[0]) / (len(xs) - 1)

    def time_to_target(self, target: float, key: str = "loss") -> Optional[float]:
        """Sim seconds until ``metrics[key]`` first reaches <= target."""
        for r in self.records:
            if key in r.metrics and r.metrics[key] <= target:
                return r.t_end
        return None

    def bytes_to_target(self, target: float, key: str = "loss",
                        direction: str = "uplink") -> Optional[int]:
        """Cumulative wire bytes until ``metrics[key]`` first <= target.

        ``direction``: "uplink" (the paper's axis), "downlink", or "total"
        (both directions — the whole WAN bill)."""
        if direction not in ("uplink", "downlink", "total"):
            raise ValueError(f"unknown direction {direction!r}")
        total = 0
        for r in self.records:
            if direction in ("uplink", "total"):
                total += r.uplink_bytes
            if direction in ("downlink", "total"):
                total += r.downlink_bytes
            if key in r.metrics and r.metrics[key] <= target:
                return total
        return None

    def summary(self) -> Dict[str, float]:
        n = max(len(self.records), 1)
        out = {
            "rounds": len(self.records),
            "simulated_seconds": self.simulated_seconds,
            "uplink_bytes": self.total_uplink_bytes,
            "downlink_bytes": self.total_downlink_bytes,
            "uplink_bytes_per_round": self.total_uplink_bytes / n,
            "downlink_bytes_per_round": self.total_downlink_bytes / n,
            "stragglers_dropped": self.total_dropped,
            "mean_staleness": self.mean_staleness,
        }
        for k in ("uplink_compressor", "downlink_compressor"):
            if k in self.meta:
                out[k] = self.meta[k]
        faults = self.fault_totals()
        if faults:
            out["faults"] = faults
        return out

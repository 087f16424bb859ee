"""Deterministic fault injection for the federated runtime (chaos layer).

Twin of ``repro/federated/faults.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.federated`` imports jax.

A `FaultPlan` is a frozen, seeded description of every failure the
simulator should inject — wire corruption, mid-round client crashes,
async arrival jitter, edge-aggregator outage windows, a server kill, and
poisoned (non-finite) client updates. A `FaultInjector` turns the plan
into concrete decisions.

Determinism is the whole design:

* Every decision is a **stateless hash** (splitmix64 finalizer over
  ``np.uint64``) of ``(plan.seed, salt, context keys...)`` — the
  injector never touches the scheduler's ``numpy`` RNG stream. A run
  with an all-zero-rate plan is therefore *bitwise identical* to a run
  with no plan at all, and the vector/heapq scheduler backends stay
  parity-exact under faults: both recompute the same decision from the
  same keys instead of sharing a consumable stream.
* Crash decisions key on ``(round, client, attempt)`` for sync rounds
  and ``(stream seq, client, attempt)`` for async dispatches, so a
  client's fate is a pure function of *where* in the run it happens —
  independent of cohort order, backend, or checkpoint/resume splits.
* The scalar path is the vectorized path on singleton arrays; there is
  no separately-maintained scalar implementation to drift.

Failure semantics implemented by the runtime around this module:

* **Crash + retry**: a crashed client re-dispatches after an exponential
  backoff (``backoff_base_s * backoff_factor**attempt`` in *virtual*
  time); after ``max_retries`` failed retries it is permanently dropped
  for the round. Every retry re-sends the downlink, and those wasted
  bytes hit the byte ledger under ``retry_downlink/<kind>``.
* **Corruption / poison**: flagged uplink contributions are screened at
  aggregation — corrupt payloads must raise a typed `WireError`
  (CRC32-backed for wire v4), non-finite updates are caught by a real
  finiteness check — and quarantined; the eq.-5 λ-correction and
  staleness weights renormalize over survivors. A round whose surviving
  fraction falls below ``quorum_fraction`` is **voided** (no update).
* **Edge outage**: clients homed to a down edge re-home to the
  next-nearest live edge for the window (`TwoTierTopology`).
* **Server kill**: `ServerKilled` is raised at the top of the configured
  round; ``federated.recovery.run_with_recovery`` restores the latest
  crash-consistent checkpoint and replays, bitwise-identically.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "FaultPlan", "FaultInjector", "ServerKilled", "DEFAULT_CHAOS",
    "make_injector",
]


class ServerKilled(RuntimeError):
    """The injected server failure: raised between rounds, caught by
    ``run_with_recovery`` which restores the latest checkpoint."""

    def __init__(self, round_index: int):
        super().__init__(f"server killed at round {round_index}")
        self.round_index = int(round_index)


# ---------------------------------------------------------------------------
# stateless hashing (splitmix64 finalizer over uint64)
# ---------------------------------------------------------------------------

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_U64 = np.uint64

# decision domains — distinct salts keep draws independent per site
SALT_CRASH = 1         # sync crash: (round, client, attempt)
SALT_CRASH_ASYNC = 2   # async crash: (stream seq, client, attempt)
SALT_REORDER = 3       # async jitter gate: (client, seq)
SALT_REORDER_MAG = 4   # async jitter magnitude: (client, seq)
SALT_CORRUPT = 5       # uplink corruption gate: (round, client)
SALT_CORRUPT_MODE = 6  # corruption mode pick: (round, client)
SALT_CORRUPT_POS = 7   # corruption position: (round, client)
SALT_POISON = 8        # poisoned update gate: (round, client)


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized; uint64 wraparound is the point)."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def _hash_keys(seed: int, keys) -> np.ndarray:
    """Fold ``keys`` (scalars or broadcastable uint arrays) into one
    uint64 hash; pure function of the values, so scalar and vectorized
    call sites agree bit-for-bit."""
    h = _U64(seed)
    for k in keys:
        k = np.asarray(k, np.uint64)
        with np.errstate(over="ignore"):
            h = _mix64((h + _GOLDEN) ^ k)
    return h


def _uniform_from(h: np.ndarray) -> np.ndarray:
    """Map uint64 hashes to doubles in [0, 1) (53 mantissa bits)."""
    return (h >> _U64(11)).astype(np.float64) * (2.0 ** -53)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative description of every fault to inject.

    All rates are per-decision probabilities in [0, 1]; zero disables the
    fault entirely (and leaves the run bitwise-identical to a no-plan
    run). ``edge_outages`` entries are ``(edge_index, t0, t1)`` windows
    in scheduler virtual time, half-open ``[t0, t1)`` against the round's
    start time. ``server_kill_rounds`` are absolute round indices;
    ``poison_clients`` are always-poisoned client ids on top of the
    rate-drawn ones."""

    seed: int = 0
    # client mid-round crashes + bounded retry
    crash_rate: float = 0.0
    max_retries: int = 2
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    # uplink payload corruption (bit-flip / truncate / duplicate)
    corrupt_rate: float = 0.0
    corrupt_modes: Tuple[str, ...] = ("bitflip", "truncate", "duplicate")
    # poisoned (non-finite) client updates
    poison_rate: float = 0.0
    poison_clients: Tuple[int, ...] = ()
    # async arrival reordering
    reorder_rate: float = 0.0
    reorder_max_s: float = 0.0
    # edge-aggregator outage windows (TwoTierTopology)
    edge_outages: Tuple[Tuple[int, float, float], ...] = ()
    # server kill between rounds
    server_kill_rounds: Tuple[int, ...] = ()
    # aggregation quorum: void the round below this surviving fraction
    quorum_fraction: float = 0.5

    def __post_init__(self):
        for name in ("crash_rate", "corrupt_rate", "poison_rate",
                     "reorder_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} outside [0, 1]")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= self.quorum_fraction <= 1.0:
            raise ValueError("quorum_fraction outside [0, 1]")
        if not self.corrupt_modes:
            raise ValueError("corrupt_modes must be non-empty")

    @property
    def any_faults(self) -> bool:
        """Whether the plan can inject anything at all — the runtime uses
        this to keep zero-fault code paths byte-identical to PR 8."""
        return bool(self.crash_rate > 0 or self.corrupt_rate > 0
                    or self.poison_rate > 0 or self.poison_clients
                    or self.reorder_rate > 0 or self.edge_outages
                    or self.server_kill_rounds)

    def disarm_kills_through(self, round_index: int) -> "FaultPlan":
        """The plan after a recovery at ``round_index``: kills at or
        before that round have fired (a restarted server does not re-die
        on the same round)."""
        return dataclasses.replace(
            self, server_kill_rounds=tuple(
                k for k in self.server_kill_rounds if k > round_index))


DEFAULT_CHAOS = FaultPlan(
    seed=0, crash_rate=0.05, corrupt_rate=0.05, poison_rate=0.03,
    reorder_rate=0.2, reorder_max_s=2.0, quorum_fraction=0.5)
"""The fixed-seed default schedule CI's chaos-smoke step runs."""


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

class FaultInjector:
    """Turns a `FaultPlan` into concrete per-site decisions.

    Stateless by construction (every method is a pure function of the
    plan and its arguments); safe to recreate at any point — including
    after a checkpoint restore — without changing any decision."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def _uniform(self, *keys) -> np.ndarray:
        return _uniform_from(_hash_keys(self.plan.seed, keys))

    # -- client crashes + bounded retry ----------------------------------
    def _crash_attempts(self, salt: int, key, cids) -> np.ndarray:
        """Number of *leading* crashed attempts per client, in
        ``[0, max_retries + 1]``; a value above ``max_retries`` means the
        retry budget is exhausted (permanent drop for this round)."""
        cids = np.asarray(cids)
        crashes = np.zeros(cids.shape, np.int64)
        leading = np.ones(cids.shape, bool)
        for a in range(self.plan.max_retries + 1):
            u = self._uniform(salt, key, cids, a)
            crashed = leading & (u < self.plan.crash_rate)
            crashes += crashed
            leading = crashed
        return crashes

    def crash_attempts_sync(self, round_index: int, cids) -> np.ndarray:
        return self._crash_attempts(SALT_CRASH, round_index, cids)

    def crash_attempts_async(self, seqs, cids) -> np.ndarray:
        """Async crashes key on the dispatch stream index, which is
        identical across backends (heap seq == vector stream index)."""
        seqs = np.asarray(seqs)
        cids = np.asarray(cids)
        crashes = np.zeros(cids.shape, np.int64)
        leading = np.ones(cids.shape, bool)
        for a in range(self.plan.max_retries + 1):
            u = self._uniform(SALT_CRASH_ASYNC, seqs, cids, a)
            crashed = leading & (u < self.plan.crash_rate)
            crashes += crashed
            leading = crashed
        return crashes

    def retry_overhead(self, crashes: np.ndarray,
                       dl_comp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Virtual-time overhead of the crashed attempts.

        ``dl_comp`` is each client's (downlink + compute) seconds — the
        time a crashed attempt wastes before the crash is noticed and the
        retry dispatched after backoff. Returns ``(extra_seconds, gone)``
        where ``gone`` marks clients whose retry budget is exhausted.
        The accumulation order ``(extra + dl_comp) + backoff_a`` is fixed
        so both scheduler backends produce bit-identical doubles."""
        crashes = np.asarray(crashes)
        dl_comp = np.asarray(dl_comp, np.float64)
        extra = np.zeros(np.broadcast(crashes, dl_comp).shape, np.float64)
        for a in range(self.plan.max_retries + 1):
            backoff = self.plan.backoff_base_s * self.plan.backoff_factor ** a
            extra = np.where(crashes > a, (extra + dl_comp) + backoff, extra)
        return extra, crashes > self.plan.max_retries

    @staticmethod
    def extra_downlinks(crashes: np.ndarray, gone: np.ndarray) -> np.ndarray:
        """Downlink re-sends beyond the first dispatch: one per crash,
        except the terminal crash of a budget-exhausted client (no retry
        follows it)."""
        crashes = np.asarray(crashes)
        return np.where(np.asarray(gone), crashes - 1, crashes)

    # -- uplink corruption / poisoning -----------------------------------
    def corrupt_mask(self, round_index: int, cids) -> np.ndarray:
        if self.plan.corrupt_rate <= 0:
            return np.zeros(np.asarray(cids).shape, bool)
        return self._uniform(SALT_CORRUPT, round_index, cids) \
            < self.plan.corrupt_rate

    def poison_mask(self, round_index: int, cids) -> np.ndarray:
        cids = np.asarray(cids)
        mask = np.zeros(cids.shape, bool)
        if self.plan.poison_rate > 0:
            mask |= self._uniform(SALT_POISON, round_index, cids) \
                < self.plan.poison_rate
        if self.plan.poison_clients:
            mask |= np.isin(cids, np.asarray(self.plan.poison_clients))
        return mask

    def corrupt_payload(self, payload: bytes, round_index: int,
                        cid: int) -> bytes:
        """Deterministically damage a wire payload (the decode side must
        raise a typed ``WireError`` — asserted by the canary check)."""
        modes = self.plan.corrupt_modes
        mode = modes[int(_hash_keys(self.plan.seed,
                                    (SALT_CORRUPT_MODE, round_index, cid))
                         % np.uint64(len(modes)))]
        pos = int(_hash_keys(self.plan.seed,
                             (SALT_CORRUPT_POS, round_index, cid)))
        if mode == "bitflip":
            buf = bytearray(payload)
            bit = pos % (len(buf) * 8)
            buf[bit // 8] ^= 1 << (bit % 8)
            return bytes(buf)
        if mode == "truncate":
            return payload[:pos % max(len(payload), 1)]
        if mode == "duplicate":
            return payload + payload
        raise ValueError(f"unknown corrupt mode {mode!r}")

    # -- async arrival reordering ----------------------------------------
    def reorder_jitter(self, cids, seqs) -> np.ndarray:
        """Per-dispatch relay jitter in seconds (0 where the gate does
        not fire). Adding 0.0 to a positive arrival time is bitwise-safe,
        so the zero-rate case stays parity-exact without branching."""
        cids = np.asarray(cids)
        if self.plan.reorder_rate <= 0 or self.plan.reorder_max_s <= 0:
            return np.zeros(cids.shape, np.float64)
        gate = self._uniform(SALT_REORDER, cids, seqs) \
            < self.plan.reorder_rate
        mag = self._uniform(SALT_REORDER_MAG, cids, seqs)
        return np.where(gate, mag * self.plan.reorder_max_s, 0.0)

    # -- topology / server -----------------------------------------------
    def down_edges(self, t_start: float) -> Tuple[int, ...]:
        """Edges inside an outage window at the round's start time."""
        return tuple(int(e) for (e, t0, t1) in self.plan.edge_outages
                     if t0 <= t_start < t1)

    def server_killed(self, round_index: int) -> bool:
        return round_index in self.plan.server_kill_rounds


def make_injector(plan: Optional[FaultPlan]) -> Optional[FaultInjector]:
    """None-propagating constructor: no plan (or an all-quiet plan) means
    no injector, which keeps every fault branch in the scheduler and
    trainer byte-identical to the pre-chaos code path."""
    if plan is None or not plan.any_faults:
        return None
    return FaultInjector(plan)

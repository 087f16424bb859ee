"""Heterogeneous client/network models for the federated simulator.

Twin of ``repro/federated/network.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.federated`` imports jax.

A ``ClientProfile`` describes one device-under-simulation: asymmetric
uplink/downlink bandwidth, one-way latency, a compute-speed multiplier
(relative to the reference client the paper times), and a per-round
dropout probability. At fleet scale the per-client object is the wrong
representation — a million-profile Python list is hundreds of MB of
boxed floats that every scheduler round re-unboxes — so populations are
held as a ``ClientFleet``: one struct-of-arrays with a float64 column
per field. The vectorized scheduler backend
(``federated/scheduler.py``) computes whole-cohort round trips and
dropout draws directly on the columns; ``fleet[i]`` still materializes
a `ClientProfile` on demand, so per-arrival call sites (the heapq
reference backend) run unchanged.

Fleet samplers build realistic populations (all return `ClientFleet`):

  * ``uniform_fleet``   — every client identical (``IDEAL`` reproduces the
                          pre-subsystem simulation: infinite bandwidth,
                          zero latency, no dropout).
  * ``lognormal_fleet`` — lognormal bandwidth + compute spread, the
                          standard empirical model for last-mile links
                          (heavy right tail of slow clients = stragglers).
  * ``mobile_fleet``    — a wired/mobile mixture: a fraction of flaky
                          mobile clients with low bandwidth, high latency
                          and nonzero dropout, the Caldas-style
                          resource-constrained population FedLite targets.

All times are in (virtual) seconds, bandwidth in bits/second. Transfer
cost is the affine model ``latency + bits/bandwidth``; infinite bandwidth
and zero latency make any transfer free, so the ideal profile adds
exactly nothing to the virtual clock. The array ops evaluate the exact
same IEEE-double expressions as the scalar `ClientProfile` methods, in
the same association order — the vectorized scheduler backend's bitwise
trace parity with the heapq reference rests on that (asserted in
tests/test_fleet_scale.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientProfile:
    """Static resource description of one simulated client."""
    uplink_bps: float = math.inf      # client -> server bandwidth (bits/s)
    downlink_bps: float = math.inf    # server -> client bandwidth (bits/s)
    latency_s: float = 0.0            # one-way link latency (seconds)
    compute_multiplier: float = 1.0   # local step time multiplier (1 = reference)
    dropout_prob: float = 0.0         # P(client vanishes mid-round)

    def __post_init__(self):
        if self.uplink_bps <= 0 or self.downlink_bps <= 0:
            raise ValueError("bandwidth must be positive (use math.inf for ideal)")
        if not 0.0 <= self.dropout_prob <= 1.0:
            raise ValueError(f"dropout_prob={self.dropout_prob} not in [0, 1]")
        if self.compute_multiplier < 0:
            raise ValueError("compute_multiplier must be >= 0")

    def uplink_seconds(self, nbytes: float) -> float:
        return transfer_seconds(nbytes, self.uplink_bps, self.latency_s)

    def downlink_seconds(self, nbytes: float) -> float:
        return transfer_seconds(nbytes, self.downlink_bps, self.latency_s)

    def compute_seconds(self, base_step_seconds: float) -> float:
        return base_step_seconds * self.compute_multiplier


IDEAL = ClientProfile()


def transfer_seconds(nbytes: float, bps: float, latency_s: float = 0.0) -> float:
    """Affine transfer-time model; free when bandwidth is infinite."""
    if nbytes <= 0:
        return 0.0
    serialization = 0.0 if math.isinf(bps) else nbytes * 8.0 / bps
    return latency_s + serialization


# ---------------------------------------------------------------------------
# struct-of-arrays fleet
# ---------------------------------------------------------------------------

_FIELDS = ("uplink_bps", "downlink_bps", "latency_s", "compute_multiplier",
           "dropout_prob")


@dataclasses.dataclass(eq=False)
class ClientFleet:
    """A population of clients as one float64 column per profile field.

    This is the fleet representation the vectorized scheduler core runs
    on: ``round_trip_seconds`` computes a whole cohort's
    downlink + compute + uplink times as three gathers and two adds, and
    ``dropout_prob[ids]`` feeds a single vectorized Bernoulli draw per
    round. Validation happens once at construction over the whole
    population (the vectorized twin of ``ClientProfile.__post_init__``),
    not per object.

    The sequence protocol keeps every pre-array call site working:
    ``len(fleet)``, iteration, and ``fleet[i]`` (materializing one
    `ClientProfile` from row ``i`` — exactly the floats the columns
    hold, so the heapq reference backend computes bit-identical times).
    """
    uplink_bps: np.ndarray
    downlink_bps: np.ndarray
    latency_s: np.ndarray
    compute_multiplier: np.ndarray
    dropout_prob: np.ndarray

    def __post_init__(self):
        for f in _FIELDS:
            setattr(self, f, np.ascontiguousarray(getattr(self, f),
                                                  dtype=np.float64))
        n = self.uplink_bps.shape
        if any(getattr(self, f).shape != n for f in _FIELDS) or len(n) != 1:
            raise ValueError(
                "ClientFleet columns must be 1-D arrays of one shared "
                f"length; got {[getattr(self, f).shape for f in _FIELDS]}")
        # whole-population validation, one pass per rule
        if (self.uplink_bps <= 0).any() or (self.downlink_bps <= 0).any():
            raise ValueError("bandwidth must be positive (use math.inf for ideal)")
        if ((self.dropout_prob < 0) | (self.dropout_prob > 1)).any():
            raise ValueError("dropout_prob not in [0, 1] for some client")
        if (self.compute_multiplier < 0).any():
            raise ValueError("compute_multiplier must be >= 0")

    # ---- construction ------------------------------------------------------
    @classmethod
    def from_profiles(cls, profiles: Sequence[ClientProfile]) -> "ClientFleet":
        """Adapter for legacy profile lists (O(n) Python, once per run —
        never in the per-round path)."""
        return cls(*(np.asarray([getattr(p, f) for p in profiles],  # fedlint: disable=python-loop-over-fleet
                                dtype=np.float64) for f in _FIELDS))

    @classmethod
    def broadcast(cls, profile: ClientProfile, num_clients: int) -> "ClientFleet":
        """``num_clients`` identical rows of ``profile``."""
        return cls(*(np.full(num_clients, getattr(profile, f), np.float64)
                     for f in _FIELDS))

    @classmethod
    def from_any(cls, fleet: Union["ClientFleet", Sequence[ClientProfile]],
                 ) -> "ClientFleet":
        """Normalize either representation to arrays."""
        return fleet if isinstance(fleet, ClientFleet) \
            else cls.from_profiles(fleet)

    # ---- sequence protocol (ClientProfile adapter) -------------------------
    def __len__(self) -> int:
        return int(self.uplink_bps.shape[0])

    def __getitem__(self, i) -> Union[ClientProfile, "ClientFleet"]:
        if isinstance(i, (slice, np.ndarray, list)):
            return ClientFleet(*(getattr(self, f)[i] for f in _FIELDS))
        return ClientProfile(*(float(getattr(self, f)[i]) for f in _FIELDS))

    def __iter__(self) -> Iterator[ClientProfile]:
        return (self[i] for i in range(len(self)))

    # ---- vectorized time model ---------------------------------------------
    def _transfer_seconds(self, nbytes: float, bps: np.ndarray,
                          latency: np.ndarray) -> np.ndarray:
        """Array twin of `transfer_seconds`, same association order."""
        if nbytes <= 0:
            return np.zeros_like(bps)
        # x / inf == 0.0 exactly, so the infinite-bandwidth branch of the
        # scalar model falls out of the same expression
        return latency + nbytes * 8.0 / bps

    def uplink_seconds(self, nbytes: float, ids: np.ndarray) -> np.ndarray:
        return self._transfer_seconds(nbytes, self.uplink_bps[ids],
                                      self.latency_s[ids])

    def downlink_seconds(self, nbytes: float, ids: np.ndarray) -> np.ndarray:
        return self._transfer_seconds(nbytes, self.downlink_bps[ids],
                                      self.latency_s[ids])

    def compute_seconds(self, base_step_seconds: float,
                        ids: np.ndarray) -> np.ndarray:
        return base_step_seconds * self.compute_multiplier[ids]

    def downlink_compute_seconds(self, ids: np.ndarray, downlink_bytes: int,
                                 base_step_seconds: float) -> np.ndarray:
        """``downlink + compute`` seconds — the virtual time one crashed
        attempt wastes before the failure is noticed (the upload never
        happens). Associated like the scalar path so the fault injector's
        retry arithmetic is bitwise-identical across backends."""
        return self.downlink_seconds(downlink_bytes, ids) \
            + self.compute_seconds(base_step_seconds, ids)

    def round_trip_seconds(self, ids: np.ndarray, uplink_bytes: int,
                           downlink_bytes: int,
                           base_step_seconds: float) -> np.ndarray:
        """Whole-cohort ``downlink -> compute -> uplink`` times.

        Left-associated like the scalar path
        (``(downlink + compute) + uplink``) so the heapq backend's
        per-client sums reproduce bitwise.
        """
        return (self.downlink_seconds(downlink_bytes, ids)
                + self.compute_seconds(base_step_seconds, ids)) \
            + self.uplink_seconds(uplink_bytes, ids)


# ---------------------------------------------------------------------------
# fleet samplers (all vectorized: no per-client Python objects built)
# ---------------------------------------------------------------------------

def uniform_fleet(num_clients: int,
                  profile: ClientProfile = IDEAL) -> ClientFleet:
    """Every client identical; the IDEAL default is the pre-subsystem sim."""
    return ClientFleet.broadcast(profile, num_clients)


def lognormal_fleet(num_clients: int, *,
                    median_uplink_bps: float = 5e6,
                    median_downlink_bps: float = 20e6,
                    bandwidth_sigma: float = 1.0,
                    latency_s: float = 0.05,
                    compute_sigma: float = 0.4,
                    dropout_prob: float = 0.0,
                    seed: int = 0) -> ClientFleet:
    """Lognormal bandwidth + compute spread around the given medians.

    ``bandwidth_sigma`` is the log-scale std; sigma=1 gives roughly a 7x
    spread between the 10th and 90th percentile client — a realistic
    residential-broadband distribution with a heavy straggler tail. The
    RNG draw sequence is unchanged from the profile-list era, so seeded
    fleets (and every trace derived from them) stay reproducible.
    """
    rng = np.random.default_rng(seed)
    up = median_uplink_bps * np.exp(rng.normal(0, bandwidth_sigma, num_clients))
    down = median_downlink_bps * np.exp(rng.normal(0, bandwidth_sigma, num_clients))
    comp = np.exp(rng.normal(0, compute_sigma, num_clients))
    return ClientFleet(
        uplink_bps=up, downlink_bps=down,
        latency_s=np.full(num_clients, latency_s, np.float64),
        compute_multiplier=comp,
        dropout_prob=np.full(num_clients, dropout_prob, np.float64))


def mobile_fleet(num_clients: int, *,
                 flaky_fraction: float = 0.3,
                 wired_uplink_bps: float = 20e6,
                 wired_downlink_bps: float = 100e6,
                 mobile_uplink_bps: float = 1e6,
                 mobile_downlink_bps: float = 5e6,
                 mobile_latency_s: float = 0.15,
                 mobile_dropout_prob: float = 0.2,
                 mobile_compute_multiplier: float = 3.0,
                 seed: int = 0) -> ClientFleet:
    """Wired/mobile mixture: ``flaky_fraction`` of the fleet is slow mobile
    hardware on a lossy link (Caldas et al.'s resource-constrained cohort)."""
    rng = np.random.default_rng(seed)
    is_mobile = rng.random(num_clients) < flaky_fraction
    pick = lambda mobile, wired: np.where(is_mobile, mobile, wired)  # noqa: E731
    return ClientFleet(
        uplink_bps=pick(mobile_uplink_bps, wired_uplink_bps),
        downlink_bps=pick(mobile_downlink_bps, wired_downlink_bps),
        latency_s=pick(mobile_latency_s, 0.02),
        compute_multiplier=pick(mobile_compute_multiplier, 1.0),
        dropout_prob=pick(mobile_dropout_prob, 0.0))


def validate_fleet(fleet: Union[ClientFleet, Sequence[ClientProfile]],
                   num_clients: int) -> None:
    """Whole-fleet validation without touching per-client objects.

    `ClientFleet` columns were bounds-checked in bulk at construction and
    `ClientProfile` objects in ``__post_init__``; the only cross-cutting
    invariant left is the population size.
    """
    if len(fleet) != num_clients:
        raise ValueError(
            f"fleet has {len(fleet)} profiles for {num_clients} clients")

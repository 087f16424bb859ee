"""Aggregation topologies: flat star vs two-tier hierarchical edges.

Twin of ``repro/federated/topology.py`` (numpy, on the host).
The port keeps its own copy: importing ``repro.federated`` imports jax.

The flat scheduler models every uplink as one client->server hop, which
is exactly the parameter-server link Jung et al. (PAPERS.md) show
congesting first as fleets grow: a million last-mile links terminate on
one ingress. Their fix — and this module — is location-clustered
**hierarchical aggregation**: clients upload their (compressed)
cut-layer payloads to a nearby *edge aggregator*, and only the edges
talk to the server.

Why pre-combination is free for the sync policies: federated averaging
is linear in the client contributions (Konečný et al.), so an edge can
sum its cluster's dequantized payloads and forward ``(partial_sum,
count)`` — one payload-sized message plus a small count header — and the
server's weighted average is unchanged. The `AsyncBuffer` policy is the
exception: its per-contribution staleness weights are applied at *server
flush* time, when the contribution's age is known, so edges under async
act as store-and-forward relays (per-contribution hop cost, no
pre-combination) rather than combiners.

`TwoTierTopology` clusters clients by simulated geography: every client
gets a 2-D location drawn from a population-hotspot mixture (urban
concentrations, not uniform scatter), and a chunked vectorized Lloyd
k-means assigns each to its nearest of ``num_edges`` edge sites. The
scheduler consumes three things:

  * ``cluster_of``       — int array, client id -> edge id (also drives
                           cluster-aware cohort placement in
                           `executor.MeshExecutor.place`);
  * ``sync_round(...)``  — given the policy's survivors, the per-edge
                           flush times and the server-side arrival of the
                           last edge payload (the round's new ``t_end``);
  * ``relay_hop_seconds``— the async per-contribution edge->server relay
                           cost added to each dispatch round trip.

Byte accounting is per tier: the obs ledger splits uplink traffic into
``edge_uplink/<kind>`` (every client->edge payload) and
``server_uplink/<kind>`` (one combined payload + count overhead per
*participating* edge per round — the PS-link traffic the hierarchy
exists to shrink). `RoundRecord.uplink_bytes` is the sum of both tiers.

Everything here is plain numpy on the virtual clock — no device work —
and both scheduler backends call the *same* array helpers, so heapq vs
vectorized trace parity holds under a topology by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.federated.network import transfer_seconds


def simulate_locations(num_clients: int, *, hotspots: int = 12,
                       spread: float = 0.04, seed: int = 0) -> np.ndarray:
    """Sample ``(num_clients, 2)`` locations from a hotspot mixture.

    Hotspot centers are uniform in the unit square with Zipf-ish
    population weights (rank r gets weight 1/r), and clients scatter
    normally around their hotspot — a cheap stand-in for the urban
    population clustering that makes edge aggregation pay off.
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, size=(hotspots, 2))
    weights = 1.0 / np.arange(1, hotspots + 1)
    weights /= weights.sum()
    which = rng.choice(hotspots, size=num_clients, p=weights)
    return centers[which] + rng.normal(0.0, spread, size=(num_clients, 2))


def kmeans_points(points: np.ndarray, k: int, *, iters: int = 8,
                  seed: int = 0, chunk: int = 65536,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked vectorized Lloyd k-means over ``(n, d)`` points.

    Assignment runs in ``chunk``-sized blocks so the (chunk, k, d)
    distance tensor stays a few MB even at n = 10^6; centroid updates
    are one `np.bincount` per dimension. Empty clusters keep their old
    centroid. Returns ``(labels, centers)``.
    """
    points = np.asarray(points, dtype=np.float64)
    n, d = points.shape
    if k <= 0:
        raise ValueError("k must be positive")
    if k >= n:
        return np.arange(n, dtype=np.int64) % max(k, 1), points.copy()
    rng = np.random.default_rng(seed)
    centers = points[rng.choice(n, size=k, replace=False)]
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        for lo in range(0, n, chunk):
            block = points[lo:lo + chunk]
            d2 = ((block[:, None, :] - centers[None, :, :]) ** 2).sum(axis=-1)
            labels[lo:lo + chunk] = np.argmin(d2, axis=1)
        counts = np.bincount(labels, minlength=k)
        new = np.empty_like(centers)
        for dim in range(d):
            sums = np.bincount(labels, weights=points[:, dim], minlength=k)
            new[:, dim] = np.where(counts > 0,
                                   sums / np.maximum(counts, 1),
                                   centers[:, dim])
        centers = new
    return labels, centers


@dataclasses.dataclass
class TwoTierTopology:
    """Client -> edge -> server aggregation with per-tier virtual time.

    ``edge_uplink_bps`` / ``edge_latency_s`` describe the (uniform)
    edge->server backhaul links — provisioned infrastructure, so orders
    of magnitude faster than the last-mile client links in the fleet
    samplers. ``payload_overhead_bytes`` is the count header an edge
    attaches to its pre-combined sum (Konečný-linearity makes the sum
    itself exactly one payload wide).
    """
    num_edges: int = 16
    edge_uplink_bps: float = 10e9
    edge_latency_s: float = 0.005
    payload_overhead_bytes: int = 8
    hotspots: int = 12
    kmeans_iters: int = 8
    seed: int = 0

    kind = "two_tier"

    def __post_init__(self):
        if self.num_edges <= 0:
            raise ValueError("num_edges must be positive")
        self.cluster_of: Optional[np.ndarray] = None
        self.locations: Optional[np.ndarray] = None
        self.centers: Optional[np.ndarray] = None
        # set by sync_round: clients re-homed away from a down edge in the
        # last round (read by the scheduler's fault accounting; kept out of
        # the return triple for backward compatibility)
        self.last_rehomed: int = 0

    # ---- clustering --------------------------------------------------------
    def ensure(self, num_clients: int) -> None:
        """Cluster the fleet once; idempotent for a fixed population size."""
        if self.cluster_of is not None:
            if self.cluster_of.shape[0] != num_clients:
                raise ValueError(
                    f"topology clustered for {self.cluster_of.shape[0]} "
                    f"clients, fleet has {num_clients}")
            return
        self.locations = simulate_locations(
            num_clients, hotspots=self.hotspots, seed=self.seed)
        self.cluster_of, self.centers = kmeans_points(
            self.locations, self.num_edges, iters=self.kmeans_iters,
            seed=self.seed)

    def _require_clusters(self) -> np.ndarray:
        if self.cluster_of is None:
            raise RuntimeError("TwoTierTopology.ensure(num_clients) "
                               "must run before scheduling")
        return self.cluster_of

    # ---- virtual-clock cost model ------------------------------------------
    def edge_payload_bytes(self, uplink_bytes: int) -> int:
        """Bytes of one edge->server message: combined sum + count header."""
        return int(uplink_bytes) + self.payload_overhead_bytes

    def edge_hop_seconds(self, nbytes: int) -> float:
        """Backhaul transfer time for one edge->server message."""
        return transfer_seconds(nbytes, self.edge_uplink_bps,
                                self.edge_latency_s)

    def relay_hop_seconds(self, uplink_bytes: int) -> float:
        """Async store-and-forward relay cost per contribution.

        No pre-combination under `AsyncBuffer` (staleness weights are
        per contribution, applied at server flush), so the relayed
        payload is the client payload itself — no count overhead.
        """
        return self.edge_hop_seconds(int(uplink_bytes))

    def rehome(self, clients: np.ndarray,
               down_edges: Sequence[int]) -> np.ndarray:
        """Edge assignment with outage failover: clients homed to a down
        edge re-home to the next-nearest *live* edge center for the
        window (their k-means location distance, down edges masked out).
        With every edge down the outage is ignored — there is nowhere to
        fail over to, and stalling the whole fleet would deadlock the
        virtual clock. Returns the per-client edge ids."""
        cluster_of = self._require_clusters()
        edges = cluster_of[clients]
        down = np.asarray(sorted(set(int(e) for e in down_edges)), np.int64)
        self.last_rehomed = 0
        if down.size == 0 or down.size >= self.num_edges:
            return edges
        hit = np.isin(edges, down)
        if not hit.any():
            return edges
        # distance of each displaced client's location to every live center
        locs = self.locations[clients[hit]]                  # (h, 2)
        dist = np.linalg.norm(locs[:, None, :] - self.centers[None, :, :],
                              axis=-1)                       # (h, E)
        dist[:, down] = np.inf
        edges = edges.copy()
        edges[hit] = np.argmin(dist, axis=1)
        self.last_rehomed = int(hit.sum())
        return edges

    def sync_round(self, survivor_clients: np.ndarray,
                   survivor_t: np.ndarray, t_policy_end: float,
                   uplink_bytes: int, *,
                   down_edges: Optional[Sequence[int]] = None,
                   ) -> Tuple[float, int, int]:
        """Second-tier times + bytes for one synchronous round.

        Each participating edge flushes when its last surviving client's
        upload lands, then ships one combined payload over the backhaul;
        the round's ``t_end`` is the later of the policy's decision time
        (e.g. the `Deadline` cutoff — the server still waits out its
        budget) and the last edge payload's server-side arrival. Returns
        ``(t_end, participating_edges, server_uplink_bytes)``. Shared
        verbatim by both scheduler backends, so backend trace parity
        under a topology needs no per-backend reasoning.

        ``down_edges`` (fault injection) marks edge aggregators inside an
        outage window: their clients re-home to the next-nearest live
        edge (see ``rehome``; the count lands in ``last_rehomed``).
        """
        cluster_of = self._require_clusters()
        self.last_rehomed = 0
        if survivor_clients.shape[0] == 0:
            return float(t_policy_end), 0, 0
        if down_edges:
            edges = self.rehome(survivor_clients, down_edges)
        else:
            edges = cluster_of[survivor_clients]
        ready = np.full(self.num_edges, -np.inf)
        np.maximum.at(ready, edges, survivor_t)
        participating = int((ready > -np.inf).sum())
        hop = self.edge_hop_seconds(self.edge_payload_bytes(uplink_bytes))
        t_end = max(float(t_policy_end), float(ready.max()) + hop)
        server_bytes = participating * self.edge_payload_bytes(uplink_bytes)
        return t_end, participating, server_bytes

    def meta(self) -> dict:
        """Run-level metadata for ``Trace.meta``."""
        return {"topology": self.kind, "topology_edges": self.num_edges,
                "topology_edge_uplink_bps": self.edge_uplink_bps}

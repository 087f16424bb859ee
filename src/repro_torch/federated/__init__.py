"""Heterogeneous federated simulation subsystem (twin of
``repro/federated``).

The paper's value proposition is what FedLite saves on the wire; this
package measures it, in both directions, with the real wire format.

  runtime.py    — the algorithm drivers: FedAvg, cohort sampling, weighted
                  aggregation, and `FederatedTrainer`, which runs SplitFed /
                  FedLite rounds through the scheduler and measures both
                  directions' payloads through the wire codec.
  executor.py   — the cohort execution engine: ``"stacked"`` (one
                  device) and ``"mesh"`` (cohort-parallel over a
                  ``clients`` DeviceMesh, one process per shard).
  wire.py       — the versioned tagged wire codec, byte for byte the
                  reference's frames (v1–v4, CRC32 trailer, typed errors).
  network.py    — `ClientProfile`, the struct-of-arrays `ClientFleet` and
                  the fleet samplers.
  scheduler.py  — the virtual-clock round core (`FullSync`,
                  `DropSlowestK`, `Deadline`, `AsyncBuffer`; heapq and
                  vector backends with bitwise-identical traces).
  trace.py      — `RoundRecord` / `Trace`, the measurement product.
  faults.py     — the seeded chaos layer (`FaultPlan`, `DEFAULT_CHAOS`).
  topology.py   — `TwoTierTopology`, edge aggregators over clustered
                  client locations.
  recovery.py   — crash-consistent runtime snapshots and
                  `run_with_recovery`, which survives a `ServerKilled`
                  bitwise.
  autoscale.py  — `TraceAutoscaler` / `autoscale_run`: trace-driven
                  (cohort, policy, downlink codec) moves between segments.
"""

from repro_torch.federated.autoscale import (
    DOWNLINK_LADDER,
    AutoscalePlan,
    TraceAutoscaler,
    autoscale_run,
    make_policy,
)
from repro_torch.federated.executor import (
    CohortExecutor,
    MeshExecutor,
    StackedExecutor,
    available_executors,
    make_executor,
    register_executor,
)
from repro_torch.federated.faults import (
    DEFAULT_CHAOS,
    FaultInjector,
    FaultPlan,
    ServerKilled,
    make_injector,
)
from repro_torch.federated.network import (
    IDEAL,
    ClientFleet,
    ClientProfile,
    lognormal_fleet,
    mobile_fleet,
    uniform_fleet,
    validate_fleet,
)
from repro_torch.federated.runtime import (
    FederatedTrainer,
    fedavg_round,
    run_fedavg,
    sample_clients,
    weighted_average,
)
from repro_torch.federated.recovery import (
    restore_runtime,
    run_with_recovery,
    snapshot_runtime,
)
from repro_torch.federated.scheduler import (
    AsyncBuffer,
    Deadline,
    DropSlowestK,
    FullSync,
    Scheduler,
    ideal_scheduler,
)
from repro_torch.federated.topology import TwoTierTopology
from repro_torch.federated.trace import RoundRecord, Trace
from repro_torch.federated import wire

__all__ = [
    "AsyncBuffer", "AutoscalePlan", "ClientFleet", "ClientProfile",
    "CohortExecutor", "DEFAULT_CHAOS", "DOWNLINK_LADDER", "Deadline",
    "DropSlowestK", "FaultInjector", "FaultPlan", "FederatedTrainer",
    "FullSync", "IDEAL", "MeshExecutor", "RoundRecord", "Scheduler",
    "ServerKilled", "StackedExecutor", "Trace", "TraceAutoscaler",
    "TwoTierTopology", "autoscale_run", "available_executors",
    "fedavg_round", "ideal_scheduler", "lognormal_fleet", "make_executor",
    "make_injector", "make_policy", "mobile_fleet", "register_executor",
    "restore_runtime", "run_fedavg", "run_with_recovery", "sample_clients",
    "snapshot_runtime", "uniform_fleet", "validate_fleet",
    "weighted_average", "wire",
]

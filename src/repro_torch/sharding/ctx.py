"""Sharding context (twin of the ``clients`` half of
``repro/sharding/ctx.py``): a process-wide ``DeviceMesh`` and the
placement of client-major data over its ``clients`` axis.

The reference places arrays with ``NamedSharding``: a client-major array's
leading axis split over ``clients`` (``clients_sharding``), or the whole
array on every device (``replicated_sharding``). The port runs one
process per shard (SPMD), so placement is a question each rank answers
for itself: it holds the contiguous block of client slots that
``local_slots`` names, and everything else (the train state) is
replicated, one full copy per rank, with no call needed.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh

# The cohort-parallel mesh axis: one shard = one slice of a round's client
# cohort. Built by ``launch/mesh.make_clients_mesh`` and used by the
# ``"mesh"`` cohort executor (``federated/executor.py``), whose step sums
# the shards' weighted gradients with one all-reduce over this axis.
CLIENTS_AXIS = "clients"

_MESH: Optional[DeviceMesh] = None


def clients_rank(mesh: DeviceMesh) -> int:
    """This process's coordinate on ``mesh``'s ``clients`` axis."""
    return mesh.get_local_rank(CLIENTS_AXIS)


def local_slots(slots: int, mesh: DeviceMesh,
                rank: Optional[int] = None) -> range:
    """The block of ``slots`` client slots (a multiple of the ``clients``
    axis size) that ``rank`` holds (default: this process): the leading
    axis split by rank into equal contiguous blocks."""
    shards = mesh.size(mesh.mesh_dim_names.index(CLIENTS_AXIS))
    if slots % shards:
        raise ValueError(f"{slots} client slots do not split over "
                         f"{shards} shards")
    per = slots // shards
    r = clients_rank(mesh) if rank is None else rank
    return range(r * per, (r + 1) * per)


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Install (or clear, with None) the process-wide mesh."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional[DeviceMesh]:
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]):
    """Install ``mesh`` for the duration of the block."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_size(name: str) -> int:
    """Size of an axis of the installed mesh, or 1 if there is no mesh or
    it has no such axis."""
    if _MESH is None or name not in (_MESH.mesh_dim_names or ()):
        return 1
    return _MESH.size(_MESH.mesh_dim_names.index(name))

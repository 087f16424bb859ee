"""The cohort-parallel ``clients`` mesh (twin of
``repro/launch/mesh.make_clients_mesh``).

The port runs one process per shard, each holding one device, and the
mesh is a 1-D ``DeviceMesh`` over the ranks of the default process group.
Launch the ranks with ``torchrun --nproc-per-node N`` (which sets the
rendezvous in the environment; call ``torch.distributed.
init_process_group`` before building the trainer) or with
``torch.multiprocessing.spawn`` and a store of your own. Importing this
module touches no process group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.ctx import CLIENTS_AXIS


def mesh_backend(device) -> str:
    """The collective backend that serves ``device``: NCCL for a CUDA
    device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_clients_mesh(shards: int = 0, device=None,
                      backend: Optional[str] = None) -> DeviceMesh:
    """1-D ``("clients",)`` mesh over the ranks of the default process
    group, each rank's tensors on ``device`` (default ``"cuda"``).

    ``shards=0`` takes the world size of the initialised default group.
    With no group initialised, a world of one is set up through an
    in-process store (no port, no network); a request for more shards
    then raises, naming how to launch more ranks. ``backend`` defaults to
    the device's (``mesh_backend``); gloo may be asked for on a CUDA
    device (several ranks on one card, which NCCL refuses). A group
    already initialised with another backend raises: nothing swaps one
    backend for the other.
    """
    device = torch.device("cuda" if device is None else device)
    want = backend or mesh_backend(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_clients_mesh: no CUDA device; pass device='cpu' for a "
                "CPU mesh (gloo)")
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        if shards > 1:
            raise RuntimeError(
                f"a {shards}-shard clients mesh needs {shards} ranks and no "
                f"process group is initialised; launch {shards} ranks "
                f"(`torchrun --nproc-per-node {shards}` or "
                f"`torch.multiprocessing.spawn`) and call "
                f"torch.distributed.init_process_group in each first")
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    n = shards or world
    if n != world:
        raise RuntimeError(
            f"a {n}-shard clients mesh needs a world of {n} ranks, this "
            f"process group has {world}; launch {n} ranks (`torchrun "
            f"--nproc-per-node {n}` or `torch.multiprocessing.spawn`)")
    have = dist.get_backend()
    if want not in str(have).replace(",", ":").split(":"):
        raise RuntimeError(
            f"the default process group runs {have!r}, the mesh asks for "
            f"{want!r} on {device.type}; initialise the group with {want!r}")
    return init_device_mesh(device.type, (n,),
                            mesh_dim_names=(CLIENTS_AXIS,))

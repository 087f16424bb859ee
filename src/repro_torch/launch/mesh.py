"""Meshes (twin of ``repro/launch/mesh.py``): the production ``("data",
"model")`` meshes, a small debug mesh of the same axes, the cohort-parallel
``clients`` mesh, and the card's constants for the roofline.

The port runs one process per device, and a mesh is a ``DeviceMesh`` over
ranks of the default process group. Launch the ranks with ``torchrun
--nproc-per-node N`` (which sets the rendezvous in the environment; call
``torch.distributed.init_process_group`` before building a mesh) or with
``torch.multiprocessing.spawn`` and a store of your own. The dry run
(``launch/dryrun.py``) builds the production meshes over a fake process
group of 256 or 512 ranks. Importing this module touches no process group.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding.ctx import CLIENTS_AXIS

SINGLE_POD = (16, 16)                  # 256 devices
MULTI_POD = (2, 16, 16)                # 2 pods = 512 devices


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


def _world_of_one(device: torch.device, backend: Optional[str]) -> None:
    """A world of one through an in-process store (no port, no network),
    unless a process group is initialised already."""
    if not dist.is_initialized():
        dist.init_process_group(backend or mesh_backend(device),
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def init_world(device) -> bool:
    """The launchers' process group: the one ``torchrun`` describes in
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``), else a
    world of one. Returns True if this call initialised it (the caller
    then destroys it), False if a group was initialised already."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(mesh_backend(device))
    else:
        _world_of_one(device, None)
    return True


class MeshTooSmall(RuntimeError):
    """The process group has fewer ranks than the mesh asked for."""


def _mesh_over(shape, axes, device, what: str) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first prod(shape) ranks of
    the default group; too small a world raises, naming the ranks
    needed."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise MeshTooSmall(
            f"need {n} ranks for {what} mesh {shape}, have {world}: launch "
            f"{n} (`torchrun --nproc-per-node ...` across the hosts, "
            f"calling torch.distributed.init_process_group in each), or "
            f"trace the step without devices on a fake process group "
            f"(`python -m repro_torch.launch.dryrun`)")
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return DeviceMesh(device.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """(data=16, model=16) single-pod or (pod=2, data=16, model=16)
    multi-pod, over the first 256 or 512 ranks of the default group (so a
    512-rank group serves both meshes)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh_over(shape, axes, device,
                      "the multi-pod" if multi_pod else "the single-pod")


def make_debug_mesh(data: int = 2, model: int = 2, pods: int = 0, *,
                    device="cuda",
                    backend: Optional[str] = None) -> DeviceMesh:
    """Small mesh of the production axes (needs data·model·max(pods, 1)
    ranks; a mesh of one sets up a world of one if no group is
    initialised)."""
    if pods:
        shape, axes = (pods, data, model), ("pod", "data", "model")
    else:
        shape, axes = (data, model), ("data", "model")
    device = torch.device(device)
    if math.prod(shape) == 1:
        _world_of_one(device, backend)
    return _mesh_over(shape, axes, device, "the debug")


# The roofline's constants for launch/analysis.py, per card; each is the
# datasheet's number for an H100 SXM5 80GB HBM3, 700 W, but HBM_BYTES,
# the memory.total nvidia-smi reports on that card (81559 MiB)
# dense bf16 tensor-core peak, FLOP/s (H100 SXM5 80GB HBM3, 700 W)
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth, bytes/s (H100 SXM5 80GB HBM3, 700 W)
HBM_BW = 3.35e12
# NVLink 4, bytes/s per link per direction (H100 SXM5 80GB HBM3, 700 W)
NVLINK_BW_PER_LINK = 25e9
# NVLink 4 links per card (H100 SXM5 80GB HBM3, 700 W)
NVLINK_LINKS = 18
# device memory as nvidia-smi reports it (H100 SXM5 80GB HBM3, 700 W)
HBM_BYTES = 81559 * 1024 ** 2
HBM_KEY = "fits_80GB"           # the dry-run record's key for HBM_BYTES

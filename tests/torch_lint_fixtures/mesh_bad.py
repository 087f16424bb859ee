"""Seeded mesh-dimension typos for the port's lint. Never imported."""
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import P, shard

CLIENTS_AXIS = "clients"

mesh = init_device_mesh("cuda", (2, 4), mesh_dim_names=("data", "model"))

SPEC = P("data", "modle")  # SEED: mesh-axis-undeclared


def step(x, w):
    x = shard(x, "data", "client")  # SEED: mesh-axis-undeclared
    n = ctx.axis_size("mdoel")  # SEED: mesh-axis-undeclared
    y = ctx.local(lambda a: a * n, P("batch"),  # SEED: mesh-axis-undeclared
                  (P("data"),))(x)
    group = mesh.get_group("clients_")  # SEED: mesh-axis-undeclared
    dist.all_reduce(y, group=group)
    return mesh["pod"].size()  # SEED: mesh-axis-undeclared

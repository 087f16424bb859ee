"""Mesh-dimension uses that match the declarations. Never imported."""
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import P, shard

CLIENTS_AXIS = "clients"


def make(multi_pod: bool):
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh("cuda", [[0]], mesh_dim_names=axes)


clients = init_device_mesh("cuda", (1,), mesh_dim_names=(CLIENTS_AXIS,))
RULES = [(r"/wq$", {2: P("data", "model")}), (r"/wo$", {2: P("model")})]


def step(x, mesh):
    x = shard(x, ("pod", "data"), None, "model")
    n = ctx.axis_size("model") * ctx.axis_rank("data")
    y = ctx.local(lambda a: a * n, P("data"), (P("data"),))(x)
    dist.all_reduce(y, group=clients.get_group(CLIENTS_AXIS))
    table = {"loss": 1.0}
    return mesh["pod"].size(), table["loss"]

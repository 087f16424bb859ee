from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.optim.schedules import constant

__all__ = ["Optimizer", "sgd", "constant"]

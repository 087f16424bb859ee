from repro_torch.optim.optimizers import (Optimizer, adafactor, adagrad, adam,
                                          get_optimizer, momentum, sgd)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = ["Optimizer", "adafactor", "adagrad", "adam", "constant",
           "cosine_decay", "get_optimizer", "momentum", "sgd",
           "warmup_cosine"]

"""A kernel wrapper with a host sync, parsed by tests/test_torch_lint.py
under a ``src/repro_torch/kernels/`` pseudo-path: every function there is
on a step's path."""
import torch


def scale_kernel(x: torch.Tensor, bits: int) -> torch.Tensor:
    levels = float((1 << bits) - 1)
    hi = x.max().item()  # SEED: host-sync-in-step
    return x * (levels / hi)


def occupancy(x: torch.Tensor):
    torch.cuda.synchronize()  # SEED: host-sync-in-step
    return int(x.numel())

"""Seeded kernel fallbacks, parsed under a ``src/repro_torch/kernels/``
pseudo-path. Never imported."""
from repro_torch.kernels import ref
from repro_torch.kernels.ref import pq_quantize_ref as plain_pq


def lloyd(x, w, c):
    try:
        return launch(x, w, c)
    except RuntimeError:
        return ref.lloyd_update_ref(x, w, c)  # SEED: kernel-fallback


def pq(x, c):
    try:
        return launch(x, c)
    except (OSError, RuntimeError):
        return plain_pq(x, c)  # SEED: kernel-fallback


def launch(*args):
    raise RuntimeError("no card")

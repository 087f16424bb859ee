"""A wrapper that takes the plain version on a CPU tensor only and raises
on the card. Never imported."""
from repro_torch.kernels import ref


def lloyd(x, w, c):
    if x.device.type == "cpu":
        return ref.lloyd_update_ref(x, w, c)
    try:
        return launch(x, w, c)
    except RuntimeError as e:
        raise RuntimeError(f"lloyd_update: launch failed: {e}") from e


def launch(*args):
    raise RuntimeError("no card")

"""Device time of the Adafactor update's kernels per profiled step: the
profiled operations whose name contains ``adafactor_`` (the fused kernel's
passes, ``csrc/adafactor.cu``). None where no such operation ran."""

from fedbench import tracing

LAYER = "LM step"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train" or r.profiled is None or not r.profiled_units:
        return None
    seconds, launches = tracing.device_seconds(r.profiled, "adafactor_")
    if not launches:
        return None
    return 1e3 * seconds / r.profiled_units

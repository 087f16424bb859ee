"""Device time of the SSD scan's kernels per profiled step: the profiled
operations whose name contains ``ssd_`` (the fused scan's forward and
backward kernels, ``csrc/ssd_scan.cu``). None where no such operation ran
(a program whose scan takes the plain chunk loop)."""

from fedbench import tracing

LAYER = "LM step"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train" or r.profiled is None or not r.profiled_units:
        return None
    seconds, launches = tracing.device_seconds(r.profiled, "ssd_")
    if not launches:
        return None
    return 1e3 * seconds / r.profiled_units

"""Device time of the MoE's dispatch and combine kernels per profiled
step: the profiled operations whose name contains ``moe_`` (the slot map,
the slot gather and the token reduce, ``csrc/moe_dispatch.cu``, forward
and backward). None where no such operation ran (a program whose MoE
takes the plain route)."""

from fedbench import tracing

LAYER = "LM step"
UNIT = "ms/step"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train" or r.profiled is None or not r.profiled_units:
        return None
    seconds, launches = tracing.device_seconds(r.profiled, "moe_")
    if not launches:
        return None
    return 1e3 * seconds / r.profiled_units

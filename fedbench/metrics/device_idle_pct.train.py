"""Share of the profiled stretch's wall time in which no operation ran on
the device (the union of the trace's device intervals)."""

from fedbench import tracing

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train" or r.profiled is None \
            or not r.profiled.device_ops or r.profiled.window_s <= 0:
        return None
    return 100.0 * (1.0 - tracing.busy_s(r.profiled) / r.profiled.window_s)

"""Operations the device ran per step in the profiled stretch: kernels,
copies and sets, from the profiler's trace. The count the SSD's chunk
loop and the MoE's per-choice scatters and gathers drive."""

LAYER = "LM step"
UNIT = "launches/step"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train" or r.profiled is None or not r.profiled_units \
            or not r.profiled.device_ops:
        return None
    return len(r.profiled.device_ops) / r.profiled_units

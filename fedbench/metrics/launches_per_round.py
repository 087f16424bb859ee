"""Operations the device ran per round in the profiled stretch: kernels,
copies and sets, from the profiler's trace."""

LAYER = "executor"
UNIT = "launches/round"
SOURCE = "device_trace"
MOVES = "round_ms"


def read(r):
    if r.kind != "round" or r.profiled is None or not r.profiled_units \
            or not r.profiled.device_ops:
        return None
    return len(r.profiled.device_ops) / r.profiled_units

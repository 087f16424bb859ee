"""Model FLOPs of the window's whole rounds over its wall time, as a share
of the card's peak (67 TFLOP/s (f32)); the FLOPs come from ``counts/``."""

LAYER = "train step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "round_ms"


def read(r):
    if r.kind != "round" or not r.units or r.wall_s <= 0:
        return None
    return 100.0 * r.units * r.unit_flops / r.wall_s / r.peak_flop_per_s

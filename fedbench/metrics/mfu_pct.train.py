"""Model FLOPs of the window's whole trains over its wall time, as a share
of the card's peak (989 TFLOP/s (bf16)); the FLOPs come from ``counts/``."""

LAYER = "LM step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train" or not r.units or r.wall_s <= 0:
        return None
    return 100.0 * r.units * r.unit_flops / r.wall_s / r.peak_flop_per_s

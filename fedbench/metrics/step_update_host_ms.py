"""Host time of a round's optimizer update: the program's
``step.update`` span (the optimizer's update and the new params), one
inside each ``scheduler.round``. A part of ``executor.execute``."""

from fedbench.metrics._round_spans import per_round

LAYER = "train step"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    return per_round(r, "step.update")

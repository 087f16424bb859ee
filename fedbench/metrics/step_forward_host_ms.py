"""Host self time of a round's forward: the program's ``step.forward``
span (the params' flattening and the model's forward, launches included),
one inside each ``scheduler.round``, less the ``kmeans.lloyd`` spans
inside it. A part of ``executor.execute``."""

from fedbench.metrics._round_spans import per_round

LAYER = "train step"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    calls = getattr(r, "kmeans_calls_per_round", 0)
    return per_round(r, "step.forward", less=("kmeans.lloyd", calls))

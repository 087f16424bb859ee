"""Host time of a round's backward: the program's ``step.backward`` span
(``torch.autograd.grad`` through the server, the eq.-5 correction and the
client, and the gradients' relayout), one inside each ``scheduler.round``.
A part of ``executor.execute``."""

from fedbench.metrics._round_spans import per_round

LAYER = "train step"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    return per_round(r, "step.backward")

"""Host time of a round's batch draws: the program's
``trainer.draw_batches`` span (the cohort's ``client_batch_for`` calls),
one inside each ``scheduler.round``. A part of ``trainer_overhead_ms``."""

from fedbench.metrics._round_spans import per_round

LAYER = "trainer"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    return per_round(r, "trainer.draw_batches")

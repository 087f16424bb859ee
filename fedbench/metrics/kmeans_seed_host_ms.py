"""Host time of a round's k-means seeding: the program's ``kmeans.seed``
spans (farthest-point seeding, its L - 1 host steps), as many inside each
``scheduler.round`` as the k-means calls a round makes, none on a cell
without them. A part of ``kmeans_host_ms``."""

from fedbench.metrics._round_spans import per_round

LAYER = "k-means"
UNIT = "ms/round"
SOURCE = "program_span"
MOVES = "round_ms"


def read(r):
    return per_round(r, "kmeans.seed",
                     count=getattr(r, "kmeans_calls_per_round", 0))

"""Work of the cut's two kernels, from the shape of a call.

x is the quantizer's grouped input (P, N, D) with P = clients x groups, in
its own dtype (f32 or bf16, ``itemsize`` bytes a value); the codebook is
(P, L, D) f32. Each input byte is counted as read once and each output
byte as written once; the operations are those the assignment and the
update need per row. Both kernels compute in f32 on the CUDA cores, so
their peak is the f32 one whatever x's dtype.
"""

from __future__ import annotations

from typing import Tuple

from fedbench.counts.peaks import F32_FLOP_PER_S, least_seconds


def lloyd_update_work(p: int, n: int, d: int, l: int,
                      itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one ``lloyd_update``: x and the codebook
    read, the deviation sums (P, L, D) and counts (P, L) written; per row
    2·L·D for the scores, D subtractions, D adds and a count."""
    nbytes = p * n * d * itemsize + p * l * d * 4 + p * l * (d + 1) * 4
    return float(nbytes), float(p * n * (2 * l * d + 2 * d + 1))


def pq_quantize_work(p: int, n: int, d: int, l: int,
                     itemsize: int) -> Tuple[float, float]:
    """(bytes, operations) of one ``pq_quantize``: x and the codebook
    read; z̃ (x's dtype), the f32 residual and the int32 codes written;
    per row 2·L·D for the scores and D subtractions."""
    nbytes = 2 * p * n * d * itemsize + p * n * d * 4 + p * n * 4 \
        + p * l * d * 4
    return float(nbytes), float(p * n * (2 * l * d + d))


WORK = {"lloyd_update": lloyd_update_work, "pq_quantize": pq_quantize_work}


def least_seconds_of(kernel: str, p: int, n: int, d: int, l: int,
                     itemsize: int) -> float:
    nbytes, flops = WORK[kernel](p, n, d, l, itemsize)
    return least_seconds(nbytes, flops, F32_FLOP_PER_S)


# the device kernels of each op, by name in the profiler's trace
KERNELS = {"lloyd_update": r"\blloyd_(d8|generic|tiled_codes|tiled_stats"
                           r"|reduce)\b",
           "pq_quantize": r"\bpq_(d8|generic)\b"}


def roofline_pct(profiled, calls) -> "float | None":
    """The share of their roofline that the cut's kernels reached in a
    profiled stretch: the summed least times of the calls made there
    (``calls``: (kernel, P, N, D, L, itemsize) each) over the summed
    device times of those kernels' launches. None where the stretch has
    no such call or no device time."""
    from fedbench import tracing
    if profiled is None or not calls:
        return None
    least = sum(least_seconds_of(*c) for c in calls)
    spent = sum(tracing.device_seconds(profiled, rx)[0]
                for rx in KERNELS.values())
    if spent <= 0:
        return None
    return 100.0 * least / spent

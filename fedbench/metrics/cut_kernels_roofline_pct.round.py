"""Share of their roofline that the cut's kernels (``lloyd_update``,
``pq_quantize``) reached in the profiled stretch: the least times of
the calls made there, from their shapes (``counts/cut_kernels.py``),
over those kernels' device times in the trace."""

from fedbench.counts import cut_kernels

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "round_ms"


def read(r):
    if r.kind != "round":
        return None
    return cut_kernels.roofline_pct(r.profiled, r.kernel_calls)

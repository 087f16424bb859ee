"""Share of their roofline that the cut's kernels (``lloyd_update``,
``pq_quantize``) reached in the profiled stretch: the least times of
the calls made there, from their shapes (``counts/cut_kernels.py``),
over those kernels' device times in the trace."""

from fedbench.counts import cut_kernels

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"


def read(r):
    if r.kind != "train":
        return None
    return cut_kernels.roofline_pct(r.profiled, r.kernel_calls)

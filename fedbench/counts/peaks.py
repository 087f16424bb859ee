"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # CUDA cores, no tensor cores (TF32 off)
BF16_FLOP_PER_S = 989e12        # tensor cores, dense


def least_seconds(nbytes: float, flops: float,
                  flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time the card could take for the work: the larger of its
    bytes over the memory rate and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit) and the least time a piece of work can take on it.

Every roofline metric divides :func:`bound_s` of the work the function
needs (each input byte read once, each output byte written once, the
operations the algorithm performs) by the traced device time of the
kernels that did it.
"""

HBM_BPS = 3.35e12        # HBM3 bytes/s
F32_FLOPS = 67e12        # fp32 FLOP/s outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of ``nbytes`` over the HBM bandwidth and ``ops`` fp32
    operations over the fp32 peak, in seconds."""
    return max(nbytes / HBM_BPS, ops / F32_FLOPS)

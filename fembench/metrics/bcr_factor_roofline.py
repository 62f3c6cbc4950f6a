"""Block-cyclic reduction's factorization against its roofline: per
factorization, the least time of ``counts.bcr`` at the slope's lattice
blocks over the device time of the operations launched inside
``parallel.bcr.bcr_factor``."""

from fembench.counts.bcr import factor_bound_s

LAYER = "Linear solve, BCR"
MOVES = "step_s"
UNIT = "%"
SPANS = ("fembench.bcr_factor",)


def read(trace, ctx):
    factors, t = trace.span_count(SPANS[0]), trace.device_s_in(*SPANS)
    if not factors or t <= 0:
        return None
    return 100.0 * factors * factor_bound_s(*ctx["bcr_blocks"]) / t

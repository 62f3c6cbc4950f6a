"""Device milliseconds of the operations launched inside the fused step's
``_constitutive`` (E1, the strain, and K1, the return map with its
tangent), per Newton pass."""

LAYER = "Constitutive"
MOVES = "step_s"
UNIT = "ms"
SPANS = ("fembench.constitutive",)


def read(trace, ctx):
    passes, t = trace.span_count(SPANS[0]), trace.device_s_in(*SPANS)
    if not passes or t <= 0:
        return None
    return 1e3 * t / passes

"""Milliseconds per Newton update that the AMG-CG set-up holds the card
for: the device time of the operations launched inside
``fembench.mg_setup`` (around ``parallel.mg.mg_setup``, the hierarchy's
f32 values from the tangent, written into the solver's workspace; and
around ``cuda_graphed``, which the general path calls only under gmres)
plus the idle gaps begun inside it, over the updates of the traced
window.  The CUDA graphs of cg's PCG batches are captured inside the
solve, not here."""

LAYER = "Linear solve, AMG-CG"
MOVES = "step_s"
UNIT = "ms"
SPAN = "fembench.mg_setup"


def read(trace, ctx):
    if not trace.span_count(SPAN) or trace.busy_s <= 0 or not ctx.get("updates"):
        return None
    return 1e3 * (trace.device_s_in(SPAN) + trace.idle_s_in(SPAN)) / ctx["updates"]

"""The card's idle time per Newton update that began inside the AMG-CG
solve (``fembench.mg_solve``, around ``_mg_solve``: the hierarchy's f32
values from the tangent, the capture of the cycle's CUDA graph, and the
f32 PCG inside f64 refinement, whose loop tests read the residual on the
host), over the updates of the traced window."""

LAYER = "Linear solve, AMG-CG"
MOVES = "step_s"
UNIT = "ms"
SPAN = "fembench.mg_solve"


def read(trace, ctx):
    if not trace.span_count(SPAN) or trace.busy_s <= 0 or not ctx.get("updates"):
        return None
    return 1e3 * trace.idle_s_in(SPAN) / ctx["updates"]

"""The general path's direct solve against its roofline: per update, the
least time of an LU of the n x n tangent (``counts.dense``) over the device
time of the operations launched inside ``solvers._lu_ir`` (the pivoted f32
``lu_factor32`` and the f64 refinement of ``lu_refine``)."""

from fembench.counts.dense import lu_bound_s

LAYER = "Linear solve, general"
MOVES = "step_s"
UNIT = "%"
SPANS = ("fembench.lu_ir",)


def read(trace, ctx):
    solves, t = trace.span_count(SPANS[0]), trace.device_s_in(*SPANS)
    if not solves or t <= 0:
        return None
    return 100.0 * solves * lu_bound_s(ctx["n_dofs_reference"]) / t

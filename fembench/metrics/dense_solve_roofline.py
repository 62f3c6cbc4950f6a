"""The fused dense solve's share of its roofline: per update, the least
time of a Cholesky of the n x n f32 tangent (``counts.dense``) over the
device time of the operations launched inside ``_dense_solve`` (assembly
of the f32 matrix, equilibration, the factorization, its triangular solves
and the f64 refinement)."""

from fembench.counts.dense import cholesky_bound_s

LAYER = "Linear solve, fused dense"
MOVES = "step_s"
UNIT = "%"
SPANS = ("fembench.dense_solve",)


def read(trace, ctx):
    solves, t = trace.span_count(SPANS[0]), trace.device_s_in(*SPANS)
    if not solves or t <= 0:
        return None
    return 100.0 * solves * cholesky_bound_s(ctx["n_dofs_reference"]) / t

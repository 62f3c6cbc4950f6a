"""f64 refinement rounds of AMG-CG per Newton update in the traced window:
the program's ``deo.solve.round`` spans (each an f32 PCG solve and the f64
residual after it, ``parallel.mg.ir_pcg``) over its ``deo.solve`` spans,
as ``utils.profiling.span_counts`` counted them while the profiler
recorded.  A program without those spans reads nothing here."""

LAYER = "Linear solve, AMG-CG"
MOVES = "step_s"
UNIT = "rounds/update"


def read(trace, ctx):
    try:
        from dolfinx_external_operator_torch.utils.profiling import span_counts
    except ImportError:
        return None
    spans = span_counts()
    if not spans.get("deo.solve"):
        return None
    return spans.get("deo.solve.round", 0) / spans["deo.solve"]

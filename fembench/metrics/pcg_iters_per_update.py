"""f32 PCG iterations of AMG-CG per Newton update in the traced window:
the program's ``solve.inner`` counter (``parallel.mg.ir_pcg``, from its
host-side count) as it grew while the profiler recorded, over its
``deo.solve`` spans (one an update), as ``utils.profiling`` counted them.
Each iteration is one cycle.  A program without that counter reads
nothing here."""

LAYER = "Linear solve, AMG-CG"
MOVES = "step_s"
UNIT = "iters/update"


def read(trace, ctx):
    try:
        from dolfinx_external_operator_torch.utils.profiling import recorded_counts, span_counts
    except ImportError:
        return None
    spans, inner = span_counts(), recorded_counts().get("solve.inner")
    if not spans.get("deo.solve") or inner is None:
        return None
    return inner / spans["deo.solve"]

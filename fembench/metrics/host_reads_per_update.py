"""Device-to-host reads per Newton update in the traced window: the
program's ``deo.host_read`` spans over its ``deo.solve`` spans (one an
update), as ``utils.profiling.span_counts`` counted them while the
profiler recorded.  Each read drains the card's queue before the host
goes on.  A program without those spans reads nothing here."""

LAYER = "Host"
MOVES = "step_s"
UNIT = "reads/update"


def read(trace, ctx):
    try:
        from dolfinx_external_operator_torch.utils.profiling import span_counts
    except ImportError:
        return None
    spans = span_counts()
    if not spans.get("deo.solve"):
        return None
    return spans.get("deo.host_read", 0) / spans["deo.solve"]

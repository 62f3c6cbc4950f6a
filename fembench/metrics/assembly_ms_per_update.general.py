"""Device milliseconds of the general path's operand evaluation (E5), the
external operator's callback (K1), and the forms' vector, matrix and
lifting calls, per Newton update."""

LAYER = "Operand evaluation and assembly"
MOVES = "step_s"
UNIT = "ms"
SPANS = ("fembench.evaluate_operands", "fembench.evaluate_external_operators",
         "fembench.form_vector", "fembench.form_matrix", "fembench.form_action")


def read(trace, ctx):
    t = trace.device_s_in(*SPANS)
    if not ctx.get("updates") or t <= 0:
        return None
    return 1e3 * t / ctx["updates"]

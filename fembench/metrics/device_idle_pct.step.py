"""The share of the traced window in which no operation ran on the card,
in a load-step cell: the host's part of a step (Python, launches, the
Newton loop's reads of the residual norm)."""

LAYER = "Device"
MOVES = "step_s"
UNIT = "%"


def read(trace, ctx):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

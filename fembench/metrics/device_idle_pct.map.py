"""The share of the traced window in which no operation ran on the card,
in the return-map cell: the host's cost per call (the wrapper's checks,
its constants, the launch) where it outruns the kernel."""

LAYER = "Device"
MOVES = "gauss_pts_per_s"
UNIT = "%"


def read(trace, ctx):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

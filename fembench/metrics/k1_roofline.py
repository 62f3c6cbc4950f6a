"""K1's share of its roofline: the least time of the traced calls
(``counts.mc`` with the iterations the reference takes on each call's
batch) over the device time of K1's two kernels, ``mc_trial_pass`` and
``mc_plastic_pass``, found by name."""

from fembench.counts.mc import bound_s

LAYER = "Kernel K1"
MOVES = "gauss_pts_per_s"
UNIT = "%"
KERNELS = r"^mc_(trial|plastic)_pass"


def read(trace, ctx):
    iters, calls = ctx.get("ref_iterations"), ctx.get("calls", 0)
    t = trace.device_s_of(KERNELS)
    if iters is None or not calls or t <= 0:
        return None
    per_batch = [bound_s(int(row.numel()), int(row.sum())) for row in iters]
    return 100.0 * sum(per_batch[k % len(per_batch)] for k in range(calls)) / t

"""The Mohr-Coulomb return map's work per point, frozen from
``utils/roofline.py:61-76`` and ``:108-125`` (``MC_BYTES_PER_POINT``,
``MC_ITER_OPS``, ``MC_FIXED_F32_OPS``, ``MC_FIXED_F64_OPS``, ``mc_ops``,
``mc_bound``).  Operations are counted by hand on one point's work, one per
add, multiply, divide, square root or trig call: a Newton iteration with
its six line-search candidates 2,125; per point besides its iterations 190
f32 and 1,590 f64 (the trial yield, the start of the polish, the tangent).
Bytes: the strain increment and previous stress read (8 f64), the tangent,
stress, yield value, residual and multiplier written (23 f64) and the
iteration count (int32).

The iterations are those the benchmark's reference takes on the same
inputs to the material's tolerance, so that the count reads the same work
whatever computes it.  The program's ``return_map_mfu`` also reports a
"hi" bracket, every lane at both phases' iteration caps: that is not the
work these inputs need, so it is not frozen here."""

from .peaks import F32_FLOPS_PER_S, F64_FLOPS_PER_S, HBM_BYTES_PER_S

BYTES_PER_POINT = 8 * 8 + (16 + 4 + 3) * 8 + 4
ITER_OPS = 2125
FIXED_F32_OPS = 190
FIXED_F64_OPS = 1590


def ops(points, iterations):
    """(f32, f64) operations of ``points`` lanes taking ``iterations`` Newton
    iterations in all."""
    return FIXED_F32_OPS * points + ITER_OPS * iterations, FIXED_F64_OPS * points


def bound_s(points, iterations):
    """The least time of one call: its bytes over HBM, or its operations
    over the f32 and f64 peaks, whichever is longer."""
    f32, f64 = ops(points, iterations)
    return max(BYTES_PER_POINT * points / HBM_BYTES_PER_S,
               f32 / F32_FLOPS_PER_S + f64 / F64_FLOPS_PER_S)

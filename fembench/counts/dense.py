"""Dense factorizations of the n x n tangent, f32: the least time of one
update's solve.

* The fused step's SPD tangent: a Cholesky, n^3 / 3 operations, or the f32
  matrix read once, 4 n^2 bytes, whichever takes longer at the peaks.
* The general path's ``lu_factor32`` with its refinement (``_lu_ir``):
  an LU, 2 n^3 / 3 operations (``chip_smoke.py:1476``, the bound of
  ``lu_factor32``), or the f64 matrix read once, 8 n^2 bytes."""

from .peaks import bound_s


def cholesky_bound_s(n):
    return bound_s(n ** 3 / 3, 4 * n * n)


def lu_bound_s(n):
    return bound_s(2 * n ** 3 / 3, 8 * n * n)

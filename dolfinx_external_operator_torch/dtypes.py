"""Pipeline dtype selection.

The port of ``dolfinx_external_operator_tpu/dtypes.py:35-64``: the working
precision of the form pipeline is a module-scoped scalar type consulted
when forms, expressions and Functions are built.

* ``torch.float64`` (default): the parity target against the JAX package;
* ``torch.float32``: the evaluate/assemble pipeline in f32 (Newton and
  Krylov solves stay f64, as in the JAX package).

It sets the port's own constructors only and never calls
``torch.set_default_dtype``.  Build AND first-evaluate forms inside the
context: a compiled form keeps the scalar type it was built with::

    with scalar_type_context(torch.float32):
        F_r, ops = replace_external_operators(F)
        b = fem.assemble_vector(F_r)   # float32
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["scalar_type_context", "default_scalar_type"]

_SUPPORTED = {torch.float64: torch.float64, torch.float32: torch.float32,
              np.float64: torch.float64, np.float32: torch.float32}


def as_torch_dtype(dtype) -> torch.dtype:
    """``torch.float64``/``float32`` or their numpy names as a torch dtype."""
    if isinstance(dtype, np.dtype):
        dtype = dtype.type
    try:
        return _SUPPORTED[dtype]
    except (KeyError, TypeError):
        raise NotImplementedError(
            f"scalar type {dtype!r}: the port's form pipeline runs in float64 or float32") from None


def default_scalar_type() -> torch.dtype:
    from . import assembly

    return assembly._F


@contextlib.contextmanager
def scalar_type_context(dtype):
    """Temporarily set the scalar type used by newly compiled forms,
    expressions, and Functions."""
    dtype = as_torch_dtype(dtype)
    from . import assembly, compile, expression, function

    targets = [(assembly, "_F"), (compile, "_F"), (expression, "_F"), (function, "_DTYPE")]
    saved = [(m, n, getattr(m, n)) for m, n in targets]
    for m, n in targets:
        setattr(m, n, dtype)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)

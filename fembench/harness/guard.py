"""The check that the process ran without JAX: no module whose top-level
name (the part before the first dot) is one of ``FORBIDDEN``, compared
whole, so that ``dolfinx_external_operator_torch`` is not taken for
``dolfinx_external_operator_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dolfinx_external_operator_tpu")


def forbidden_modules(names=None):
    """The sorted top-level names of ``names`` (default: ``sys.modules``)
    that are forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))

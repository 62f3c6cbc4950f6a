"""Carry arrays of the JAX package over to the port.

Both packages hold the fused step's statics and state as plain arrays with
the same keys, shapes and layouts; these helpers take them as numpy (for
example ``np.asarray(fp.statics[k])`` of a JAX step, or a mid-schedule
``(Du, sigma)``) and give the port's tensors.  With
``FusedPlasticityStep.from_statics`` a run can continue on the port from a
state the JAX package produced.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["statics_from_numpy", "state_from_numpy"]

# dtype of each statics entry (f64 where the JAX package is f64)
_STATICS_DTYPES = {
    "B": torch.float64,
    "wdet": torch.float64,
    "f_cell": torch.float64,
    "dofmap": torch.int64,
    "bc_mask": torch.bool,
    "bc_vals": torch.float64,
}


def statics_from_numpy(d, device=None):
    """The fused step's statics dict (``B``, ``wdet``, ``f_cell``,
    ``dofmap``, ``bc_mask``, ``bc_vals``) as tensors on ``device``."""
    dev = resolve_device(device)
    missing = set(_STATICS_DTYPES) - set(d)
    if missing:
        raise KeyError(f"statics lack {sorted(missing)}")
    return {k: torch.tensor(np.asarray(d[k]), dtype=dt, device=dev)
            for k, dt in _STATICS_DTYPES.items()}


def state_from_numpy(Du, sigma_n, device=None):
    """A load-step state: Du (n_dofs,) and sigma_n (nc_pad, nq, 4), f64."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(Du), dtype=torch.float64, device=dev),
            torch.tensor(np.asarray(sigma_n), dtype=torch.float64, device=dev))

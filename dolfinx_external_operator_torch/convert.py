"""Carry arrays of the JAX package over to the port.

Both packages hold the fused step's statics and state as plain arrays with
the same keys, shapes and layouts; these helpers take them as numpy (for
example ``np.asarray(fp.statics[k])`` of a JAX step, or a mid-schedule
``(Du, sigma)``) and give the port's tensors.  With
``FusedPlasticityStep.from_statics`` a run can continue on the port from a
state the JAX package produced.  A JAX step's BCR lattice map
(``fp.statics["bcr"]`` and ``fp._bcr_plan``) comes across with
``bcr_statics_from_numpy``, its AMG hierarchy (``fp.statics["mg"]`` and the
static ``fp._mg_*`` attributes) with ``mg_statics_from_numpy``.  A JAX
``Function``'s dof vector (``np.asarray(f.data)``) fills a port ``Function``
with ``function_from_numpy``, so that a general-path run can start from a
JAX state (the slope after k steps).  A JAX ``ICNN``'s parameters (the
dict of f64 numpy arrays of ``load_isihara_weights``, ``icnn.params`` as
numpy) become the port's module with ``icnn_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device

__all__ = ["MOHR_COULOMB_PARAMS", "bcr_statics_from_numpy", "function_from_numpy",
           "icnn_from_numpy", "mg_statics_from_numpy",
           "mohr_coulomb_from_params", "statics_from_numpy", "state_from_numpy"]

# the constructor arguments of MohrCoulombMaterial, in both packages
MOHR_COULOMB_PARAMS = ("E", "nu", "c", "phi", "psi", "theta_T", "a", "tol", "max_iter",
                       "n_polish", "max_iter32", "tol32")

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


# the arrays of the BCR lattice map
_BCR_ARRAYS = ("dst", "diag_fix", "diag_slot", "perm_l2o", "perm_o2l")


def bcr_statics_from_numpy(arrays, plan):
    """The BCR solver's lattice map as ``statics["bcr"]`` of
    ``FusedPlasticityStep.from_statics``: ``arrays`` keyed as the JAX
    package's ``fp.statics["bcr"]`` (numpy or convertible), ``plan`` its
    ``fp._bcr_plan`` ``(m, B, n, sentinel)``.  The result is keyed as
    ``parallel.bcr.build_bcr_statics`` returns it."""
    missing = set(_BCR_ARRAYS) - set(arrays)
    if missing:
        raise KeyError(f"BCR statics lack {sorted(missing)}")
    m, B, n, sentinel = (int(v) for v in plan)
    out = {k: np.asarray(arrays[k]) for k in _BCR_ARRAYS}
    out.update(m=m, B=B, n=n, sentinel=sentinel)
    return out


def mg_statics_from_numpy(arrays, *, dia0_offsets, dia1_offsets, t0_stencil, lat_shapes,
                          cheb_degree, gamma_coarse, mv0_mode):
    """The AMG hierarchy as ``statics["mg"]`` of
    ``FusedPlasticityStep.from_statics``: ``arrays`` is a JAX step's
    ``fp.statics["mg"]`` (nested dicts and lists of arrays, numpy or
    convertible), the keywords its static attributes ``fp._mg_dia_offsets``,
    ``_mg_dia1_offsets``, ``_mg_t0_stencil``, ``_mg_lat_shapes``,
    ``_mg_cheb_degree``, ``_mg_gamma`` and ``_mg_mv0_mode`` (the mode the
    step resolved to).  The result is keyed as
    ``parallel.mg.build_mg_statics`` returns it, plus ``gamma_coarse`` and
    ``mv0_mode``."""
    missing = {"levels", "transfers", "coarse_rows"} - set(arrays)
    if missing:
        raise KeyError(f"mg statics lack {sorted(missing)}")

    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [host(x) for x in v]
        return np.asarray(v)

    out = host(dict(arrays))
    static = {"dia0_offsets": dia0_offsets, "dia1_offsets": dia1_offsets,
              "t0_stencil": t0_stencil, "lat_shapes": lat_shapes}
    out.update({k: v for k, v in static.items() if v is not None})
    out.update(cheb_degree=int(cheb_degree), gamma_coarse=gamma_coarse, mv0_mode=mv0_mode)
    return out


def state_from_numpy(Du, sigma_n, device=None):
    """A load-step state: Du (n_dofs,) and sigma_n (nc_pad, nq, 4), f64."""
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(Du), dtype=torch.float64, device=dev),
            torch.tensor(np.asarray(sigma_n), dtype=torch.float64, device=dev))


def mohr_coulomb_from_params(d, device=None):
    """The port's ``MohrCoulombMaterial`` with the 12 constants of ``d``
    (keys ``MOHR_COULOMB_PARAMS``, e.g. the attributes of a JAX
    ``MohrCoulombMaterial``), taken as plain Python numbers so that both
    packages compute with identical constants.  ``device`` is checked as
    every entry point checks it (``None`` means CUDA); the material itself
    computes on the device of the tensors it is given."""
    from .models.mohr_coulomb import MohrCoulombMaterial

    resolve_device(device)
    missing = set(MOHR_COULOMB_PARAMS) - set(d)
    if missing:
        raise KeyError(f"Mohr-Coulomb constants lack {sorted(missing)}")
    ints = ("max_iter", "n_polish", "max_iter32")
    return MohrCoulombMaterial(**{k: int(d[k]) if k in ints else float(d[k])
                                  for k in MOHR_COULOMB_PARAMS})


def function_from_numpy(V, array, device=None, name=None):
    """A port ``Function`` on ``V`` holding ``array`` (a JAX Function's
    ``np.asarray(f.data)``, same dof numbering), in its dtype if it is f32
    or f64, on ``device`` (``None``: the card)."""
    from .function import Function

    arr = np.asarray(array)
    if arr.shape != (V.num_dofs,):
        raise ValueError(f"array of shape {arr.shape} for a space of {V.num_dofs} dofs")
    dtype = torch.float32 if arr.dtype == np.float32 else torch.float64
    f = Function(V, name=name, dtype=dtype, device=device)
    f.x.array[:] = arr
    return f


def icnn_from_numpy(weights, device=None):
    """The port's ``models.icnn.ICNN`` on ``device`` (``None``: the card)
    with the parameters ``weights``, a dict of arrays keyed as the
    checkpoint's state dict (``layers.0.weight``, ``layers.{i}.weights``,
    ``skip_layers.{i}.weight|bias|weights``)."""
    from .models.icnn import ICNN

    return ICNN({k: np.asarray(v, dtype=np.float64) for k, v in weights.items()}, device=device)

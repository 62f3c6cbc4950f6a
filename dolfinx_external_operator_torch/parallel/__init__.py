"""Cell-axis distribution of the general pipeline (the ``mpirun -n N``
analog), the counterpart of ``dolfinx_external_operator_tpu/parallel/
__init__.py:42-90``.

The JAX package shards the cell axis of every compiled form and
expression over a 1D ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives.  The port runs one process per rank (``dist.spawn``): once
``set_default_device_mesh`` installs this rank's ``dist.DeviceMesh``,
every ``CompiledForm`` and ``Expression`` compiled afterwards takes the
rank's rows of each cell batch.  A batch of ``n`` cells is padded to
``padded_cell_count(n)`` rows by repeating row 0, and rank ``r`` of
``size`` owns the contiguous block ``[r k, (r + 1) k)``, ``k = n_pad /
size``; the padded rows' contributions are zeroed (forms) or sliced off
(expressions).  Global dof vectors, and the data of quadrature-space
Functions, stay whole and identical on every rank (owner computes, no
ghost cells), so every rank takes the same branches.  The collectives are
``dist.all_gather`` (a form's per-cell contributions, an expression's
values, an external operator's results) and ``dist.psum`` (the AMG
level-0 sums), which every rank calls in the same order.  Without a mesh
every path is the unsharded one.

The hand-sharded fused step (``spmd.FusedPlasticityStep(device_mesh=
...)``) takes its mesh as an argument and does not read the default.

Usage, in each rank (``dist.spawn`` runs ``fn(mesh, ...)`` per rank)::

    from dolfinx_external_operator_torch import parallel
    parallel.set_default_device_mesh(mesh)
    # every CompiledForm / Expression built afterwards is sharded
"""

from __future__ import annotations

import numpy as np
import torch

from . import dist, spmd  # noqa: F401
from .dist import make_device_mesh
from .spmd import FusedPlasticityStep

_default_device_mesh = None

__all__ = [
    "FusedPlasticityStep",
    "dist",
    "get_default_device_mesh",
    "make_device_mesh",
    "pad_shard_cells",
    "padded_cell_count",
    "rank_rows",
    "set_default_device_mesh",
    "shard_cells",
    "spmd",
]


def set_default_device_mesh(device_mesh) -> None:
    """Install (or clear, with ``None``) this rank's ``dist.DeviceMesh``,
    over which newly compiled forms and expressions shard their cell
    axis."""
    global _default_device_mesh
    _default_device_mesh = device_mesh


def get_default_device_mesh():
    return _default_device_mesh


def padded_cell_count(n: int, device_mesh=None) -> int:
    """``n`` rounded up to a multiple of the mesh's rank count (``n``
    without a mesh).  ``device_mesh``: the default one when ``None``."""
    dm = device_mesh or _default_device_mesh
    if dm is None:
        return n
    return -(-n // dm.size) * dm.size


def rank_rows(n: int, device_mesh=None):
    """This rank's rows of a batch of ``n``: ``(rows, valid)``, the row
    indices of its block of the padded batch (a padded row repeats row 0)
    and whether each is a real row (numpy).  All ``n`` rows without a
    mesh.  ``device_mesh``: the default one when ``None``."""
    dm = device_mesh or _default_device_mesh
    if dm is None:
        return np.arange(n, dtype=np.int64), np.ones(n, dtype=bool)
    k = padded_cell_count(n, dm) // dm.size
    g = np.arange(dm.rank * k, (dm.rank + 1) * k, dtype=np.int64)
    valid = g < n
    return np.where(valid, g, 0), valid


def shard_cells(a):
    """This rank's block of a cell-leading-axis array as a tensor on the
    mesh's device; identity when no mesh is installed or ``a`` is None.
    The leading axis must already be padded to a multiple of the rank
    count (``padded_cell_count`` / ``pad_shard_cells``)."""
    dm = _default_device_mesh
    if dm is None or a is None:
        return a
    a = torch.as_tensor(a)
    if a.shape[0] % dm.size:
        raise ValueError(f"{a.shape[0]} rows do not split over {dm.size} ranks: pad them "
                         "first (pad_shard_cells)")
    k = a.shape[0] // dm.size
    return a[dm.rank * k:(dm.rank + 1) * k].to(dm.device)


def pad_shard_cells(a, n_pad: int):
    """Pad the leading (cell) axis to ``n_pad`` by repeating row 0 (valid
    geometry and indices, whose contributions the caller masks out), then
    take this rank's block (``shard_cells``).  Identity when no mesh is
    installed."""
    if _default_device_mesh is None or a is None:
        return a
    a = torch.as_tensor(a)
    extra = n_pad - a.shape[0]
    if extra > 0:
        a = torch.cat([a, a[:1].expand((extra,) + tuple(a.shape[1:]))])
    return shard_cells(a)

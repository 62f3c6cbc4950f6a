"""Demo figure output: the port of ``dolfinx_external_operator_tpu/utils/
plots.py``, the matplotlib replacement for the reference's
load-displacement curves (``demo_plasticity_von_mises.py:580-597``) and
pyvista deformed-mesh renders (``demo_plasticity_mohr_coulomb.py:777-802``).

All functions are best-effort: headless Agg backend, and where matplotlib
is missing (the card's machine has none) each returns ``None`` with a
warning; the demos' numerics never depend on plotting.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_load_displacement", "save_displacement_field"]

# colorblind-safe two-series pair (blue/orange) with linestyle + marker as
# the secondary (non-color) encoding
_SERIES = (
    {"color": "#1f77b4", "ls": "-", "marker": "o"},
    {"color": "#ff7f0e", "ls": "--", "marker": "s"},
)


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        import warnings

        warnings.warn("matplotlib unavailable; skipping figure output", stacklevel=3)
        return None


def save_load_displacement(curves, path, xlabel="displacement", ylabel="load",
                           title=None, hline=None, hline_label=None):
    """Overlayed load-displacement curves.

    ``curves``: list of ``(label, results)`` where ``results`` is an
    (n, 2) array of (displacement, load) rows, the shape the plasticity
    solvers record (``models.von_mises.solve_von_mises``)."""
    plt = _mpl()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6.0, 4.2), dpi=130)
    for (label, results), style in zip(curves, _SERIES):
        r = np.asarray(results)
        ax.plot(r[:, 0], r[:, 1], label=label, lw=1.8, ms=4,
                markevery=max(1, len(r) // 20), **style)
    if hline is not None:
        ax.axhline(hline, color="#6b7280", lw=1.0, ls=":")
        if hline_label:
            ax.annotate(hline_label, xy=(0.02, hline), xycoords=("axes fraction", "data"),
                        va="bottom", fontsize=8, color="#6b7280")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title, fontsize=11)
    ax.grid(True, lw=0.4, alpha=0.35)
    ax.legend(frameon=False, fontsize=9)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def save_displacement_field(mesh, u, path, title=None, scale=None):
    """Displacement-magnitude field on the (optionally warped) mesh, the
    pyvista-render replacement.  ``u``: a vector Function on the mesh, a
    tensor or a flat (2 * n_vertices_or_more,) dof array (P1/P2 vertex dofs
    lead, the ``FunctionSpace`` dof order)."""
    plt = _mpl()
    if plt is None:
        return None
    import matplotlib.tri as mtri

    vals = getattr(u, "data", u)
    vals = vals.detach().cpu().numpy() if isinstance(vals, torch.Tensor) else np.asarray(vals)
    nv = mesh.num_vertices
    ux, uy = vals[0: 2 * nv: 2], vals[1: 2 * nv: 2]
    mag = np.hypot(ux, uy)
    if scale is None:
        span = max(np.ptp(mesh.points[:, 0]), np.ptp(mesh.points[:, 1]))
        mmax = mag.max()
        scale = 0.0 if mmax == 0 else 0.1 * span / mmax
    x = mesh.points[:, 0] + scale * ux
    y = mesh.points[:, 1] + scale * uy
    tri = mtri.Triangulation(x, y, mesh.cells[:, :3])
    fig, ax = plt.subplots(figsize=(6.0, 4.6), dpi=130)
    tc = ax.tricontourf(tri, mag, levels=24, cmap="viridis")
    ax.triplot(tri, lw=0.15, color="k", alpha=0.25)
    cb = fig.colorbar(tc, ax=ax, shrink=0.85)
    cb.set_label("|u|")
    ax.set_aspect("equal")
    if title:
        ax.set_title(title, fontsize=11)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path

"""Von Mises cylinder expansion with the PyTorch port.

The twin of ``demos/demo_plasticity_von_mises.py`` (reference
``demo_plasticity_von_mises.py``): the external-operator solve against the
pure-form twin, the machine-checkable ``final_displacement=`` line, and the
load-displacement figure (``demo_plasticity_von_mises.py:580-597``) under
``chiprun_out/figures/`` unless ``--no-plot`` is passed.  ``--ranks N``
runs the whole demo with every form cell-sharded over N gloo ranks
(``parallel.dist.spawn``; the reference CI runs each demo under ``mpirun
-n 2``, the JAX twin takes ``--devices N``).

    python demos_torch/demo_plasticity_von_mises.py [--device cpu] [--small] [--no-plot] [--ranks N]
"""
import os

import numpy as np

from dolfinx_external_operator_torch import parallel
from dolfinx_external_operator_torch.models.von_mises import (
    Q_LIM,
    solve_von_mises,
    solve_von_mises_pure_form,
)
from dolfinx_external_operator_torch.parallel import dist

from _common import check_no_jax, out_dir, parse_args


def solve(num_increments, lc, device, verbose=True):
    """The displacement-load rows of both solves."""
    ext = solve_von_mises(lc=lc, num_increments=num_increments, verbose=verbose, device=device)
    pure = solve_von_mises_pure_form(lc=lc, num_increments=num_increments, device=device)
    return ext["results"], pure["results"]


def solve_rank(mesh, num_increments, lc):
    """One rank of ``--ranks``: both solves with every form sharded."""
    parallel.set_default_device_mesh(mesh)
    return solve(num_increments, lc, mesh.device, verbose=mesh.rank == 0)


def main(num_increments=20, lc=0.3, plot=True, device=None, ranks=0):
    if ranks:
        runs = dist.spawn(solve_rank, ranks, "gloo", device, num_increments, lc)
        ext, pure = runs[0]
        assert all(np.array_equal(r[0], ext) for r in runs), "the ranks' results differ"
    else:
        ext, pure = solve(num_increments, lc, device)
    diff = np.abs(ext[:, 0] - pure[:, 0]).max()
    print(f"collapse load q_lim = {Q_LIM:.3f} MPa")
    print(f"external vs pure-form twin max displacement diff: {diff:.3e}")
    # machine-checkable parity line: tests compare it across rank counts
    print(f"final_displacement={ext[-1, 0]:.17g}")
    assert diff < 1e-9
    if plot:
        from dolfinx_external_operator_torch.utils.plots import save_load_displacement

        out = save_load_displacement(
            [("external operator", ext), ("pure-form twin", pure)],
            os.path.join(out_dir("figures"), "von_mises_load_displacement.png"),
            xlabel="displacement of inner boundary",
            ylabel="q / q_lim",
            title="Von Mises cylinder expansion: external operator vs twin",
            hline=1.0,
            hline_label=f"analytic collapse load q_lim = {Q_LIM:.1f} MPa")
        if out:
            print(f"figure: {out}")
    print("von Mises demo OK")


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0], ranks=True)
    main(num_increments=8 if args.small else 20, plot=args.plot, device=args.device,
         ranks=args.ranks)
    check_no_jax()

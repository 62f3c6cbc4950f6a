"""Mohr-Coulomb slope stability with the PyTorch port.

The twin of ``demos/demo_plasticity_mohr_coulomb.py`` (reference
``demo_plasticity_mohr_coulomb.py``).  Full size: Nx=Ny=25, 52 load steps
to the collapse plateau; slope stability factor ~ 6.69 (Chen 1990), the
return map K1 on the card.  ``--small``: 8x8 over 10 loads.  The figures
(the load-displacement curve with the analytic limit, ``:751-764``; the
displacement field replacing the pyvista view, ``:777-802``) go under
``chiprun_out/figures/`` unless ``--no-plot`` is passed.

    python demos_torch/demo_plasticity_mohr_coulomb.py [--device cpu] [--small] [--no-plot]
"""
import os

import numpy as np

from dolfinx_external_operator_torch.models.mohr_coulomb import solve_slope_stability

from _common import check_no_jax, out_dir, parse_args


def main(small=False, plot=True, device=None):
    # K1 on the card; the plain f64 return map on the CPU
    route = "plain" if device == "cpu" else "cuda"
    if small:
        out = solve_slope_stability(Nx=8, Ny=8, load_steps=np.linspace(2, 20, 10), verbose=True,
                                    device=device, route=route)
    else:
        out = solve_slope_stability(Nx=25, Ny=25, verbose=True, verbose_inner=True,
                                    device=device, route=route)
    print(f"slope stability factor: {out['slope_factor']:.3f} (analytic ~ 6.69)")
    print(f"newton iterations per step: {out['iterations']}")
    if plot:
        from dolfinx_external_operator_torch.utils.plots import (
            save_displacement_field,
            save_load_displacement,
        )

        figs = out_dir("figures")
        f1 = save_load_displacement(
            [("slope crest", out["results"])],
            os.path.join(figs, "mohr_coulomb_load_displacement.png"),
            xlabel="crest horizontal displacement (-u_x)",
            ylabel="soil self-weight gamma",
            title="Mohr-Coulomb slope stability",
            hline=6.69 * out["material"].c / out["H"],
            hline_label="limit analysis: gamma_lim = 6.69 c/H (Chen 1990)")
        f2 = save_displacement_field(
            out["mesh"], out["u"], os.path.join(figs, "mohr_coulomb_displacement_field.png"),
            title="Slope displacement magnitude at collapse (warped x10%)")
        for f in (f1, f2):
            if f:
                print(f"figure: {f}")
    print("Mohr-Coulomb demo OK")


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0])
    main(small=args.small, plot=args.plot, device=args.device)
    check_no_jax()

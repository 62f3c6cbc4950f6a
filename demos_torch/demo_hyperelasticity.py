"""ICNN hyperelasticity with the PyTorch port.

The twin of ``demos/demo_hyperelasticity.py`` (reference
``demo_hyperelasticity.py``): the pretrained input-convex network's energy
as the constitutive law, verified against the analytic Isihara model.
``--small``: a coarse quick run; the default is the reference-scale
configuration (lc=0.05, 100 displacement steps to 0.5,
``doc/demo/demo_hyperelasticity.py:806-820``), which writes its error
metrics and timings to ``chiprun_out/records/`` and, unless ``--no-plot``
is passed, a displacement-field figure to ``chiprun_out/figures/``.

    python demos_torch/demo_hyperelasticity.py [--device cpu] [--small] [--no-plot]
"""
import json
import os
import time

import torch

from dolfinx_external_operator_torch.models.hyperelasticity import run_comparison

from _common import check_no_jax, out_dir, parse_args


def main(small=False, plot=True, device=None):
    t0 = time.perf_counter()
    if small:
        out = run_comparison(lc=0.12, n_steps=5, max_displacement=0.25, verbose=True,
                             device=device)
    else:
        out = run_comparison(lc=0.05, n_steps=100, max_displacement=0.5, verbose=True,
                             device=device)
    wall = time.perf_counter() - t0
    nn_its = out["nn"]["iterations"]
    tw_its = out["isihara"]["iterations"]
    print(f"relative L-inf displacement error (NN vs Isihara): {out['rel_linf']:.3e}")
    print(f"absolute L2 displacement error: {out['l2']:.3e}")
    print(f"steps: {len(nn_its)}; newton its (NN): total {sum(nn_its)}, "
          f"max {max(nn_its)}; (Isihara): total {sum(tw_its)}")
    print(f"wall: {wall:.1f}s ({wall / max(len(nn_its), 1):.2f} s/step for both solves)")
    if not small:
        dev = out["nn"]["u"].device
        rec = {
            "config": {"lc": 0.05, "n_steps": 100, "max_displacement": 0.5,
                       "dofs": int(out["nn"]["V"].num_dofs)},
            "rel_linf": out["rel_linf"],
            "l2": out["l2"],
            "newton_total_nn": int(sum(nn_its)),
            "newton_total_isihara": int(sum(tw_its)),
            "wall_s_both_solves": round(wall, 1),
            "per_step_s_both_solves": round(wall / len(nn_its), 3),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        }
        path = os.path.join(out_dir("records"), "hyperelasticity_lc005_100steps.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"record: {path}")
    if plot:
        from dolfinx_external_operator_torch.utils.plots import save_displacement_field

        fig = save_displacement_field(
            out["nn"]["mesh"], out["nn"]["u"],
            os.path.join(out_dir("figures"), "hyperelasticity_displacement_field.png"),
            title="ICNN hyperelasticity: displacement magnitude", scale=1.0)
        if fig:
            print(f"figure: {fig}")
    print("hyperelasticity demo OK")


if __name__ == "__main__":
    args = parse_args(__doc__.splitlines()[0])
    main(small=args.small, plot=args.plot, device=args.device)
    check_no_jax()

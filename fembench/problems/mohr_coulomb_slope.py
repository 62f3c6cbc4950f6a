"""The Mohr-Coulomb slope of the upstream stability demo, as the harness
judges it: what the seed makes of a configuration, and the plain reference
(``fembench.reference``) that decides ``correct``.

* ``draw``: the cohesion factor ``1 + spread u`` (``harness.traffic``),
  handed to the entry, which scales the program's cohesion by it;
* ``judge_steps``: the kept load steps against the reference's own slope
  and return map in f64 (``reference.judge``);
* ``judge_points``: batches of the return map alone, point by point;
* ``counts``: the reference's dof count and the lattice's BCR blocks, for
  the per-layer metrics;
* ``control_steps``, ``control_points``: the reference in the program's
  place in a lower precision (``tools/control.py``).

The kept state dicts are the entries' own: ``load``, ``sigma_n``, ``Du``,
``sigma``."""

from __future__ import annotations

import torch

from fembench.counts.bcr import lattice_blocks
from fembench.harness.traffic import cohesion_factor
from fembench.reference.judge import judge_points, judge_steps
from fembench.reference.mohr_coulomb import Material, return_map
from fembench.reference.slope import Slope


class Problem:
    def __init__(self, config, seed):
        self.config = config
        self.draw = cohesion_factor(seed, config["seed"]["cohesion_spread"])
        self.material = Material.from_config(config["material"], self.draw)
        self._slope = None

    @property
    def slope(self):
        """The reference's slope, built at first use: after the window."""
        if self._slope is None:
            m = self.config["mesh"]
            self._slope = Slope(m["Nx"], m["Ny"], m["L"], m["H"])
        return self._slope

    def judge_steps(self, kept, device):
        return judge_steps(self.slope, self.slope.on(device, torch.float64), self.material, kept)

    def judge_points(self, batches):
        return judge_points(self.material, batches)

    def counts(self):
        m = self.config["mesh"]
        return {"n_dofs_reference": self.slope.n_dofs,
                "bcr_blocks": lattice_blocks(m["Nx"], m["Ny"])}

    def control_steps(self, kept, device, dtype):
        """Each kept step solved by the reference alone in ``dtype``, from
        the stress and the first guess the step was handed."""
        from fembench.reference.solve import solve_step  # SciPy's sparse LU: not in a run

        arrays = self.slope.on(device, dtype)
        out = []
        for s in kept:
            Du, sig = solve_step(self.slope, arrays, self.material, s["sigma_n"], s["Du_in"],
                                 s["load"], dtype, atol=self.config["newton"]["atol"])
            out.append({"load": s["load"], "sigma_n": s["sigma_n"], "Du": Du, "sigma": sig})
        return out

    def control_points(self, batches, dtype):
        """Each batch's stress and tangent from the reference's return map
        in ``dtype``."""
        out = []
        for b in batches:
            sig, C, *_ = return_map(self.material, b["deps"], b["sigma_n"], dtype=dtype)
            out.append(dict(b, sigma=sig, tangent=C))
        return out

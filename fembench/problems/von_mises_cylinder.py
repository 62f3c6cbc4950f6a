"""The thick cylinder of the upstream von Mises demo, as the harness judges
it: what the seed makes of a configuration, and the plain reference
(``fembench.reference``: ``cylinder``, ``von_mises``, ``cylinder_judge``)
that decides ``correct``.

* ``draw``: the yield-stress factor ``1 + spread u`` (``harness.traffic``'s
  draw, as the slope's cohesion factor), handed to the entry, which scales
  the program's ``sigma_0`` by it; the pressures are fractions of the
  limit pressure of that ``sigma_0``.  The configuration's spread is
  1e-15 (its note says why): the seed moves ``sigma_0`` by a few ulps at
  most, and picks the steps judged;
* ``judge_steps``: the kept load steps against the reference's own annulus
  and J2 return map in f64 (``reference.cylinder_judge``);
* ``judge_points``: none; the cylinder has no return-map cell;
* ``counts``: the reference's dof and Gauss-point counts, for the per-layer
  metrics;
* ``control_steps``: the reference in the program's place in a lower
  precision (``tools/control.py``; ``reference.cylinder_solve``).

The kept state dicts are the entry's: ``load``, ``sigma_n``, ``p``,
``Du_in``, ``Du``, ``sigma``, ``serial``."""

from __future__ import annotations

import torch

from fembench.harness.traffic import cohesion_factor
from fembench.reference.cylinder import Cylinder
from fembench.reference.cylinder_judge import judge_steps
from fembench.reference.von_mises import Material


class Problem:
    def __init__(self, config, seed):
        self.config = config
        self.draw = cohesion_factor(seed, config["seed"]["yield_spread"])
        self.material = Material.from_config(config["material"], self.draw)
        self._cylinder = None

    @property
    def cylinder(self):
        """The reference's annulus, built at first use: after the window."""
        if self._cylinder is None:
            self._cylinder = Cylinder.from_config(self.config["mesh"])
        return self._cylinder

    def judge_steps(self, kept, device):
        return judge_steps(self.cylinder, self.cylinder.on(device, torch.float64),
                           self.material, kept)

    def judge_points(self, batches):
        raise NotImplementedError("the thick cylinder has no return-map cell")

    def counts(self):
        return {"n_dofs_reference": self.cylinder.n_dofs,
                "gauss_points_reference": self.cylinder.n_points}

    def control_steps(self, kept, device, dtype):
        """Each kept step solved by the reference alone in ``dtype``, from
        the stress, hardening variable and first guess it was handed."""
        from fembench.reference.cylinder_solve import solve_step  # SciPy: not in a run

        arrays = self.cylinder.on(device, dtype)
        out = []
        for s in kept:
            Du, sig = solve_step(self.cylinder, arrays, self.material, s["sigma_n"], s["p"],
                                 s["Du_in"], s["load"], dtype,
                                 atol=self.config["newton"]["atol"])
            out.append({"load": s["load"], "sigma_n": s["sigma_n"], "p": s["p"], "Du": Du,
                        "sigma": sig, "serial": s.get("serial")})
        return out

    def control_points(self, batches, dtype):
        raise NotImplementedError("the thick cylinder has no return-map cell")

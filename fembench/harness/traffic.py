"""The one generator of every traffic mix: what a mix's parameters and the
run's seed make.  The program gets only what this makes.

* ``cohesion_factor``: the configuration's cohesion times ``1 + spread u``,
  ``u`` in [0, 1) drawn from the seed (0 for seed 0, so seed 0 runs the
  configuration as published).  Only increases are drawn: the published
  schedule ends just below the collapse load.
* ``sample_priorities``: one draw per completed load step, from the seed;
  the steps with the highest draws are the ones judged.
* ``strain_pool``: ``batches`` batches of ``points`` strain increments
  (4, points) on the device, from a ``torch.Generator`` seeded with the
  seed, in one call: ``normal(0, scale)`` plus ``offset`` on the three
  normal components, and ``shear`` added to the shear component of the
  first ``shear_share`` of each batch's points (``bench.py:77-83``, copied
  from ``chip_smoke.py:817-827``, ``bench_mix``); zero previous stresses.
"""

from __future__ import annotations

import numpy as np
import torch


def cohesion_factor(seed, spread):
    u = 0.0 if seed == 0 else float(np.random.default_rng(seed).random())
    return 1.0 + spread * u


def sample_priorities(seed):
    """An endless stream of draws in [0, 1), one per completed step."""
    rng = np.random.default_rng([seed, 1])
    while True:
        yield from rng.random(1024)


def strain_pool(mix, points, seed, device):
    """``(deps, sigma_n)``: two (batches, 4, points) f64 tensors."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nb = int(mix["batches"])
    deps = torch.randn((nb, 4, points), generator=gen, dtype=torch.float64, device=device)
    deps.mul_(mix["scale"])
    deps[:, :3].add_(mix["offset"])
    deps[:, 3, :int(points * mix["shear_share"])].add_(mix["shear"])
    return deps, torch.zeros_like(deps)

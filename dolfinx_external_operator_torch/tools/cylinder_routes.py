"""The von Mises cylinder's AMG-CG Newton list with the element-blocked
matvec as E4 and as the plain products it replaced, on one device:

    python3 -m dolfinx_external_operator_torch.tools.cylinder_routes [--device cpu]
        [--lc 0.3] [--out chiprun_out/cylinder_routes.json]

Three readings of ``models.von_mises.solve_von_mises(lc, 20)`` with
``{"ksp_type": "cg", "pc_type": "mg"}``, in one process:

* ``kernels``: as the package runs it, E4 (``ops.element_chain.
  ebe_cell_matvec``) in the AMG plan's element-blocked matvec
  (``parallel/mg.py::ebe_matvec``) and in ``CompiledForm.action``;
* ``plain_mg``: the AMG plan's matvec through E4's plain version
  (``ebe_cell_matvec_reference``: pad, gather, ``torch.bmm``), the action
  through E4;
* ``plain``: both as they were before E4, the AMG plan's through
  ``torch.bmm`` and the action through ``torch.einsum("cij,cj->ci")``.

On the CPU every wrapper runs its plain version, so the readings differ
there only by the action's ``bmm`` against its ``einsum``.  Each reading
prints one JSON line (the Newton updates of each step, their total, the
inner iterations and the largest gap of the probe displacement to the
first reading); all of them go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .. import assembly
from ..models import von_mises as vmm
from ..ops import element_chain as ec
from ..parallel import mg

MG_OPTS = {"ksp_type": "cg", "pc_type": "mg"}


class _Route:
    """``ops.element_chain`` with E4 replaced by ``matvec``."""

    def __init__(self, matvec):
        self.ebe_cell_matvec = matvec

    def __getattr__(self, name):
        return getattr(ec, name)


def _einsum_matvec(K, idx, x, bs):
    """``CompiledForm.action``'s per-cell product before E4."""
    if bs != 1:
        raise ValueError("the action gathers per dof")
    return torch.einsum("cij,cj->ci", K, x[idx])


def routes():
    """{reading: (the ``ec`` that ``parallel.mg`` sees, the one that
    ``assembly`` sees)}."""
    plain = _Route(ec.ebe_cell_matvec_reference)
    return {"kernels": (ec, ec), "plain_mg": (plain, ec),
            "plain": (plain, _Route(_einsum_matvec))}


def run(reading, lc, device):
    """The cylinder with AMG-CG under ``reading``, the modules restored
    after it."""
    saved = mg.ec, assembly.ec
    mg.ec, assembly.ec = routes()[reading]
    try:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = vmm.solve_von_mises(lc=lc, num_increments=20, snes_opts=MG_OPTS, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        return res
    finally:
        mg.ec, assembly.ec = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--lc", type=float, default=0.3)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "cylinder_routes.json"))
    args = ap.parse_args()
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("cylinder_routes: no CUDA device available", file=sys.stderr)
        return 1
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    else:
        card = "cpu"
    rep = {"device": card, "torch": torch.__version__, "cuda": torch.version.cuda, "lc": args.lc}
    print(json.dumps(rep), flush=True)
    vmm.solve_von_mises(lc=0.5, num_increments=2, snes_opts=MG_OPTS, device=dev)  # first calls
    first = None
    for reading in routes():
        res = run(reading, args.lc, dev)
        probe = np.asarray(res["results"])[:, 0]
        first = probe if first is None else first
        rep[reading] = {"iterations": [int(i) for i in res["iterations"]],
                        "newton_total": int(sum(res["iterations"])),
                        "inner_total": int(sum(res["ksp_iterations"])),
                        "probe_gap_to_kernels": float(np.abs(probe - first).max()),
                        "wall_s": res["wall_s"]}
        print(json.dumps({reading: rep[reading]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The 25x25 slope's 52-step schedule with each fused solver, for holding
two versions of the package to the same bits on one card:

    python3 -m dolfinx_external_operator_torch.tools.schedule_bits [--device cpu]
    PYTHONPATH=DIR python3 dolfinx_external_operator_torch/tools/schedule_bits.py

The second form runs this file against the version of the package in
``DIR``, which holds it with the top-level ``csrc/`` beside it (``git
archive <commit> dolfinx_external_operator_torch csrc`` unpacked into a
directory that ``.gitignore`` lists; without ``csrc/`` the mesh topology
falls back to another numbering and every fingerprint moves).

For ``dense``, ``bcr``, ``mg`` and the three again in the same process:
one JSON line with the Newton updates, the inner iterations (BCR's
refinement rounds, AMG-CG's PCG iterations) and a fingerprint of the
last step's Du (the first 12 hex digits of its bytes' SHA-256).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

from dolfinx_external_operator_torch import problems

SOLVERS = ("dense", "bcr", "mg", "dense", "bcr", "mg")


def fingerprint(Du):
    """The first 12 hex digits of the SHA-256 of Du's bytes."""
    return hashlib.sha256(Du.cpu().numpy().tobytes()).hexdigest()[:12]


def schedule(solver, device):
    """(Newton updates, inner iterations, Du's fingerprint) of the
    schedule from the zero state, after one warm-up step."""
    fp = problems.mohr_coulomb_slope_step(
        25, 25, device=device, linear_solver=solver,
        route="cuda" if device.type == "cuda" else "plain")
    Du, sig = fp.zero_state()
    fp.run_step(Du, sig, float(problems.SLOPE_LOADS[0]))
    Du, sig = fp.zero_state()
    its = inner = 0
    for load in problems.SLOPE_LOADS:
        Du, sig, _, it, cg = fp.run_step(Du, sig, float(load))
        its, inner = its + it, inner + abs(cg)
    return its, inner, fingerprint(Du)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("schedule_bits: no CUDA device available", file=sys.stderr)
        return 1
    print(json.dumps({"package": problems.__file__,
                      "device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}),
          flush=True)
    for solver in SOLVERS:
        its, inner, du = schedule(solver, dev)
        print(json.dumps({"solver": solver, "newton": its, "inner": inner, "du": du}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

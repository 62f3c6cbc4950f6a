"""The element chain's E2 and E3 kernels of this checkout against another
checkout's, on one NVIDIA GPU, each built from its own sources:

    python3 -m dolfinx_external_operator_torch.tools.ec_compare OTHER [--out FILE]

``OTHER`` is a directory that holds ``dolfinx_external_operator_torch/csrc``
of the other commit, for example from ``git archive <commit>
dolfinx_external_operator_torch/csrc | tar -x -C OTHER``.  The two
launchers (``ec_residual_launch``, ``ec_tangent_launch``) must have this
checkout's interface, read from each source; another is refused, never
called.

The inputs are those of ``chip_smoke.py``'s phase 25: the 25x25 slope's
step 50 iterate (the dense schedule with K1 over the first 49 loads), its
tangent C and stress sigma as the return map hands them (views, the
points fastest), the masked x of the refinement matvec.  For E2 and each
mode of E3 (the matvec, the diagonal, the masked f64 blocks, the f32
blocks): whether the two kernels give the same bits, and each one's
device time in a CUDA graph, timed in turns (other, this, this, other).
One JSON line per product; all of them go to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

from .. import problems
from .._native import cuda as native
from ..ops import element_chain as ec
from .k1_compare import graph_time_ms

LAUNCHERS = {"cell_residual": "ec_residual_launch", "cell_tangent": "ec_tangent_launch"}


def _interface(csrc, fn):
    with open(os.path.join(csrc, "element_chain.cu")) as f:
        m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', f.read())
    if m is None:
        raise RuntimeError(f"no {fn} in {csrc}")
    return [" ".join(p.split()) for p in m.group(1).split(",")]


def build(csrc, tag):
    """{wrapper name: launcher} of ``csrc/element_chain.cu``, built with
    this checkout's flags."""
    for fn in LAUNCHERS.values():
        if _interface(csrc, fn) != _interface(native.CSRC_DIR, fn):
            raise RuntimeError(f"{fn} in {csrc} has another interface than this checkout's")
    digest = hashlib.sha256(" ".join(native.NVCC_FLAGS).encode())
    for name in ("element_chain.cu", "element_chain.cuh"):
        with open(os.path.join(csrc, name), "rb") as f:
            digest.update(f.read())
    path = os.path.join(native.BUILD_DIR, f"lib{tag}_{digest.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(native.BUILD_DIR, exist_ok=True)
        cmd = [native.find_nvcc(), *native.NVCC_FLAGS, "-o", path,
               os.path.join(csrc, "element_chain.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"build failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    return {name: native._bind(path, fn, native.KERNELS[name][2], native._INT)
            for name, fn in LAUNCHERS.items()}


def cases():
    """{product: (wrapper name, its argument builder)} at step 50's
    iterate: each builder allocates an output and returns it with the
    launcher's arguments (stream last)."""
    fp = problems.mohr_coulomb_slope_step(25, 25, route="cuda")
    Du, sig = fp.zero_state()
    for load in problems.SLOPE_LOADS[:49]:
        Du, sig, *_ = fp.run_step(Du, sig, load)
    C, sigma = fp._constitutive(Du, sig)
    st = fp.statics
    B, w, dof, keep = st["B"], st["wdet"], st["dofmap"], fp._keep_cell
    x = torch.where(st["bc_mask"], 0.0, Du)
    f32 = torch.float32
    return {
        "residual": ("cell_residual", lambda: ec._residual_args(B, sigma, w)),
        "matvec": ("cell_tangent", lambda: ec._tangent_args("matvec", B, C, w, dof, x, None,
                                                              torch.float64)),
        "diag": ("cell_tangent", lambda: ec._tangent_args("diag", B, C, w, None, None, None,
                                                            torch.float64)),
        "blocks_f64_masked": ("cell_tangent", lambda: ec._tangent_args(
            "blocks", B, C, w, None, None, keep, torch.float64)),
        "blocks_f32": ("cell_tangent", lambda: ec._tangent_args("blocks", B, C, w, None, None,
                                                                  None, f32)),
    }


def compare(kernels, name, args_of, reps):
    outs, args = {}, {}
    for who in kernels:
        outs[who], args[who] = args_of()

    def call(who):
        # the current stream: a graph's capture runs on a stream of its own
        err = kernels[who][name](*args[who], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{who} {name} launch failed: cudaError {err}")

    for who in kernels:
        call(who)
    torch.cuda.synchronize()
    row = {"bitwise_equal": torch.equal(outs["this"], outs["other"]),
           "max_abs_gap": float((outs["this"] - outs["other"]).abs().max())}
    row["graph_ms_in_turns"] = [[who, graph_time_ms(lambda who=who: call(who), reps)]
                                for who in ("other", "this", "this", "other")]
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="a directory holding the other commit's "
                                  "dolfinx_external_operator_torch/csrc")
    ap.add_argument("--reps", type=int, default=200, help="calls in a timed graph")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ec_compare.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ec_compare: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    other = os.path.join(args.other, "dolfinx_external_operator_torch", "csrc")
    kernels = {"other": build(other, "ec_other"),
               "this": {name: native.cuda_function(name) for name in LAUNCHERS}}
    rows = {}
    for product, (name, args_of) in cases().items():
        rows[product] = compare(kernels, name, args_of, args.reps)
        print(json.dumps({"product": product, **rows[product]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "other": args.other, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

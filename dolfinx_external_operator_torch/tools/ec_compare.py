"""The element chain's E2, E3 and E5 kernels of this checkout against
another checkout's, on one NVIDIA GPU, each built from its own sources:

    python3 -m dolfinx_external_operator_torch.tools.ec_compare OTHER [--out FILE]

``OTHER`` is a directory that holds ``dolfinx_external_operator_torch/csrc``
of the other commit, for example from ``git archive <commit>
dolfinx_external_operator_torch/csrc | tar -x -C OTHER``.  The launchers
of E2, E3 and E5's product (``ec_residual_launch``, ``ec_tangent_launch``,
``ec_product_launch``) must have this checkout's interface, read from each
source.  E5's one-launch entries (``ec_triple_launch``,
``ec_values_grads_launch``) must have it too where the other source has
them; where it has not, the other side runs what they replace, two
``ec_product_launch`` calls (the level-1 triple's ``W^T K`` then ``T W``;
the pair's values then gradients).  A launcher of another interface is
refused, never called.

The inputs are those of ``chip_smoke.py``'s phase 25: the 25x25 slope's
step 50 iterate (the dense schedule with K1 over the first 49 loads), its
tangent C and stress sigma as the return map hands them (views, the
points fastest), the masked x of the refinement matvec; for E5 the
level-1 triple on the 25x25 AMG plan's weights W against the masked f32
blocks at that iterate, and the operand evaluation of the 25x25 general
slope (``operand_inputs``).  For E2, each mode of E3 (the matvec, the
diagonal, the masked f64 blocks, the f32 blocks), the triple, the four
operand products and the values-and-gradients pair: whether the two
sides give the same bits, and each one's device time in a CUDA graph,
timed in turns (other, this, this, other).  One JSON line per product;
all of them go to ``--out``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import problems
from .._native import cuda as native
from ..ops import element_chain as ec
from .k1_compare import graph_time_ms

# wrapper name -> launcher: the ones another checkout must have, and E5's
# one-launch entries, which an older one may lack
LAUNCHERS = {"cell_residual": "ec_residual_launch", "cell_tangent": "ec_tangent_launch",
             "cell_product": "ec_product_launch"}
ONE_LAUNCH = {"cell_triple": "ec_triple_launch", "cell_values_grads": "ec_values_grads_launch"}


def _interface(csrc, fn):
    """The launcher's parameter list, or None where the source has none."""
    with open(os.path.join(csrc, "element_chain.cu")) as f:
        m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', f.read())
    return None if m is None else [" ".join(p.split()) for p in m.group(1).split(",")]


def build(csrc, tag):
    """{wrapper name: launcher} of ``csrc/element_chain.cu``, built with
    this checkout's flags; E5's one-launch entries only where it has
    them."""
    names = {}
    for name, fn in {**LAUNCHERS, **ONE_LAUNCH}.items():
        theirs = _interface(csrc, fn)
        if theirs is None and name in ONE_LAUNCH:
            continue
        if theirs is None:
            raise RuntimeError(f"no {fn} in {csrc}")
        if theirs != _interface(native.CSRC_DIR, fn):
            raise RuntimeError(f"{fn} in {csrc} has another interface than this checkout's")
        names[name] = fn
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
            for name, fn in names.items()}


def operand_inputs(n, seed=25, device="cuda"):
    """The general pipeline's operand evaluation on the n x n slope of
    ``build_slope_problem`` (the strain of a seeded Du), by E5 product:
    {mode: (einsum, x, y)} as ``assembly`` and ``compile`` call them on
    every cell (the geometry J, the physical gradients, the values and
    the gradients at the points)."""
    from ..assembly import _t
    from ..compile import CellBatch, coefficient_inputs
    from ..expression import Expression
    from ..models.mohr_coulomb import build_slope_problem

    dev, f64 = torch.device(device), torch.float64
    P = build_slope_problem(n, n, device=dev, route="cuda" if dev.type == "cuda" else "plain")
    P["Du"].x.array[:] = 1e-3 * np.random.default_rng(seed).standard_normal(P["V"].num_dofs)
    (op,) = P["F_ops"]
    expr = Expression(op.ufl_operands[0], op.eval_points, dtype=f64, device=dev)
    batch = CellBatch(P["mesh"], expr.points)
    ((f, kind, (phi, dphi, _)),) = coefficient_inputs(expr.info, batch)
    if kind != "tab":
        raise RuntimeError(f"the operand's coefficient is read as {kind!r}")
    coords, dphi_g = _t(batch.coords, f64, dev), _t(batch.dphi_g, f64, dev)
    J = torch.einsum("qvd,cvg->cqgd", dphi_g, coords)
    Jinv = torch.linalg.inv(J)
    phi, dphi = _t(phi, f64, dev), _t(dphi, f64, dev)
    gp = torch.einsum("qbd,cqdg->cqbg", dphi, Jinv)
    bs = f.function_space.bs
    dofs = torch.as_tensor(f.function_space.unrolled_dofmap[batch.cells], device=dev)
    d2 = f.data.to(f64)[dofs].reshape(dofs.shape[0], -1, bs)
    return {"geometry": ("qvd,cvg->cqgd", dphi_g, coords),
            "gphys": ("qbd,cqdg->cqbg", dphi, Jinv),
            "values": (ec.VALUES_EQ, phi, d2), "grads": (ec.GRADS_EQ, gp, d2)}


def _launches(lib, calls):
    """A function that issues ``calls`` ([(wrapper name, arguments)]) on
    the current stream (a graph's capture runs on a stream of its own);
    its ``launches`` is their count."""
    def run():
        for name, args in calls:
            err = lib[name](*args, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed: cudaError {err}")
    run.launches = len(calls)
    return run


def _single(name, args_of):
    """A product of one launcher: prepare(lib) -> (outputs, run)."""
    def prepare(lib):
        out, args = args_of()
        return (out,), _launches(lib, [(name, args)])
    return prepare


def _triple(W, K):
    def prepare(lib):
        if "cell_triple" in lib:
            out, args = ec._triple_args(W, K)
            return (out,), _launches(lib, [("cell_triple", args)])
        T, a1 = ec._product_args("cia,cij->caj", W, K)
        out, a2 = ec._product_args("caj,cjb->cab", T, W)
        return (out,), _launches(lib, [("cell_product", a1), ("cell_product", a2)])
    return prepare


def _pair(phi, gp, d2):
    def prepare(lib):
        if "cell_values_grads" in lib:
            out, args = ec._pair_args(phi, gp, d2)
            return out, _launches(lib, [("cell_values_grads", args)])
        val, a1 = ec._product_args(ec.VALUES_EQ, phi, d2)
        grad, a2 = ec._product_args(ec.GRADS_EQ, gp, d2)
        return (val, grad), _launches(lib, [("cell_product", a1), ("cell_product", a2)])
    return prepare


def cases():
    """{product: prepare(lib) -> (its outputs, a function that launches
    it through the launchers ``lib``)} at step 50's iterate (E2, E3, the
    triple) and on the general slope's operand (E5's products)."""
    fp = problems.mohr_coulomb_slope_step(25, 25, route="cuda")
    Du, sig = fp.zero_state()
    for load in problems.SLOPE_LOADS[:49]:
        Du, sig, *_ = fp.run_step(Du, sig, load)
    C, sigma = fp._constitutive(Du, sig)
    st = fp.statics
    B, w, dof, keep = st["B"], st["wdet"], st["dofmap"], fp._keep_cell
    x = torch.where(st["bc_mask"], 0.0, Du)
    f32 = torch.float32
    W = problems.mohr_coulomb_slope_step(25, 25, route="cuda",
                                         linear_solver="mg")._mg["transfers"][0]["W"]
    # contiguous, as mg_setup gets the blocks (E3's output)
    K32 = ec.cell_tangent_reference("blocks", B, C, w, keep=keep).to(f32).contiguous()
    out = {
        "residual": _single("cell_residual", lambda: ec._residual_args(B, sigma, w)),
        "matvec": _single("cell_tangent", lambda: ec._tangent_args(
            "matvec", B, C, w, dof, x, None, torch.float64)),
        "diag": _single("cell_tangent", lambda: ec._tangent_args(
            "diag", B, C, w, None, None, None, torch.float64)),
        "blocks_f64_masked": _single("cell_tangent", lambda: ec._tangent_args(
            "blocks", B, C, w, None, None, keep, torch.float64)),
        "blocks_f32": _single("cell_tangent", lambda: ec._tangent_args(
            "blocks", B, C, w, None, None, None, f32)),
        "triple_f32": _triple(W, K32),
    }
    operand = operand_inputs(25)
    for mode, (eq, a, b) in operand.items():
        out[f"operand_{mode}"] = _single("cell_product",
                                         lambda eq=eq, a=a, b=b: ec._product_args(eq, a, b))
    out["operand_values_grads"] = _pair(operand["values"][1], operand["grads"][1],
                                        operand["values"][2])
    return out


def compare(kernels, prepare, reps):
    outs, runs = {}, {}
    for who, lib in kernels.items():
        outs[who], runs[who] = prepare(lib)
    for who in kernels:
        runs[who]()
    torch.cuda.synchronize()
    row = {"bitwise_equal": all(torch.equal(a, b) for a, b in zip(outs["this"], outs["other"])),
           "max_abs_gap": max(float((a - b).abs().max())
                              for a, b in zip(outs["this"], outs["other"]))}
    row["launches"] = {who: runs[who].launches for who in kernels}
    row["graph_ms_in_turns"] = [[who, graph_time_ms(runs[who], reps)]
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
               "this": {name: native.cuda_function(name) for name in {**LAUNCHERS, **ONE_LAUNCH}}}
    rows = {}
    for product, prepare in cases().items():
        rows[product] = compare(kernels, prepare, args.reps)
        print(json.dumps({"product": product, **rows[product]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "other": args.other, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

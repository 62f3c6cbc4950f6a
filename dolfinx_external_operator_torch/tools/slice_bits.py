"""Which per-cell products give other bits on a rank's slice of the cells
than on the whole batch:

    python3 -m dolfinx_external_operator_torch.tools.slice_bits [--device cpu]
        [--out chiprun_out/slice_bits.json]

The sharded step's sums are order-free (``parallel.dist.cell_sum``), so a
rank gives the unsharded bits wherever its per-cell products give the
whole batch's.  For the slope step with AMG-CG (8x8 in the dia and node
level-0 layouts, 25x25 in dia), two load steps in, each product of the
element chain is computed as the step computes it (``ops/element_chain.py``:
the hand kernels E1-E5 on the card, the plain versions on the CPU) on the
cells of each rank of 2 and of 3 and compared bit for bit with the same
cells' rows of the whole batch: the strain (E1), the residual (E2), the
tangent matvec, diagonal and element blocks in f64 and f32 (E3), the
level-1 triple product (E5 twice, ``mg_setup``'s ``cell_triple``), the
element-blocked matvec in f64 and f32 (E4, node layout), and the return
map (K1 on the card).

For the general pipeline's slope (``models.mohr_coulomb.build_slope_
problem``, 8x8 and 25x25, a seeded displacement), the operand
evaluation (``Expression.eval`` on a rank's cells: the geometry, the
physical gradients and ``assembly._coeff_values_at_qps``, E5), the
Jacobian's action (``CompiledForm.action``'s per-cell product, E4) and
the element-by-element Krylov operator's (``solvers._ebe_operator``, E4
on x zero at the BC dofs) are compared the same way.  On the CPU the
plain einsums run, and a slice's operand can differ in the last bit.

One JSON line per case, ``true`` where every rank's slice gives the
whole batch's bits; all of them go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import problems
from ..ops import element_chain as ec

LOADS = (2.0, 6.0)
CASES = ((8, "dia"), (8, "node"), (25, "dia"))
GENERAL_SIZES = (8, 25)


def products(fp, Du, sig, C):
    """name -> f(cells): the product on the contiguous cells ``cells`` (a
    slice), as the rank that owns them computes it."""
    st, plan, f32 = fp.statics, fp._mg, torch.float32
    x = torch.cos(torch.arange(fp.n_dofs, dtype=torch.float64, device=fp.device))

    def rows(t, cells):
        return t[cells].contiguous()

    def strain(cells):
        return ec.cell_strain(rows(st["B"], cells), rows(st["dofmap"], cells), Du)

    def residual(cells):
        return ec.cell_residual(rows(st["B"], cells), sig[cells], rows(st["wdet"], cells))

    def tangent(mode, **kw):
        def f(cells):
            if "keep" in kw:
                kw["keep"] = rows(fp._keep_cell, cells)
            if mode == "matvec":
                kw.update(dofmap=rows(st["dofmap"], cells), x=x)
            return ec.cell_tangent(mode, rows(st["B"], cells), C[cells], rows(st["wdet"], cells),
                                   **kw)
        return f

    def triple(cells):
        W = rows(plan["transfers"][0]["W"], cells)
        return ec.cell_triple(W, tangent("blocks", keep=None)(cells).to(f32))

    def ebe(dtype):
        def f(cells):
            K = tangent("blocks", keep=None)(cells).to(dtype)
            idx, bs = rows(plan["ebe"]["idx"], cells), 2 if plan["ebe"]["mode"] == "node" else 1
            return ec.ebe_cell_matvec(K, idx, x.to(dtype), bs)
        return f

    def return_map(cells):
        C_t, s_t = fp._vkernel(strain(cells).reshape(-1, 4).T, sig[cells].reshape(-1, 4).T)
        return torch.cat([C_t.reshape(16, -1), s_t.reshape(4, -1)])

    return {"strain": strain, "residual": residual, "tangent_matvec": tangent("matvec"),
            "tangent_diag": tangent("diag"), "blocks_f64": tangent("blocks", keep=None),
            "blocks_f32": tangent("blocks", dtype=f32), "level1_triple": triple,
            "ebe_f64": ebe(torch.float64), "ebe_f32": ebe(f32), "return_map": return_map}


def _compare(fns, nc, nq=None, ranks=(2, 3)):
    """{name: {rank count: every rank's slice of ``nc`` cells bitwise the
    whole's}}; a product named ``return_map`` is laid out by points (``nq``
    a cell) on its last axis."""
    out = {}
    for name, f in fns.items():
        whole = f(slice(0, nc))
        out[name] = {}
        for n in ranks:
            k = -(-nc // n)
            same = True
            for r in range(n):
                cells = slice(r * k, min((r + 1) * k, nc))
                part = f(cells)
                if name == "return_map":  # points, not cells, on the last axis
                    ref = whole[:, cells.start * nq:cells.stop * nq]
                else:
                    ref = whole[cells]
                same = same and torch.equal(part, ref)
            out[name][n] = same
    return out


def probe(N, mode, device, ranks=(2, 3)):
    """{product: {rank count: every rank's slice bitwise the whole's}} of
    the fused step's element chain."""
    fp = problems.mohr_coulomb_slope_step(N, N, linear_solver="mg", device=device,
                                          mg_opts={"mv0_mode": mode})
    Du, sig = fp.zero_state()
    for load in LOADS:
        Du, sig, *_ = fp.run_step(Du, sig, load)
    C, _ = fp._constitutive(Du, sig)
    return _compare(products(fp, Du, sig, C), fp.nc, fp.nq, ranks)


def probe_general(N, device, ranks=(2, 3)):
    """The same for the general pipeline's per-cell products on the slope
    of ``build_slope_problem``: the operand (the strain of Du) evaluated
    on a rank's cells, the Jacobian's action and the element-by-element
    Krylov operator's product."""
    from ..assembly import bc_arrays
    from ..expression import Expression
    from ..models.mohr_coulomb import build_slope_problem

    dev = torch.device(device)
    P = build_slope_problem(N, N, device=dev, route="cuda" if dev.type == "cuda" else "plain")
    mesh, Du = P["mesh"], P["Du"]
    rng = np.random.default_rng(N)
    Du.x.array[:] = 1e-3 * rng.standard_normal(P["V"].num_dofs)
    P["constitutive_update"]()
    (op,) = P["F_ops"]
    expr = Expression(op.ufl_operands[0], op.eval_points, dtype=torch.float64, device=dev)
    x = torch.as_tensor(rng.standard_normal(P["V"].num_dofs), device=dev)
    (e, _, ud), *_ = P["problem"].J.element_tensors()

    def operand(cells):
        return expr.eval(mesh, None if cells == slice(0, mesh.num_cells)
                         else np.arange(cells.start, cells.stop))

    def action(cells):  # CompiledForm.action's per-cell product
        return ec.ebe_cell_matvec(e[cells].contiguous(), ud[cells].contiguous(), x, 1)

    # solvers._ebe_operator's (Jacobi-CG, GMRES, BiCGStab): x zero on the
    # eliminated dofs
    mask, _ = bc_arrays(P["bcs"], x.shape[0], device=dev)
    xz = torch.where(mask, 0.0, x)

    def ebe_operator(cells):
        return ec.ebe_cell_matvec(e[cells].contiguous(), ud[cells].contiguous(), xz, 1)

    return _compare({"operand": operand, "action": action, "ebe_operator": ebe_operator},
                    mesh.num_cells, ranks=ranks)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "slice_bits.json"))
    args = ap.parse_args()
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("slice_bits: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    rep = {"device": name, "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(rep), flush=True)
    for N, mode in CASES:
        rep[f"{N}x{N} {mode}"] = probe(N, mode, dev)
        print(json.dumps({f"{N}x{N} {mode}": rep[f"{N}x{N} {mode}"]}), flush=True)
    for N in GENERAL_SIZES:
        rep[f"general {N}x{N}"] = probe_general(N, dev)
        print(json.dumps({f"general {N}x{N}": rep[f"general {N}x{N}"]}), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

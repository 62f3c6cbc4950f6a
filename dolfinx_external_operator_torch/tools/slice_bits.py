"""Which per-cell products of the sharded fused step give other bits on a
rank's slice of the cells than on the whole batch:

    python3 -m dolfinx_external_operator_torch.tools.slice_bits [--device cpu]
        [--out chiprun_out/slice_bits.json]

The sharded step's sums are order-free (``parallel.dist.cell_sum``), so a
rank gives the unsharded bits wherever its per-cell products give the
whole batch's.  For the slope step with AMG-CG (8x8 in the dia and node
level-0 layouts, 25x25 in dia), two load steps in, each product of the
element chain is computed on the cells of each rank of 2 and of 3 and
compared bit for bit with the same cells' rows of the whole batch: the
strain einsum, the residual, the tangent matvec and diagonal, the element
blocks in f64 and f32, the level-1 triple product, the element-blocked
matvec in f64 and f32, and the return map (K1 on the card).  One JSON line
per mesh and layout, ``true`` where every rank's slice gives the whole
batch's bits; all of them go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

from .. import problems

LOADS = (2.0, 6.0)
CASES = ((8, "dia"), (8, "node"), (25, "dia"))


def products(fp, Du, sig, C):
    """name -> f(cells): the product on the contiguous cells ``cells`` (a
    slice), as the rank that owns them computes it."""
    st, plan, f32 = fp.statics, fp._mg, torch.float32
    x = torch.cos(torch.arange(fp.n_dofs + 1, dtype=torch.float64, device=fp.device))

    def rows(t, cells):
        return t[cells].contiguous()

    def strain(cells, u=Du):
        u_cell = torch.cat([u, u.new_zeros(1)])[rows(st["dofmap"], cells)]
        return torch.einsum("cqik,ck->cqi", rows(st["B"], cells), u_cell)

    def residual(cells):
        return torch.einsum("cqik,cqi,cq->ck", rows(st["B"], cells), rows(sig, cells),
                            rows(st["wdet"], cells))

    def tangent_matvec(cells):
        dsig = torch.einsum("cqij,cqj->cqi", rows(C, cells), strain(cells, x[:-1]))
        return torch.einsum("cqik,cqi,cq->ck", rows(st["B"], cells), dsig,
                            rows(st["wdet"], cells))

    def tangent_diag(cells):
        B = rows(st["B"], cells)
        return torch.einsum("cqik,cqij,cqjk,cq->ck", B, rows(C, cells), B,
                            rows(st["wdet"], cells))

    def blocks(dtype):
        def f(cells):
            B = rows(st["B"], cells).to(dtype)
            return torch.einsum("cqik,cqij,cqjl,cq->ckl", B, rows(C, cells).to(dtype), B,
                                rows(st["wdet"], cells).to(dtype))
        return f

    def triple(cells):
        W = rows(plan["transfers"][0]["W"], cells)
        return W.transpose(1, 2) @ blocks(f32)(cells) @ W

    def ebe(dtype):
        def f(cells):
            K = blocks(torch.float64)(cells).to(dtype)
            idx = rows(plan["ebe"]["idx"], cells)
            nc, nk = K.shape[:2]
            if plan["ebe"]["mode"] == "node":
                u = F.pad(x[:-1].to(dtype).view(-1, 2), (0, 0, 0, 1))
                return torch.bmm(K, u[idx].view(nc, nk, 1))
            return torch.bmm(K, x.to(dtype)[idx].unsqueeze(-1))
        return f

    def return_map(cells):
        C_t, s_t = fp._vkernel(strain(cells).reshape(-1, 4).T.contiguous(),
                               rows(sig, cells).reshape(-1, 4).T.contiguous())
        return torch.cat([C_t.reshape(16, -1), s_t.reshape(4, -1)])

    return {"strain": strain, "residual": residual, "tangent_matvec": tangent_matvec,
            "tangent_diag": tangent_diag, "blocks_f64": blocks(torch.float64),
            "blocks_f32": blocks(f32), "level1_triple": triple, "ebe_f64": ebe(torch.float64),
            "ebe_f32": ebe(f32), "return_map": return_map}


def probe(N, mode, device, ranks=(2, 3)):
    """{product: {rank count: every rank's slice bitwise the whole's}}."""
    fp = problems.mohr_coulomb_slope_step(N, N, linear_solver="mg", device=device,
                                          mg_opts={"mv0_mode": mode})
    Du, sig = fp.zero_state()
    for load in LOADS:
        Du, sig, *_ = fp.run_step(Du, sig, load)
    C, _ = fp._constitutive(Du, sig)
    nc, nq = fp.nc, fp.nq
    out = {}
    for name, f in products(fp, Du, sig, C).items():
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
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

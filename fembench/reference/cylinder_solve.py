"""A load step of the thick cylinder solved by the reference alone, at a
given precision: the control that stands in the program's place.  Newton
on the assembled tangent (SciPy's sparse LU in that precision), from the
state the step was handed, until the residual falls below the
configuration's tolerance, has not fallen for ``patience`` updates in a row, or after
``max_it`` updates; the iterate with the least residual is returned."""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from .slope import internal_force, strain
from .von_mises import return_map


def solve_step(cyl, arrays, mat, sigma_n, p_n, Du0, load, dtype, atol=1e-8, max_it=25,
               patience=5):
    """``(Du (n,), sigma (nc, nq, 4))`` of one load step at pressure
    ``load`` times the material's ``q_lim``, in ``dtype``; ``arrays`` is
    ``cyl.on(device, dtype)``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    nc, nq = cyl.n_cells, cyl.nq
    bc = arrays["bc"]
    keep = sp.diags((~cyl.bc_mask).astype(np.float64))
    rows = np.repeat(cyl.dofmap, 12, axis=1).ravel()
    cols = np.tile(cyl.dofmap, (1, 12)).ravel()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    q = load * mat.q_lim(cyl.R_i, cyl.R_e)
    Du = Du0.to(dtype)
    sn = sigma_n.to(dtype).reshape(-1, 4).T
    pn = p_n.to(dtype).reshape(-1)
    best, stale = (math.inf, None, None), 0
    for it in range(max_it + 1):
        deps = strain(arrays, Du).reshape(-1, 4).T
        sig, _, C_t = return_map(mat, deps, sn, pn, dtype=dtype, tangent=True)
        sig = sig.T.reshape(nc, nq, 4)
        r = torch.where(bc, Du, internal_force(arrays, sig) - q * arrays["f"])
        norm = float(torch.linalg.vector_norm(r))
        stale = stale + 1 if not norm < best[0] else 0
        if stale == 0:
            best = (norm, Du, sig)
        if norm < atol or stale == patience or it == max_it:
            break
        Ct = C_t.permute(2, 0, 1).reshape(nc, nq, 4, 4)
        Ke = torch.einsum("cqik,cqij,cqjl,cq->ckl", arrays["B"], Ct, arrays["B"], arrays["w"])
        K = sp.coo_matrix((Ke.cpu().numpy().ravel(), (rows, cols)),
                          shape=(cyl.n_dofs, cyl.n_dofs)).tocsr()
        K = (keep @ K @ keep + sp.diags(cyl.bc_mask.astype(np.float64))).astype(np_dtype)
        dx = spla.spsolve(K.tocsc(), -r.cpu().numpy().astype(np_dtype))
        Du = Du + torch.as_tensor(dx, dtype=dtype, device=Du.device)
    return best[1], best[2]

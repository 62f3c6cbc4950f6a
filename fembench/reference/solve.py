"""A load step solved by the reference alone, at a given precision: the
control that stands in the program's place.  Newton on the assembled
tangent (SciPy's sparse LU in that precision), from the state the step was
handed, until the residual falls below the configuration's tolerance, has
not fallen for two updates, or after ``max_it`` updates; the iterate with
the least residual is returned."""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from .mohr_coulomb import return_map
from .slope import internal_force, strain


def solve_step(slope, arrays, mat, sigma_n, Du0, load, dtype, atol=1e-8, max_it=25):
    """``(Du (n,), sigma (nc, nq, 4))`` of one load step in ``dtype``;
    ``arrays`` is ``slope.on(device, dtype)``."""
    nc, nq = slope.n_cells, slope.nq
    bc = arrays["bc"]
    bc_np = slope.bc_mask
    keep = sp.diags((~bc_np).astype(np.float64))
    rows = np.repeat(slope.dofmap, 12, axis=1).ravel()
    cols = np.tile(slope.dofmap, (1, 12)).ravel()
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    Du = Du0.to(dtype)
    sn = sigma_n.to(dtype).reshape(-1, 4).T
    best, stale = (math.inf, None, None), 0
    for it in range(max_it + 1):
        deps = strain(arrays, Du).reshape(-1, 4).T
        sig, C_t, *_ = return_map(mat, deps, sn, dtype=dtype, tangent=True)
        sig = sig.T.reshape(nc, nq, 4)
        r = torch.where(bc, Du, internal_force(arrays, sig) - load * arrays["f"])
        norm = float(torch.linalg.vector_norm(r))
        stale = stale + 1 if not norm < best[0] else 0
        if stale == 0:
            best = (norm, Du, sig)
        if norm < atol or stale == 2 or it == max_it:
            break
        Ct = C_t.permute(2, 0, 1).reshape(nc, nq, 4, 4)
        Ke = torch.einsum("cqik,cqij,cqjl,cq->ckl", arrays["B"], Ct, arrays["B"], arrays["w"])
        K = sp.coo_matrix((Ke.cpu().numpy().ravel(), (rows, cols)),
                          shape=(slope.n_dofs, slope.n_dofs)).tocsr()
        K = (keep @ K @ keep + sp.diags(bc_np.astype(np.float64))).astype(np_dtype)
        dx = spla.spsolve(K.tocsc(), -r.cpu().numpy().astype(np_dtype))
        Du = Du + torch.as_tensor(dx, dtype=dtype, device=Du.device)
    return best[1], best[2]

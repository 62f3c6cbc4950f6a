"""Block-cyclic-reduction (BCR) direct solver for lattice-structured meshes.

The port of ``dolfinx_external_operator_tpu/parallel/bcr.py``.  Every
scalar dof of a P1/P2 vector space on a structured rectangle lies on a
complete tensor lattice (``_lattice_node_perm``), so in lexicographic
(y, x, component) numbering the tangent operator is block-banded with
|dy| <= 2 lattice rows.  Merging two lattice rows per block makes it
block-tridiagonal with dense (B, B) blocks, B = 2 * Lx * bs.

Cyclic reduction eliminates the odd block rows level by level (log2(m)
levels); every level is a batch of (B, B) SPD inversions (batched
Cholesky, triangular inverse, Gram product) and batched products.  The
factorization is f32 on the symmetrically equilibrated bands;
``ir_direct`` restores f64 accuracy by iterative refinement against the
exact f64 operator.

The host part (``build_bcr_statics``) is numpy; the device part works on
tensors of any device.  Batched products are ``torch.matmul`` in true f32
(TF32 is off for the whole package).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["bcr_apply", "bcr_factor", "build_bcr_statics", "equilibrate", "ir_direct"]


# ---------------------------------------------------------------------------
# host-side build
# ---------------------------------------------------------------------------

def _lattice_node_perm(coords):
    """Tensor-product lattice structure of 2D node coordinates (a copy of
    ``parallel/mg.py::_lattice_node_perm`` of the JAX package).

    Returns ``(perm_l2o, (ny, nx))`` (lattice slot -> node index, row-major
    in (y, x)) or ``None`` when the node set is not a complete grid.
    Uniform spacing is not required, only a bijection onto a tensor grid."""
    n = coords.shape[0]
    if coords.shape[1] != 2 or n == 0:
        return None
    xr = np.round(coords[:, 0], 9)
    yr = np.round(coords[:, 1], 9)
    xs = np.unique(xr)
    ys = np.unique(yr)
    if len(xs) * len(ys) != n:
        return None
    i = np.searchsorted(xs, xr)
    j = np.searchsorted(ys, yr)
    key = j.astype(np.int64) * len(xs) + i
    if np.unique(key).size != n:
        return None
    return np.argsort(key, kind="stable"), (len(ys), len(xs))


def build_bcr_statics(mesh, V, bc_mask):
    """Lattice detection and the (cell, a, b) -> T-slot scatter map (host).

    The flat ``T`` array holds, per block row p, the (B, 3B) row band
    ``[L_p | D_p | U_p]`` in lattice numbering; bc and padding rows get +1
    on their diagonal (identity rows).

    Returns None when the mesh is not lattice-structured, else a dict of
    numpy arrays, equal to the JAX package's:
      dst       (nc, nk*nk) flat T slot of each element-stiffness entry
      diag_fix  flat T slots of bc + padding rows needing the +1 identity
      diag_slot (N,) flat T slot of each row's diagonal entry
      perm_l2o / perm_o2l  lattice <-> original dof permutations (n,)
      m, B, n, sentinel    block count / block size / real dofs / dummy slot
    """
    bs = V.bs
    degree = V.element.degree
    if degree not in (1, 2) or mesh.points.shape[1] < 2:
        return None
    if degree == 2:
        node_xy = np.vstack([mesh.points[:, :2],
                             mesh.points[mesh.edges, :2].mean(axis=1)])
    else:
        node_xy = mesh.points[:, :2]
    det = _lattice_node_perm(node_xy)
    if det is None:
        return None
    node_perm, (Ly, Lx) = det
    n = node_xy.shape[0] * bs
    perm_l2o = (node_perm[:, None] * bs + np.arange(bs)[None, :]).ravel()
    perm_o2l = np.empty(n, np.int64)
    perm_o2l[perm_l2o] = np.arange(n)

    R = Lx * bs            # lattice dofs per lattice row
    B = 2 * R              # block = two lattice rows
    m = (Ly + 1) // 2      # block rows (the last may be half padding)
    N = m * B
    row_band = 3 * B
    sentinel = m * B * row_band

    dm = V.unrolled_dofmap.astype(np.int64)   # (nc, nk)
    rlat = perm_o2l[dm]                       # lattice dof of each cell dof
    br = rlat // B
    ri = rlat % B
    # column slot within the row band [L | D | U] of block row br
    slot = rlat[:, None, :] - (br[:, :, None] - 1) * B   # (nc, a, b)
    if slot.min() < 0 or slot.max() >= row_band:
        # a coupling reaches beyond the neighbouring block rows
        return None
    dst = (br[:, :, None] * (B * row_band) + ri[:, :, None] * row_band
           + slot).reshape(dm.shape[0], -1)
    idt = np.int64 if sentinel > 2**31 - 2 else np.int32
    dst = dst.astype(idt)

    # identity rows: bc dofs (in lattice numbering) and padding rows >= n
    rows = np.arange(N, dtype=np.int64)
    is_pad = rows >= n
    is_bc = np.zeros(N, dtype=bool)
    is_bc[:n] = np.asarray(bc_mask, bool)[perm_l2o]
    diag_all = (rows // B) * (B * row_band) + (rows % B) * row_band \
        + B + (rows % B)
    diag_fix = diag_all[is_pad | is_bc].astype(idt)

    return {
        "dst": dst,
        "diag_fix": diag_fix,
        "diag_slot": diag_all.astype(idt),
        "perm_l2o": perm_l2o.astype(np.int32),
        "perm_o2l": perm_o2l.astype(np.int32),
        "m": int(m), "B": int(B), "n": int(n), "sentinel": int(sentinel),
    }


# ---------------------------------------------------------------------------
# device-side factorization and solve
# ---------------------------------------------------------------------------

def _spd_inv_batched(Ks, stats=None):
    """Explicit inverses of a batch of SPD matrices: batched Cholesky, the
    factor's inverse by one triangular solve against I, and the Gram
    product ``inv(L)^T inv(L)``, as the JAX package computes it (on an H100
    the factorization takes 2.5x as long with ``cholesky_inverse``, whose
    two batched triangular solves dominate).  A breakdown anywhere in
    the batch (``info != 0`` or a non-finite factor entry: a non-SPD block)
    sends the whole batch to the pivoted-LU ``inv``, as the JAX package
    does; ``stats["inv_levels"]`` counts those batches.  One host sync per
    call (the breakdown test)."""
    L, info = torch.linalg.cholesky_ex(Ks)
    if bool((info != 0).any() | ~torch.isfinite(L).all()):
        if stats is not None:
            stats["inv_levels"] = stats.get("inv_levels", 0) + 1
        return torch.linalg.inv(Ks)
    eye = torch.eye(Ks.shape[-1], dtype=Ks.dtype, device=Ks.device).expand_as(Ks)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    return Li.mT @ Li


def _bmv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _pad_front(x):
    return torch.cat([torch.zeros_like(x[:1]), x])


def _pad_back_to(x, k):
    pad = k - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def bcr_factor(T, m, B, stats=None):
    """Cyclic-reduction factorization of the block-tridiagonal system.

    ``T`` (m, B, 3B): per block row the dense row band [L | D | U]
    (equilibrated, identity bc rows).  A Python loop over the log2(m)
    levels; all work in a level is batched.  ``stats`` (a dict, optional)
    counts the levels whose inversion fell back to ``inv``.

    Returns (levels, root_inv): per level the solve operators
      A  = L_even @ inv(D_left-odd)      (ne, B, B)
      C  = U_even @ inv(D_right-odd)     (ne, B, B)
      V  = inv(D_odd)                    (no, B, B)
      VL = V @ L_odd,  VU = V @ U_odd    (no, B, B)
    """
    L = T[:, :, :B]
    D = T[:, :, B:2 * B]
    U = T[:, :, 2 * B:]
    levels = []
    while m > 1:
        no = m // 2
        ne = m - no
        V = _spd_inv_batched(D[1::2], stats)
        L_odd, U_odd = L[1::2], U[1::2]
        # alignment for even block 2k: left odd = #(k-1), right odd = #k
        Vl = _pad_front(V)[:ne]
        Llo = _pad_front(L_odd)[:ne]
        Ulo = _pad_front(U_odd)[:ne]
        Vr = _pad_back_to(V, ne)
        Lro = _pad_back_to(L_odd, ne)
        Uro = _pad_back_to(U_odd, ne)

        A = L[0::2] @ Vl
        C = U[0::2] @ Vr
        levels.append({"A": A, "C": C, "V": V,
                       "VL": V @ L_odd, "VU": V @ U_odd})
        D = D[0::2] - A @ Ulo - C @ Lro
        L = -(A @ Llo)
        U = -(C @ Uro)
        m = ne
    root_inv = _spd_inv_batched(D, stats)  # (1, B, B)
    return levels, root_inv


def bcr_apply(fact, b):
    """Solve the factored system for one right-hand side ``b`` (m*B,).

    Forward: fold the odd rows' contributions into the reduced right-hand
    side at every level; backward: recover the odd unknowns and
    re-interleave them (stack and reshape).  All batched (B, B) x (B,)
    products."""
    levels, root_inv = fact
    B = root_inv.shape[-1]
    b = b.reshape(-1, B)
    odd_rhs = []
    for lv in levels:
        bo = b[1::2]
        ne = lv["A"].shape[0]
        bol = _pad_front(bo)[:ne]
        bor = _pad_back_to(bo, ne)
        odd_rhs.append(bo)
        b = b[0::2] - _bmv(lv["A"], bol) - _bmv(lv["C"], bor)
    x = _bmv(root_inv, b)  # (1, B)
    for lv, bo in zip(reversed(levels), reversed(odd_rhs)):
        no = lv["V"].shape[0]
        ne = lv["A"].shape[0]
        xr = _pad_back_to(x, ne + 1)[1:no + 1]
        xo = _bmv(lv["V"], bo) - _bmv(lv["VL"], x[:no]) - _bmv(lv["VU"], xr)
        xo_p = _pad_back_to(xo, ne)
        x = torch.stack([x, xo_p], dim=1).reshape(2 * ne, B)[:ne + no]
    return x.reshape(-1)


def equilibrate(Tflat, diag_slot, m, B):
    """Symmetric diagonal equilibration of the assembled row bands.

    Returns (T (m, B, 3B) scaled, d (m*B,) with ``d = 1/sqrt(|diag|)``); the
    solve applies ``x = d * apply(d * r)``.  Identity rows (bc/padding) have
    diag exactly 1, so d = 1 there.  ``Tflat`` is left as it is."""
    d = 1.0 / torch.sqrt(torch.clamp(torch.abs(Tflat[diag_slot]), min=1e-30))
    dpad = torch.cat([d.new_zeros(B), d, d.new_zeros(B)])
    rows = torch.arange(m, device=d.device)[:, None] * B
    win = dpad[rows + torch.arange(3 * B, device=d.device)[None, :]]
    T = Tflat.reshape(m, B, 3 * B) * d.view(m, B, 1)
    return T.mul_(win.view(m, 1, 3 * B)), d


_MAX_ROUNDS = 25


def ir_direct(mv64, solve32, b, rtol):
    """f64 iterative refinement around the f32 direct solve.

    Each round applies the factorization once and re-evaluates the residual
    with the exact f64 operator.  Exits on ``|r| <= rtol * |b|``, on a round
    that does not contract (stall) or after ``_MAX_ROUNDS``; returns (best
    iterate, signed rounds), the count negated when the target was not
    reached.  One host sync per round (the loop test)."""
    bnorm = float(torch.sqrt(torch.dot(b, b)))
    target = rtol * bnorm
    x = torch.zeros_like(b)
    r, rn, k = b, bnorm, 0
    xb, nb = x, bnorm
    while rn > target and k < _MAX_ROUNDS:
        x = x + solve32(r)
        r = b - mv64(x)
        nn = float(torch.sqrt(torch.dot(r, r)))
        k += 1
        if nn < nb:
            xb, nb = x, nn
        if not (math.isfinite(nn) and nn < rn):  # a round that stalls
            break
        rn = nn
    return xb, (k if nb <= target else -k)

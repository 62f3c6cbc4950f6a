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
(TF32 is off for the whole package).  A solver keeps one factorization's
tensors (``bcr_workspace``) and refactors into them, so that a CUDA graph
of the refinement round (``fixed_round``) reads the current factor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.graphs import capture, replayable
from ..utils.profiling import count, host_read, span

__all__ = ["bcr_apply", "bcr_factor", "bcr_workspace", "build_bcr_statics", "equilibrate",
           "fixed_round", "ir_direct"]


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

def _spd_inv_batched(Ks, counter=None, out=None):
    """Explicit inverses of a batch of SPD matrices: batched Cholesky, the
    factor's inverse by one triangular solve against I, and the Gram
    product ``inv(L)^T inv(L)``, as the JAX package computes it (on an H100
    the factorization takes 2.5x as long with ``cholesky_inverse``, whose
    two batched triangular solves dominate).  A breakdown anywhere in
    the batch (``info != 0`` or a non-finite factor entry: a non-SPD block)
    sends the whole batch to the pivoted-LU ``inv``, as the JAX package
    does; the profiling counter named ``counter`` (if any) counts those
    batches.  Written into ``out`` where given.  One host read per call
    (the breakdown test)."""
    L, info = torch.linalg.cholesky_ex(Ks)
    if host_read((info != 0).any() | ~torch.isfinite(L).all(), bool):
        if counter is not None:
            count(counter)
        inv = torch.linalg.inv(Ks)
        return inv if out is None else out.copy_(inv)
    eye = torch.eye(Ks.shape[-1], dtype=Ks.dtype, device=Ks.device).expand_as(Ks)
    Li = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(Li.mT, Li, out=out)


def _bmv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _pad_front(x):
    return torch.cat([torch.zeros_like(x[:1]), x])


def _pad_back_to(x, k):
    pad = k - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def bcr_workspace(m, B, dtype, device):
    """The tensors of one factorization of ``m`` block rows of ``B``, for
    ``bcr_factor(..., workspace=)`` to write into: a (levels, root_inv)
    pair shaped as ``bcr_factor`` returns it, its values unset."""
    levels = []
    while m > 1:
        no = m // 2
        ne = m - no
        levels.append({k: torch.empty((ne if k in "AC" else no, B, B), dtype=dtype,
                                      device=device) for k in ("A", "C", "V", "VL", "VU")})
        m = ne
    return levels, torch.empty((1, B, B), dtype=dtype, device=device)


def bcr_factor(T, m, B, workspace=None):
    """Cyclic-reduction factorization of the block-tridiagonal system.

    ``T`` (m, B, 3B): per block row the dense row band [L | D | U]
    (equilibrated, identity bc rows).  A Python loop over the log2(m)
    levels; all work in a level is batched.  Counts ``bcr.factorizations``
    and, in ``bcr.inv_levels``, the levels whose inversion fell back to
    ``inv`` (``utils.profiling``).

    Returns (levels, root_inv): per level the solve operators
      A  = L_even @ inv(D_left-odd)      (ne, B, B)
      C  = U_even @ inv(D_right-odd)     (ne, B, B)
      V  = inv(D_odd)                    (no, B, B)
      VL = V @ L_odd,  VU = V @ U_odd    (no, B, B)
    written into ``workspace`` (``bcr_workspace(m, B, ...)``) where given,
    by the same operations: the same bits in the same tensors each call.
    """
    count("bcr.factorizations")
    L = T[:, :, :B]
    D = T[:, :, B:2 * B]
    U = T[:, :, 2 * B:]
    outs, root_out = workspace if workspace is not None else (None, None)
    levels = []
    while m > 1:
        no = m // 2
        ne = m - no
        out = outs[len(levels)] if outs is not None else {}
        V = _spd_inv_batched(D[1::2], "bcr.inv_levels", out=out.get("V"))
        L_odd, U_odd = L[1::2], U[1::2]
        # alignment for even block 2k: left odd = #(k-1) (padded in front),
        # right odd = #k (padded at the back).  Each padded operand lives
        # only for its product, and L, U are negated in place: the first
        # level's peak then holds a workspace's later levels too
        A = torch.matmul(L[0::2], _pad_front(V)[:ne], out=out.get("A"))
        C = torch.matmul(U[0::2], _pad_back_to(V, ne), out=out.get("C"))
        levels.append({"A": A, "C": C, "V": V,
                       "VL": torch.matmul(V, L_odd, out=out.get("VL")),
                       "VU": torch.matmul(V, U_odd, out=out.get("VU"))})
        D = D[0::2] - A @ _pad_front(U_odd)[:ne] - C @ _pad_back_to(L_odd, ne)
        L = (A @ _pad_front(L_odd)[:ne]).neg_()
        U = (C @ _pad_back_to(U_odd, ne)).neg_()
        m = ne
    root_inv = _spd_inv_batched(D, "bcr.inv_levels", out=root_out)  # (1, B, B)
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
    """Symmetric diagonal equilibration of the assembled row bands, in
    place: a scaled copy would hold the bands twice beside a solver's
    factor workspace.

    Returns (T (m, B, 3B), ``Tflat`` scaled, d (m*B,) with ``d =
    1/sqrt(|diag|)``); the solve applies ``x = d * apply(d * r)``.  Identity
    rows (bc/padding) have diag exactly 1, so d = 1 there."""
    d = 1.0 / torch.sqrt(torch.clamp(torch.abs(Tflat[diag_slot]), min=1e-30))
    dpad = torch.cat([d.new_zeros(B), d, d.new_zeros(B)])
    rows = torch.arange(m, device=d.device)[:, None] * B
    win = dpad[rows + torch.arange(3 * B, device=d.device)[None, :]]
    T = Tflat.view(m, B, 3 * B).mul_(d.view(m, B, 1))
    return T.mul_(win.view(m, 1, 3 * B)), d


_MAX_ROUNDS = 25


def ir_direct(mv64, solve32, b, rtol, round_fn=None):
    """f64 iterative refinement around the f32 direct solve.

    Each round applies the factorization once and re-evaluates the residual
    with the exact f64 operator.  Exits on ``|r| <= rtol * |b|``, on a round
    that does not contract (stall) or after ``_MAX_ROUNDS``; returns (best
    iterate, signed rounds), the count negated when the target was not
    reached.  One host read per round (the loop test); counts
    ``solve.rounds``, and ``solve.short`` where the target was not
    reached.

    ``round_fn`` ``(x, r) -> (x', r', |r'| tensor)`` computes a round in
    place of ``mv64`` and ``solve32`` (``fixed_round``); the iterate it
    returns may then live in its buffers."""
    if round_fn is None:
        def round_fn(x, r):
            x = x + solve32(r)
            r = b - mv64(x)
            return x, r, torch.sqrt(torch.dot(r, r))

    bnorm = host_read(torch.sqrt(torch.dot(b, b)))
    target = rtol * bnorm
    x = torch.zeros_like(b)
    r, rn, k = b, bnorm, 0
    xb, nb = x, bnorm
    while rn > target and k < _MAX_ROUNDS:
        with span("deo.solve.round"):
            x, r, nn = round_fn(x, r)
            nn = host_read(nn)
        k += 1
        if nn < nb:
            xb, nb = x, nn
        if not (math.isfinite(nn) and nn < rn):  # a round that stalls
            break
        rn = nn
    count("solve.rounds", k)
    if nb > target:
        count("solve.short")
    return xb, (k if nb <= target else -k)


def fixed_round(solve32, mv64, b, device_mesh=None):
    """``ir_direct``'s round over fixed buffers, for ``ir_direct(...,
    round_fn=)``: ``x' = x + solve32(r)``, ``r' = b - mv64(x')`` and
    ``|r'|`` by the eager round's operations, written into one of two
    (x, r) pairs while the other holds the round's input, so that the best
    iterate survives a round that does not contract.  ``solve32``, ``mv64``
    and ``b`` read tensors that stay put: the caller refreshes their
    values in place between solves.

    Where ``utils.graphs.replayable`` allows it for ``b``'s device and
    ``device_mesh`` (the ranks that ``mv64`` sums over; ``None``: one
    device), each direction is captured once as a CUDA graph
    (``utils.graphs.capture``), the two on one memory pool, and a round is
    one replay where the eager round launches about 150 kernels; counts
    ``bcr.round_replays`` a round."""
    pairs = ((torch.zeros_like(b), b.clone()), (torch.empty_like(b), torch.empty_like(b)))
    nn = b.new_empty(())

    def body(i):
        (x, r), (x2, r2) = pairs[i], pairs[1 - i]
        torch.add(x, solve32(r), out=x2)
        torch.sub(b, mv64(x2), out=r2)
        torch.sqrt(torch.dot(r2, r2), out=nn)

    run = body
    if replayable(b.device, device_mesh):
        first = capture(body, 0)
        graphs = (first, capture(body, 1, pool=first.pool))

        def run(i):
            graphs[i](i)
            count("bcr.round_replays")

    def round_fn(x, r):
        if x is pairs[0][0]:
            i = 0
        elif x is pairs[1][0]:
            i = 1
        else:  # a solve's first round: its zero iterate and b
            pairs[0][0].copy_(x)
            pairs[0][1].copy_(r)
            i = 0
        run(i)
        return (*pairs[1 - i], nn)

    return round_fn

"""Multigrid-preconditioned CG: aggregation AMG inside mixed-precision CG.

The port of ``dolfinx_external_operator_tpu/parallel/mg.py``.  The
hierarchy's structure is built once on the host from the ELASTIC operator
(``build_mg_statics``, numpy and scipy, array-equal to the JAX package's):

* level 0 is the Pk displacement space, matrix-free element-blocked
  (``ebe_matvec``) or, on lattice meshes, stencil-banded in a lexicographic
  numbering (DIA: a fixed set of band offsets);
* level 1 is the P1 (vertex) space on the same mesh: the P2 -> P1
  restriction is nested and cell-local, so its Galerkin product is a
  per-cell triple product;
* levels 2+ coarsen by greedy node aggregation with the 2D rigid-body
  modes as the tentative nullspace, Jacobi-smoothed against the elastic
  operator (smoothed aggregation);
* the coarsest level is inverted explicitly.

Per Newton update, ``mg_setup`` recomputes the VALUES from the current
tangent in f32 through fixed maps; ``vcycle`` applies the cycle with
Chebyshev/Jacobi smoothing of fixed degree, so it is a fixed linear
operator, and ``ir_pcg`` runs f32 PCG with it inside f64 iterative
refinement.  The JAX package's algorithms are kept, including those
shaped by TPU limits: the f32 inner iteration, the explicit coarse
inverse, the dense small levels, the DIA lattice layout and the stencil
transfers.

Cell-sharded (``spmd.FusedPlasticityStep(device_mesh=...)``, the general
pipeline's ``pc_type="mg"``), each rank computes its own cells' level-0
contributions (the element blocks, the level-1 triple product with its
``W``) for the four scatters that the JAX package psums: the level-0 band
values or diagonal, the element-blocked matvec and the level-1 values.
The plan's ``whole`` makes every cell's contributions whole on every rank
(``dist.cell_sum``, one all-reduce each) and the tables of every cell
(``dofmap_all``, ``blk_dst``, ``dia0_dst``) sum them in the unsharded
order, so no sum of the plan depends on the rank count.  The coarse levels
and the cycle below level 0 are whole on every rank.

The device part runs eagerly on the tensors' device.  Where the JAX
package loops in Python over bands and stencil taps (and XLA fuses the
loop), this module gathers through a table built once and sums over the
table's axis, a few launches per operator.  Every scatter-add is a padded
gather table (``scatter.py``), never ``index_add_``.  The JAX
``while_loop``s are Python loops with one host read per batch of inner
iterations and one per refinement round (``ir_pcg``).  ``AMGCG``, the
AMG-CG solver of both Newton loops, keeps its hierarchy's values in a
workspace and replays its batches from CUDA graphs where
``utils.graphs.replayable`` allows.  Inside the loops, on the card, each
Chebyshev step's vector updates and each f32 PCG iteration's vector and
scalar work run as hand-written kernels (``ops/mg_cycle.py``) where XLA
fused the chains: the torch chains' operations and bits, a launch where
they made tens.  On the CPU the torch chains run
(``_chebyshev_reference``, ``_pcg_iterations_reference``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from ..ops import element_chain as ec
from ..ops import mg_cycle as mgc
from ..utils.graphs import capture, replayable
from ..utils.profiling import count, host_read, span
from .bcr import _lattice_node_perm
from .scatter import dedup_table, dedup_write, segment_sum, segment_table

__all__ = ["AMGCG", "build_mg_statics", "ebe_matvec", "ebe_plan", "ir_pcg", "mg_plan",
           "mg_setup", "vcycle"]

_F32 = torch.float32

_I = np.int32

# dofs per node: the hierarchy implements the 2D vector (rigid-body-mode)
# case only
_BS = 2

# levels of at most this many dofs run dense matvecs (the JAX package's
# mg_setup dense_below)
_DENSE_BELOW = 6144
# power iterations per level for the Chebyshev bounds
_POWER_ITERS = 8
# the smoother targets [_LMIN_FRAC * lmax, lmax]
_LMIN_FRAC = 0.3
# ir_pcg: at most this many refinement rounds; each round's f32 target is
# floored at _INNER_FLOOR of its right-hand side, and its PCG stops after
# _INNER_CAP iterations or _STALL_WINDOW iterations without a new best
_MAX_ROUNDS = 6
_INNER_FLOOR = 1e-6
_INNER_CAP = 600
_STALL_WINDOW = 30
# ir_pcg reads its loop tests once per batch of iterations, the batch
# doubling from 1 up to this
_READ_BATCH = 8


# ======================================================================
# Host-side hierarchy construction (scipy/numpy, runs once per problem)
# ======================================================================

def _csr_from_blocks(blocks, dofmap, n):
    """Assemble (nc, nk, nk) element blocks into an n x n CSR."""
    nk = blocks.shape[1]
    rows = np.repeat(dofmap, nk, axis=1).ravel()
    cols = np.tile(dofmap, (1, nk)).ravel()
    # tocsr() sums duplicates in C; the explicit python-side
    # coo.sum_duplicates() lexsorts the same 46M entries (at 200x200)
    # a second time for ~15 s of pure overhead
    return sp.coo_matrix((blocks.ravel(), (rows, cols)), shape=(n, n)).tocsr()


def _eliminate_bc(A, bc_mask):
    """Zero bc rows/cols, unit diagonal (symmetric elimination)."""
    keep = sp.diags((~bc_mask).astype(np.float64))
    return (keep @ A @ keep + sp.diags(bc_mask.astype(np.float64))).tocsr()


def _zero_rows(P, mask):
    if mask is None or not mask.any():
        return P.tocsr()
    keep = sp.diags((~mask).astype(np.float64))
    return (keep @ P).tocsr()


def _p2_to_p1_interpolation(mesh, bs, bc_mask):
    """Geometric P2->P1 interpolation on the same mesh (scalar dof order:
    vertices then edge midpoints — see ``FunctionSpace._build_dofmap``).
    Rows at Dirichlet dofs are zeroed (coarse corrections stay in the
    homogeneous space).  Returns CSR of shape (n_p2*bs, n_p1*bs)."""
    nv = mesh.num_vertices
    ne = mesh.num_edges
    edges = mesh.edges.astype(np.int64)
    rows = np.concatenate([np.arange(nv), nv + np.arange(ne), nv + np.arange(ne)])
    cols = np.concatenate([np.arange(nv), edges[:, 0], edges[:, 1]])
    vals = np.concatenate([np.ones(nv), np.full(ne, 0.5), np.full(ne, 0.5)])
    P_s = sp.coo_matrix((vals, (rows, cols)), shape=(nv + ne, nv)).tocsr()
    return _zero_rows(sp.kron(P_s, sp.eye(bs), format="csr"), bc_mask)


def _block_graph(A, bs):
    """Collapse a dof-level sparse matrix to a node-level |.|-sum graph."""
    n_nodes = A.shape[0] // bs
    ind = sp.coo_matrix(
        (np.ones(A.shape[0]), (np.arange(A.shape[0]) // bs, np.arange(A.shape[0]))),
        shape=(n_nodes, A.shape[0]),
    ).tocsr()
    return (ind @ abs(A.tocsr()) @ ind.T).tocsr()


def _aggregate(G):
    """Greedy standard aggregation (PyAMG-style, two passes) on a node
    graph G (CSR; self-loops ignored).  Returns (agg_id (n,), n_agg)."""
    n = G.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = G.indptr, G.indices
    n_agg = 0
    for i in range(n):  # pass 1: roots with fully-unaggregated neighborhoods
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if np.all(agg[nbrs] == -1):
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    for i in range(n):  # pass 2: join the most-connected aggregated neighbor
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        cand = agg[nbrs]
        cand = cand[cand != -1]
        if cand.size:
            agg[i] = np.bincount(cand).argmax()
        else:  # isolated node: own aggregate
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _tentative_rbm(agg, n_agg, B, bs):
    """Tentative prolongator from the near-nullspace B (n_dofs, nns) with
    per-aggregate QR orthonormalization (the standard SA construction).
    Returns (T CSR (n_dofs, n_agg*nns), B_coarse (n_agg*nns, nns))."""
    n_dofs, nns = B.shape
    agg_of_dof = agg[np.arange(n_dofs) // bs]
    order = np.argsort(agg_of_dof, kind="stable")
    bounds = np.searchsorted(agg_of_dof[order], np.arange(n_agg + 1))
    rows, cols, vals = [], [], []
    Bc = np.zeros((n_agg * nns, nns))
    for a in range(n_agg):
        dofs = order[bounds[a]:bounds[a + 1]]
        Q, R = np.linalg.qr(B[dofs, :])
        d = np.abs(np.diag(R))
        keep = d > 1e-10 * max(d.max(), 1e-300)  # rank guard (tiny aggregates)
        Q = Q[:, keep]
        k = int(keep.sum())
        rows.append(np.repeat(dofs, k))
        cols.append(np.tile(a * nns + np.flatnonzero(keep), dofs.size))
        vals.append(Q.ravel())
        Bc[a * nns + np.flatnonzero(keep), :] = R[keep, :]
    T = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_dofs, n_agg * nns),
    ).tocsr()
    return T, Bc


def _lmax_dinv_a(A, iters=20):
    """Host power-iteration estimate of lambda_max(D^-1 A)."""
    d = A.diagonal()
    d = np.where(np.abs(d) > 1e-300, d, 1.0)
    x = np.cos(1.234 * np.arange(A.shape[0]))
    lam = 1.0
    for _ in range(iters):
        x = (A @ x) / d
        lam = np.linalg.norm(x)
        x = x / max(lam, 1e-300)
    return lam


class _EllLayout:
    """Padded-ELL view of a CSR pattern with vectorized (i, j) -> flat-slot
    lookup (flat slot = row * m + position-in-row)."""

    def __init__(self, A):
        A = A.tocsr()
        A.sort_indices()
        self.n = A.shape[0]
        counts = np.diff(A.indptr)
        self.m = max(int(counts.max()) if self.n else 0, 1)
        nnz = A.indptr[-1]
        rows = np.repeat(np.arange(self.n), counts)
        pos = np.arange(nnz) - A.indptr[rows]
        cols = np.tile(np.arange(self.n)[:, None], (1, self.m))  # pad: own row
        cols[rows, pos] = A.indices
        self.cols = cols
        self.indptr = A.indptr
        self.indices = A.indices
        # sorted row-major keys for vectorized membership lookup
        self._keys = rows.astype(np.int64) * self.n + A.indices.astype(np.int64)
        self._rows = rows
        self.diag_slot = self.lookup(np.arange(self.n), np.arange(self.n))

    def lookup(self, i, j, missing=None):
        """Flat ELL slots for (i, j) pairs; entries not in the pattern get
        ``missing`` (default: raises)."""
        i = np.asarray(i, np.int64)
        j = np.asarray(j, np.int64)
        key = i * self.n + j
        p = np.searchsorted(self._keys, key)
        p = np.minimum(p, len(self._keys) - 1)
        found = self._keys[p] == key
        if missing is None:
            assert found.all(), "pattern lookup miss"
        slot = self._rows[p].astype(np.int64) * self.m + (p - self.indptr[self._rows[p]])
        if missing is not None:
            slot = np.where(found, slot, missing)
        return slot


def _padded_rows(P):
    """CSR rows -> (idx (n, pmax), w (n, pmax)) with zero-weight padding."""
    P = P.tocsr()
    P.sort_indices()
    n = P.shape[0]
    counts = np.diff(P.indptr)
    pmax = max(int(counts.max()) if n else 0, 1)
    nnz = P.indptr[-1]
    rows = np.repeat(np.arange(n), counts)
    pos = np.arange(nnz) - P.indptr[rows]
    idx = np.zeros((n, pmax), dtype=np.int64)
    w = np.zeros((n, pmax))
    idx[rows, pos] = P.indices
    w[rows, pos] = P.data
    return idx, w


def _block_gather_form(P, bs_r, bs_c):
    """Row-block gather form of a CSR matrix: for each bs_r-row block, the
    padded list of bs_c-column blocks it touches (idx, (nrb, K)) and the
    dense per-pair weight blocks (w, (nrb, bs_r, K, bs_c)).

    ``y = P @ x`` then becomes a gather of K column blocks per row block
    plus a tiny batched product — no scatter, and bs_r*bs_c weight entries
    ride on one gathered block; applying the same form to P^T turns the
    restriction's scatter-add into a gather as well.  (The JAX package
    chose the form because a TPU pays per gathered element.)"""
    n_r, n_col = P.shape
    nrb, ncb = n_r // bs_r, n_col // bs_c
    C = P.tocoo()
    rb = C.row.astype(np.int64) // bs_r
    cb = C.col.astype(np.int64) // bs_c
    key = rb * np.int64(ncb) + cb
    pairs = np.unique(key)
    prb = pairs // ncb
    counts = np.bincount(prb, minlength=nrb)
    kmax = max(int(counts.max()) if nrb else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(pairs.size) - np.repeat(starts, counts)
    idx = np.zeros((nrb, kmax), dtype=np.int64)
    idx[prb, slot] = pairs % ncb
    w = np.zeros((nrb, bs_r, kmax, bs_c), dtype=np.float32)
    pos = np.searchsorted(pairs, key)
    w[rb, C.row % bs_r, slot[pos], C.col % bs_c] = C.data
    return idx, w


def _block_transfer_forms(P, bs_f, bs_c, max_pad=512):
    """Both directions of a prolongator in block gather form (see
    _block_gather_form): Pb_* applies P (prolong, fine rows), Rb_* applies
    P^T (restrict, coarse rows).  Returns None when a row block would need
    more than ``max_pad`` padded column blocks (pathological aggregation —
    fall back to the scalar forms)."""
    P = P.tocsr()
    n_f, n_c = P.shape
    if n_f % bs_f or n_c % bs_c:
        return None
    Pb_idx, Pb_w = _block_gather_form(P, bs_f, bs_c)
    Rb_idx, Rb_w = _block_gather_form(P.T.tocsr(), bs_c, bs_f)
    if Pb_idx.shape[1] > max_pad or Rb_idx.shape[1] > max_pad:
        return None
    return {"Pb_idx": Pb_idx.astype(_I), "Pb_w": Pb_w,
            "Rb_idx": Rb_idx.astype(_I), "Rb_w": Rb_w}


def _galerkin_contrib_map(ell_f, P, ell_c):
    """Flat contribution map for  A_c[I,J] += P[i,I] * A_f[i,j] * P[j,J]
    over FIXED patterns: (src_flat, weight, dst_flat) into the fine/coarse
    ELL value vectors.  Vectorized over (fine nnz) x (P-row pairs)."""
    fi = ell_f._rows
    fj = ell_f.indices
    src_flat = fi.astype(np.int64) * ell_f.m + (np.arange(len(fj)) - ell_f.indptr[fi])
    Pr_idx, Pr_w = _padded_rows(P)
    src, wgt, dst = [], [], []
    for a in range(Pr_idx.shape[1]):
        I = Pr_idx[fi, a]
        wi = Pr_w[fi, a]
        for b in range(Pr_idx.shape[1]):
            J = Pr_idx[fj, b]
            w = wi * Pr_w[fj, b]
            keep = w != 0.0
            if not keep.any():
                continue
            d = ell_c.lookup(I[keep], J[keep])
            src.append(src_flat[keep])
            wgt.append(w[keep])
            dst.append(d)
    src = np.concatenate(src)
    wgt = np.concatenate(wgt)
    dst = np.concatenate(dst)
    # sorted by destination (the JAX package's sorted segment_sum)
    order = np.argsort(dst, kind="stable")
    return (src[order].astype(_I), wgt[order], dst[order].astype(_I))


def _transfer0_stencil(P0_lat, shape0, shape1, bs, mask0_lat):
    """Derive a 2:1 inter-grid stencil from the (fully lattice-numbered)
    P2->P1 interpolation matrix: offsets (dj, di, w) such that
    ``P0[(2J+dj, 2I+di, c), (J, I, c)] == w`` for every in-range,
    non-bc row.  Verified EXACTLY against P0 by reconstruction — any
    mismatch (non-uniform weights, component coupling, non-nested
    interpolation) returns None and callers keep the gather-based
    transfer.  With a stencil, restrict/prolong become strided slices —
    no gathers (at 100x100 the transfer gathers are ~324k indexed
    elements each, a real share of a cycle once the matvecs are DIA)."""
    ny0, nx0 = shape0
    ny1, nx1 = shape1
    coo = P0_lat.tocoo()
    rnode, rcomp = coo.row // bs, coo.row % bs
    cnode, ccomp = coo.col // bs, coo.col % bs
    if np.any(rcomp != ccomp):
        return None
    rj, ri = rnode // nx0, rnode % nx0
    cj, ci = cnode // nx1, cnode % nx1
    dj, di = rj - 2 * cj, ri - 2 * ci
    if dj.size == 0 or np.abs(dj).max() > 3 or np.abs(di).max() > 3:
        return None
    key = (dj + 4) * 8 + (di + 4)
    stencil = []
    for k in np.unique(key):
        m = key == k
        w = coo.data[m]
        if np.ptp(w) > 1e-12:
            return None
        stencil.append((int(dj[m][0]), int(di[m][0]), float(w[0])))
    # exact reconstruction check
    J, I = np.mgrid[0:ny1, 0:nx1]
    rows_h, cols_h, vals_h = [], [], []
    for dj_, di_, w_ in stencil:
        rj_ = 2 * J + dj_
        ri_ = 2 * I + di_
        ok = (rj_ >= 0) & (rj_ < ny0) & (ri_ >= 0) & (ri_ < nx0)
        rn = (rj_ * nx0 + ri_)[ok]
        cn = (J * nx1 + I)[ok]
        for c in range(bs):
            r_ = rn * bs + c
            keep = ~mask0_lat[r_]
            rows_h.append(r_[keep])
            cols_h.append((cn * bs + c)[keep])
            vals_h.append(np.full(int(keep.sum()), w_))
    P_hat = sp.coo_matrix(
        (np.concatenate(vals_h), (np.concatenate(rows_h), np.concatenate(cols_h))),
        shape=P0_lat.shape).tocsr()
    diff = abs(P_hat - P0_lat)
    if diff.nnz and diff.max() > 1e-12:
        return None
    return tuple(stencil)


def _ell_vals_from_csr(K, ell):
    """Map CSR values into an ELL layout's flat value vector (the layout's
    pattern is a structural superset of K's by construction)."""
    K = K.tocsr()
    K.sort_indices()
    rows = np.repeat(np.arange(K.shape[0]), np.diff(K.indptr))
    slots = ell.lookup(rows, K.indices)
    vals = np.zeros(ell.n * ell.m, dtype=np.float32)
    vals[slots] = K.data
    return vals.reshape(ell.n, ell.m)


def build_mg_statics(mesh, V, bc_mask, K0_cell_elastic, *,
                     coarse_target=150, max_levels=8, smooth_sa=True,
                     cheb_degree=3, galerkin_levels=None, dia=False,
                     agg_reach=(1, 1)):
    """Build the fixed multigrid hierarchy (host, once per problem).

    Parameters
    ----------
    mesh, V : the framework mesh and displacement space (P1/P2 vector, 2D).
    bc_mask : (n_dofs,) bool Dirichlet mask.
    K0_cell_elastic : (nc, nk, nk) ELASTIC element stiffness blocks — the
        sparsity/aggregation/smoothing proxy for the evolving tangent.
    smooth_sa : Jacobi-smooth the aggregation prolongators against the
        frozen elastic operator (default True: fewer CG iterations at
        identical Newton counts, at the cost of larger Galerkin maps; the
        geometric P2->P1 transfer is never smoothed, it is already the
        exact nested interpolation).
    galerkin_levels : number of hierarchy levels below level 0 whose VALUES
        are recomputed from the current tangent every Newton iteration.
        ``None`` (default) = all of them.  ``1`` = only the P1 level tracks
        the tangent (cheap cell-local einsum); deeper levels keep FROZEN
        values Galerkin-projected from the ELASTIC operator at build time.
        The frozen levels only steer the smooth/coarse end of a
        preconditioner, so the cost is a few extra CG iterations while the
        per-Newton Galerkin sums AND the contribution maps disappear (the
        maps grow to most of the hierarchy's memory on large meshes).
    agg_reach : per-algebraic-level aggregation radius (last entry repeats
        for deeper levels).  1 = standard root-node aggregation; 2 =
        distance-2 (aggregate over G + G^2) for ~3-4x bigger aggregates —
        see the comment at the aggregation loop for when it pays.

    Returns a dict of HOST (numpy) arrays and static tuples; ``mg_plan``
    puts them on a device.
    """
    bs = V.bs
    if bs != _BS:
        raise NotImplementedError(
            "the mg hierarchy implements the 2D vector (rigid-body-mode) "
            f"case, bs == {_BS}; this space has bs == {bs}")
    n0 = V.num_dofs
    dm0 = V.unrolled_dofmap.astype(np.int64)
    bc_mask = np.asarray(bc_mask, dtype=bool)

    K0_raw = _csr_from_blocks(np.asarray(K0_cell_elastic, np.float64), dm0, n0)
    K0 = _eliminate_bc(K0_raw, bc_mask)

    # ---- internal lattice numbering (dia mode) ----------------------------
    # On lattice-structured meshes the level-0 AND level-1 operators become
    # stencil-banded in lexicographic numberings (see _dia_matvec): the
    # whole f32 inner iteration then runs in the lattice layout, with the
    # permutation paid only at the refinement-round boundary (ir_pcg
    # to_inner/from_inner).  Everything framework-facing keeps the
    # original numbering.  LEVEL-1 side: the hierarchy below level 0 is
    # simply BUILT in the permuted numbering (P0 columns, vdofs, RBM rows),
    # so ELL layouts, Galerkin maps and aggregation stay numbering-agnostic.
    dia_info = None
    perm1_l2o = perm1_o2l = None
    degree = V.element.degree
    if dia and degree in (1, 2):
        if degree == 2:
            node_xy = np.vstack([mesh.points[:, :2],
                                 mesh.points[mesh.edges, :2].mean(axis=1)])
        else:
            node_xy = mesh.points[:, :2]
        det0 = _lattice_node_perm(node_xy)
        det1 = det0 if degree == 1 else _lattice_node_perm(mesh.points[:, :2])
        if det0 is not None and det1 is not None:
            node_perm, shape0 = det0
            vert_perm, shape1 = det1
            perm0_l2o = (node_perm[:, None] * bs
                         + np.arange(bs)[None, :]).ravel()  # lattice dof -> orig dof
            perm0_o2l = np.empty(n0, np.int64)
            perm0_o2l[perm0_l2o] = np.arange(n0)
            coo = K0_raw.tocoo()
            offs = np.unique(perm0_o2l[coo.col] - perm0_o2l[coo.row])
            if offs.size <= 128:
                # contribution map: (cell, a, b) -> band(col-row)*n0 + row,
                # all in lattice numbering; every pair is structurally in
                # K0_raw by construction so the searchsorted always hits
                rlat = perm0_o2l[dm0]  # (nc, nk0)
                off_ab = rlat[:, None, :] - rlat[:, :, None]  # (nc, a, b): col-row
                band = np.searchsorted(offs, off_ab)
                dia0_dst = (band * np.int64(n0)
                            + rlat[:, :, None]).reshape(mesh.num_cells, -1)
                dia_info = {
                    "dia0_dst": dia0_dst.astype(np.int64 if offs.size * n0 > 2**31 - 1 else _I),
                    "perm0_l2o": perm0_l2o.astype(_I),
                    "perm0_o2l": perm0_o2l.astype(_I),
                    "mask0_lat": bc_mask[perm0_l2o],
                    "dia0_offsets": tuple(int(o) for o in offs),
                    "lat_shapes": (shape0, shape1),
                }
                perm1_l2o = (vert_perm[:, None] * bs
                             + np.arange(bs)[None, :]).ravel()
                perm1_o2l = np.empty(perm1_l2o.size, np.int64)
                perm1_o2l[perm1_l2o] = np.arange(perm1_l2o.size)

    # ---- transfer 0: geometric p-coarsening (P2 -> P1), cell-local -------
    if degree == 2:
        P0 = _p2_to_p1_interpolation(mesh, bs, bc_mask)
    elif degree == 1:
        P0 = _zero_rows(sp.eye(n0, format="csr"), bc_mask)
    else:
        raise NotImplementedError(f"mg hierarchy for degree-{degree} spaces")
    if dia_info is not None:
        # level-1 in its lattice numbering from here on down
        P0 = P0.tocsc()[:, perm1_l2o].tocsr()
    n1 = P0.shape[1]
    K1 = (P0.T @ K0 @ P0).tocsr()

    def _pattern(K, P=None):
        """Structural sparsity for the ELL layout: |P|^T |K| |P| with the
        diagonal forced in — immune to numerical cancellation/pruning and
        to zero rows from bc-zeroed interpolation (lookups never miss)."""
        A = abs(K.tocsr())
        if P is not None:
            Pa = abs(P.tocsr())
            A = Pa.T @ (A + sp.eye(A.shape[0])) @ Pa
        return (A + sp.eye(A.shape[1])).tocsr()

    # per-cell restriction weights: W[c] = P0[cell_dofs(c), cell_vertex_dofs(c)]
    # (nested interpolation => every row's support lies in the cell's vertices)
    vdofs = (np.repeat(mesh.cells.astype(np.int64) * bs, bs, axis=1)
             + np.tile(np.arange(bs), mesh.cells.shape[1]))  # (nc, nv_cell*bs)
    if dia_info is not None:
        vdofs = perm1_o2l[vdofs]
    nc = mesh.num_cells
    nk1 = vdofs.shape[1]
    P0_idx, P0_w = _padded_rows(P0)
    W01 = np.zeros((nc, dm0.shape[1], nk1))
    for a in range(P0_idx.shape[1]):
        tgt = P0_idx[dm0, a]  # (nc, nk0) interpolation targets
        wv = P0_w[dm0, a]
        W01 += (tgt[:, :, None] == vdofs[:, None, :]) * wv[:, :, None]
    assert np.allclose(np.abs(W01).sum(2), np.abs(P0_w[dm0]).sum(2)), \
        "P2->P1 interpolation is not cell-local"

    ell1 = _EllLayout(_pattern(K0, P0))
    # scatter map for the per-cell (nk1 x nk1) blocks into K1's ELL values;
    # pairs absent from the pattern (bc-zeroed) go to a dummy slot
    ii = np.repeat(vdofs, nk1, axis=1).ravel()
    jj = np.tile(vdofs, (1, nk1)).ravel()
    blk_dst = ell1.lookup(ii, jj, missing=n1 * ell1.m).reshape(nc, nk1 * nk1)

    levels = [{"cols": ell1.cols.astype(_I), "m": ell1.m, "n": n1,
               "diag_slot": ell1.diag_slot.astype(_I)}]
    transfers = [{"W": W01.astype(np.float32),
                  "blk_dst": blk_dst.astype(_I),
                  "nnz_flat": n1 * ell1.m,
                  "P_idx": P0_idx.astype(_I),
                  "P_w": P0_w.astype(np.float32)}]

    if dia_info is not None:
        # transfer-0 rows in lattice-0 order (restrict/prolong run on
        # lattice-layout level-0 vectors inside the cycle; their ENTRIES
        # are already lattice-1 via the permuted P0 columns)
        transfers[0]["P_idx"] = P0_idx[dia_info["perm0_l2o"]].astype(_I)
        transfers[0]["P_w"] = P0_w[dia_info["perm0_l2o"]].astype(np.float32)
        # 2:1 inter-grid stencil for gather-free transfers (None -> the
        # padded-row gather transfer above stays in use)
        shape0, shape1 = dia_info["lat_shapes"]
        t0s = _transfer0_stencil(P0[dia_info["perm0_l2o"]], shape0, shape1,
                                 bs, dia_info["mask0_lat"])
        if t0s is not None:
            dia_info["t0_stencil"] = t0s
        # level-1 DIA: band layout of the (lattice-numbered) ELL pattern;
        # per-Newton values re-scatter from the ELL value vector through a
        # fixed slot map (padded ELL slots hold zeros and alias the
        # diagonal band harmlessly)
        off1 = ell1.cols.astype(np.int64) - np.arange(n1, dtype=np.int64)[:, None]
        offs1 = np.unique(off1)
        if offs1.size <= 160:
            band1 = np.searchsorted(offs1, off1)
            dia1_dst = (band1 * np.int64(n1)
                        + np.arange(n1, dtype=np.int64)[:, None]).ravel()
            dia_info["dia1_dst"] = dia1_dst.astype(_I)
            dia_info["dia1_offsets"] = tuple(int(o) for o in offs1)

    # ---- aggregation levels ----------------------------------------------
    # near-nullspace at the P1 level: 2D rigid-body modes, zeroed on bc
    # (P1 vertex dofs share their indices with the fine vertex dofs)
    pts = mesh.points
    B = np.zeros((n1, 3))
    B[0::bs, 0] = 1.0
    B[1::bs, 1] = 1.0
    B[0::bs, 2] = -(pts[:, 1] - pts[:, 1].mean())
    B[1::bs, 2] = pts[:, 0] - pts[:, 0].mean()
    B[bc_mask[:n1], :] = 0.0
    if dia_info is not None:
        B = B[perm1_l2o]  # rows follow the lattice level-1 numbering

    K_l, B_l, bs_l, ell_l = K1, B, bs, ell1
    while levels[-1]["n"] > coarse_target and len(levels) < max_levels:
        G = _block_graph(K_l, bs_l)
        reach = agg_reach[min(len(levels) - 1, len(agg_reach) - 1)]
        if reach == 2:
            # distance-2 aggregation: ~3-4x bigger aggregates shrink the
            # next level under the dense-matvec threshold (_DENSE_BELOW)
            # so it runs dense matvecs instead of ELL.  Opt-in
            # (mg_opts={'agg_reach': (2, 1)}), not the default: it costs CG
            # iterations, and the threshold already captures the first
            # algebraic level of the slope problem up to 100x100.
            G = ((G + G @ G) > 0).tocsr()
        agg, n_agg = _aggregate(G)
        T, Bc = _tentative_rbm(agg, n_agg, B_l, bs_l)
        if smooth_sa:
            d = K_l.diagonal()
            d = np.where(np.abs(d) > 1e-300, d, 1.0)
            P = (T - (4.0 / (3.0 * _lmax_dinv_a(K_l))) * (sp.diags(1.0 / d) @ (K_l @ T))).tocsr()
        else:
            P = T
        K_c = (P.T @ K_l @ P).tocsr()
        n_c = K_c.shape[0]
        if n_c >= levels[-1]["n"]:
            break  # aggregation stalled
        ell_c = _EllLayout(_pattern(K_l, P))
        P_idx, P_w = _padded_rows(P)
        t = {"P_idx": P_idx.astype(_I), "P_w": P_w.astype(np.float32)}
        blk = _block_transfer_forms(P, bs_l, 3)
        if blk is not None:
            t.update(blk)
        lvl = {"cols": ell_c.cols.astype(_I), "m": ell_c.m, "n": n_c,
               "diag_slot": ell_c.diag_slot.astype(_I)}
        if galerkin_levels is None or len(levels) < galerkin_levels:
            src, wgt, dst = _galerkin_contrib_map(ell_l, P, ell_c)
            t.update({"src": src, "w": wgt.astype(np.float32), "dst": dst,
                      "nnz_flat": n_c * ell_c.m})
        else:
            lvl["frozen_vals"] = _ell_vals_from_csr(K_c, ell_c)
        transfers.append(t)
        levels.append(lvl)
        K_l, B_l, bs_l, ell_l = K_c, Bc, 3, ell_c

    # strip static ints: device functions derive (n, m) from `cols` shapes,
    # so the returned pytree is arrays-only (shard_map-spec friendly)
    nL, mL = levels[-1]["n"], levels[-1]["m"]
    for lvl in levels:
        lvl.pop("n"), lvl.pop("m")
    for t in transfers:
        t.pop("nnz_flat", None)
    out = {
        "levels": levels,
        "transfers": transfers,
        "coarse_rows": np.tile(np.arange(nL, dtype=_I)[:, None], (1, mL)),
        "cheb_degree": cheb_degree,
    }
    if dia_info is not None:
        out.update(dia_info)
    return out


# ======================================================================
# Host plan of the device part (tensors and gather tables, once per problem)
# ======================================================================

def _one_device(x):
    """The ``whole`` of one device: its cells are every cell."""
    return x


def ebe_plan(dofmap, bc_mask, n, device, mode="scalar", whole=None, dofmap_all=None):
    """Gather/scatter layout of ``ebe_matvec`` on ``device``.

    ``dofmap`` is the (nc, nk) unrolled dof array of the cells whose
    products this device computes (padded cells: the dummy index ``n``),
    a rank's cells where sharded.  ``whole`` then makes every rank's
    products whole (``dist.cell_sum``) and ``dofmap_all``, the dofs of
    every cell in that order (padded cells: ``n``, which the sum drops),
    is the scatter's table (defaults: one device, ``dofmap``).
    ``"scalar"`` gathers and scatters per dof; ``"node"`` per node,
    ``_BS`` components at a time (the unrolled-dofmap convention ``dof =
    node * _BS + component``)."""
    if mode not in ("scalar", "node"):
        raise ValueError(f"ebe_matvec mode must be 'scalar' or 'node', got {mode!r} "
                         "(the banded layout is mg_plan(mv0_mode='dia'))")
    dofmap = np.asarray(dofmap, dtype=np.int64)
    dofmap_all = dofmap if dofmap_all is None else np.asarray(dofmap_all, dtype=np.int64)
    if mode == "node":
        # padded rows -> the dummy node
        idx, seg, n_seg = dofmap[:, ::_BS] // _BS, dofmap_all[:, ::_BS] // _BS, n // _BS
    else:
        idx, seg, n_seg = dofmap, dofmap_all, n
    return {"mode": mode, "whole": whole or _one_device,
            "free": torch.as_tensor(~np.asarray(bc_mask, dtype=bool), device=device),
            "idx": torch.tensor(idx, device=device),
            "table": torch.as_tensor(segment_table(seg, n_seg), device=device)}


def _transfer_plan(tr, n_c, nnz_c, device):
    """Device form of one prolongator: the padded-row form (``P_idx``,
    ``P_w``) and the gather table of its transpose, the block gather forms
    where the hierarchy has them, and the Galerkin contribution map."""
    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    P_idx, P_w = np.asarray(tr["P_idx"], np.int64), np.asarray(tr["P_w"])
    out = {"P_idx": t(P_idx, torch.int64), "P_w": t(P_w, _F32),
           # zero-weight (padding) entries add nothing; leave them out
           "R_table": t(segment_table(np.where(P_w != 0.0, P_idx, -1), n_c), torch.int64)}
    for fwd in ("Rb", "Pb"):
        if f"{fwd}_idx" in tr:
            w = np.asarray(tr[f"{fwd}_w"])
            nrb, bs_r, k, bs_c = w.shape
            out[f"{fwd}_idx"] = t(tr[f"{fwd}_idx"], torch.int64)
            out[f"{fwd}_w"] = t(w.reshape(nrb, bs_r, k * bs_c), _F32)
            out[f"{fwd}_bs"] = bs_c
    if "src" in tr:
        out.update(src=t(tr["src"], torch.int64), w=t(tr["w"], _F32),
                   dst=dedup_table(tr["dst"], nnz_c, device))
    return out


def _band_plan(offsets, dst, n, device):
    """Banded operator of ``len(offsets)`` bands over ``n`` rows: the
    scatter of its values (``dst`` into ``nb * n`` slots) and the rows of
    the padded vector's sliding window that each band reads."""
    offsets = tuple(int(o) for o in offsets)
    w = max(max(abs(o) for o in offsets), 1)
    return {"nb": len(offsets), "w": w, "diag": offsets.index(0) if 0 in offsets else None,
            "sel": torch.as_tensor(np.asarray(offsets, np.int64) + w, device=device),
            "vals": dedup_table(dst, len(offsets) * n, device)}


def _stencil_plan(stencil, shape0, shape1, bs, mask0_lat, device):
    """Gather tables of the 2:1 stencil transfers (``_transfer0_stencil``):
    ``r_c[J, I, c] = sum_t w_t r_f[2J + dj_t, 2I + di_t, c]`` over the
    in-range free fine dofs, and ``x_f[y, x, c] = sum w_t x_c[(y - dj_t)/2,
    (x - di_t)/2, c]`` over the taps of the fine dof's parity class (zero on
    bc dofs).  Taps that fall outside the grid or on a bc dof point at an
    appended zero."""
    ny0, nx0 = shape0
    ny1, nx1 = shape1
    n0, n1 = ny0 * nx0 * bs, ny1 * nx1 * bs
    free0 = ~np.asarray(mask0_lat, dtype=bool)
    J, I, C = (a.ravel() for a in np.meshgrid(np.arange(ny1), np.arange(nx1), np.arange(bs),
                                               indexing="ij"))
    r_idx = np.full((len(stencil), n1), n0, dtype=np.int64)
    for k, (dj, di, _) in enumerate(stencil):
        y, x = 2 * J + dj, 2 * I + di
        f = np.flatnonzero((y >= 0) & (y < ny0) & (x >= 0) & (x < nx0))
        src = (y[f] * nx0 + x[f]) * bs + C[f]
        keep = free0[src]
        r_idx[k, f[keep]] = src[keep]
    Y, X, C0 = (a.ravel() for a in np.meshgrid(np.arange(ny0), np.arange(nx0), np.arange(bs),
                                                indexing="ij"))
    p_idx = np.full((len(stencil), n0), n1, dtype=np.int64)
    p_w = np.zeros((len(stencil), n0), dtype=np.float32)
    cnt = np.zeros(n0, dtype=np.int64)
    for dj, di, w in stencil:
        y, x = Y - dj, X - di
        f = np.flatnonzero(free0 & (y % 2 == 0) & (x % 2 == 0) & (y >= 0) & (y < 2 * ny1)
                           & (x >= 0) & (x < 2 * nx1))
        p_idx[cnt[f], f] = (y[f] // 2 * nx1 + x[f] // 2) * bs + C0[f]
        p_w[cnt[f], f] = w
        cnt[f] += 1
    taps = max(int(cnt.max(initial=0)), 1)
    return {"r_idx": torch.as_tensor(r_idx, device=device),
            "r_w": torch.tensor([[w] for *_, w in stencil], dtype=_F32, device=device),
            "p_idx": torch.as_tensor(p_idx[:taps], device=device),
            "p_w": torch.as_tensor(p_w[:taps], device=device)}


def mg_plan(mgs, dofmap, bc_mask, device, *, whole=None, dofmap_all=None, mv0_mode="scalar",
            dia_offsets=None, dia1_offsets=None, t0_stencil=None, lat_shapes=None,
            cheb_degree=3):
    """The hierarchy ``mgs`` (the arrays of ``build_mg_statics``) on
    ``device``, with the gather tables of every per-Newton scatter, built
    once on the host.

    ``dofmap`` and ``transfers[0]["W"]`` cover the cells whose
    contributions this device computes: all of them, or a rank's.
    ``whole`` makes every rank's contributions whole (``dist.cell_sum``;
    default: one device), and the tables sum them over every cell in that
    order: ``dofmap_all`` (default ``dofmap``), ``transfers[0]["blk_dst"]``
    and ``dia0_dst`` (padded cells: an index past the end, which the sums
    drop).

    ``mv0_mode``: the level-0 layout: ``"scalar"`` or ``"node"`` for the
    element-blocked matvec (``ebe_matvec``), ``"dia"`` for the banded
    lattice operator (needs ``dia_offsets`` and the hierarchy's ``dia0_dst``,
    ``mask0_lat`` and permutations; level-0 vectors of the cycle are then in
    the lattice numbering).  In dia mode, ``dia1_offsets`` makes level 1
    banded too and ``t0_stencil``/``lat_shapes`` give the stencil
    transfers.  Levels of at most ``_DENSE_BELOW`` dofs run dense matvecs;
    ``cheb_degree`` is the smoother's."""
    if mv0_mode == "dia" and dia_offsets is None:
        raise ValueError("mv0_mode='dia' requires the band offsets of build_mg_statics(dia=True)")
    dev = device
    bc_mask = np.asarray(bc_mask, dtype=bool)
    n0 = bc_mask.size
    dofmap = np.asarray(dofmap, dtype=np.int64)
    dofmap_all = dofmap if dofmap_all is None else np.asarray(dofmap_all, dtype=np.int64)
    levels, transfers = mgs["levels"], mgs["transfers"]
    whole = whole or _one_device
    plan = {"n0": n0, "mode": mv0_mode, "cheb_degree": int(cheb_degree), "whole": whole,
            "ebe": ebe_plan(dofmap, bc_mask, n0, dev, "scalar" if mv0_mode == "scalar" else "node",
                            whole, dofmap_all)}
    if mv0_mode == "dia":
        plan["dia0"] = _band_plan(dia_offsets, mgs["dia0_dst"], n0, dev)
        for k in ("mask0_lat", "perm0_l2o", "perm0_o2l"):
            plan[k] = torch.tensor(np.asarray(mgs[k]), device=dev)
        plan["perm0_l2o"], plan["perm0_o2l"] = plan["perm0_l2o"].long(), plan["perm0_o2l"].long()
        plan["dia0"]["free"] = ~plan["mask0_lat"]
        if t0_stencil is not None:
            plan["stencil"] = _stencil_plan(t0_stencil, *lat_shapes, _BS, mgs["mask0_lat"], dev)
    else:
        plan["d0"] = torch.as_tensor(segment_table(dofmap_all, n0), device=dev)

    lv = []
    for i, lvl in enumerate(levels):
        cols = np.asarray(lvl["cols"], dtype=np.int64)
        n = cols.shape[0]
        e = {"n": n, "cols": torch.as_tensor(cols, device=dev),
             "diag_slot": torch.as_tensor(np.asarray(lvl["diag_slot"], np.int64), device=dev)}
        if "frozen_vals" in lvl:
            e["frozen_vals"] = torch.tensor(np.asarray(lvl["frozen_vals"]), dtype=_F32,
                                            device=dev)
        if i == 0 and mv0_mode == "dia" and dia1_offsets is not None:
            e["kind"], e["dia"] = "dia", _band_plan(dia1_offsets, mgs["dia1_dst"], n, dev)
        else:
            e["kind"] = "dense" if n <= _DENSE_BELOW else "ell"
        if e["kind"] == "dense" or i == len(levels) - 1:
            # the (n, n) matrix from the ELL values; padded ELL slots hold
            # zeros and alias the row's diagonal
            e["dense"] = dedup_table(np.arange(n)[:, None] * n + cols, n * n, dev)
        lv.append(e)
    plan["levels"] = lv
    t0 = transfers[0]
    plan["transfers"] = [dict(_transfer_plan(t0, lv[0]["n"], None, dev),
                              W=torch.tensor(np.asarray(t0["W"]), dtype=_F32, device=dev),
                              blk=dedup_table(t0["blk_dst"], lv[0]["cols"].numel(), dev))]
    plan["transfers"] += [_transfer_plan(tr, lv[k]["n"], lv[k]["cols"].numel(), dev)
                          for k, tr in enumerate(transfers[1:], start=1)]
    return plan


# ======================================================================
# Device-side per-Newton setup + cycle
# ======================================================================

def _ell_matvec(vals, cols, x):
    return (vals * x[cols]).sum(1)


def _dia_matvec(bands, band, free_lat, x):
    """Banded (DIA) matvec in lattice numbering: ``bands`` (nb, n), band k
    holding A[r, r + offsets[k]] at slot r.  The padded vector's sliding
    window (a view) gives every band's shifted copy of x by one row
    selection; a multiply and a sum over bands follow.  With ``free_lat``
    the bc rows are identity rows (the band values must come from
    bc-masked element blocks, as for ``ebe_matvec``); without it (coarse
    levels) the plain matvec."""
    n, w = x.shape[0], band["w"]
    xs = F.pad(x, (w, w)).unfold(0, n, 1).index_select(0, band["sel"])
    out = (bands * xs).sum(0)
    if free_lat is None:
        return out
    return torch.where(free_lat, out, x)


def _stencil_restrict(st, r_f):
    """r_c = P0^T r_f through the stencil's gather table."""
    return (st["r_w"] * F.pad(r_f, (0, 1))[st["r_idx"]]).sum(0)


def _stencil_prolong(st, x_c):
    """x_f = P0 x_c through the stencil's gather table (zero on bc dofs)."""
    return (st["p_w"] * F.pad(x_c, (0, 1))[st["p_idx"]]).sum(0)


def _power_lmax(matvec, dinv, n):
    """lambda_max(D^-1 A) by fixed-count power iteration (deterministic
    start vector; overestimation is safe for Chebyshev: add 10%).  No host
    read."""
    x = torch.cos(1.234 * torch.arange(n, dtype=_F32, device=dinv.device))
    lam = torch.ones((), dtype=_F32, device=dinv.device)
    for _ in range(_POWER_ITERS):
        y = dinv * matvec(x)
        lam = torch.linalg.vector_norm(y)
        x = y / torch.clamp(lam, min=1e-30)
    return 1.1 * lam


def ebe_matvec(K_blocks, plan, free=None):
    """Element-blocked matvec ``x -> A x`` with IDENTITY rows on bc dofs,
    in ``K_blocks.dtype``; ``plan`` is ``ebe_plan``'s.  ``free`` (a bool
    tensor over the dofs) replaces the plan's free dofs for this operator:
    the general pipeline eliminates a per-call set (Dirichlet dofs plus a
    bound-constrained Newton's active set) on a plan built once.

    The identity-bc-row invariant is load-bearing: a zero bc row makes the
    (f32) system singular, and a nonzero bc component of a refinement
    residual (e.g. ~1e-8 on bc rows after a load step re-initialises Du)
    becomes an irreducible direction on which the inner CG stagnates.
    With identity rows the bc block is a perfectly conditioned sub-problem.
    ``K_blocks`` (nc, nk, nk) must already be bc-masked by the caller."""
    dt = K_blocks.dtype
    idx, table, whole = plan["idx"], plan["table"], plan["whole"]
    free = plan["free"] if free is None else free
    if plan["mode"] == "node":
        def mv(x):
            y = ec.ebe_cell_matvec(K_blocks, idx, torch.where(free, x, 0.0).to(dt), _BS)
            out = F.pad(whole(y).view(-1, _BS), (0, 0, 0, 1))[table].sum(1).view(-1)
            return torch.where(free, out, x.to(dt))
    else:
        def mv(x):
            y = whole(ec.ebe_cell_matvec(K_blocks, idx, torch.where(free, x, 0.0).to(dt), 1))
            return torch.where(free, segment_sum(y.view(-1), table), x.to(dt))
    return mv


def _cheb_coeffs(lmax, degree):
    """Coefficients of the degree-``degree`` Chebyshev/Jacobi smoother on
    [_LMIN_FRAC * lmax, lmax]: theta, and per further step (the old
    direction's weight, the new residual's)."""
    lmin = _LMIN_FRAC * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    steps = []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        steps.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, steps


def _chebyshev(matvec, dinv, b, x0, coeffs):
    """Fixed-degree Chebyshev/Jacobi smoothing (a FIXED linear operator of
    (b, x0)).  ``x0=None`` means a zero initial guess: the first residual
    is ``b`` and its matvec is skipped.  On the card the vector updates
    between two matvecs are one kernel (``_chebyshev_fused``), on the CPU
    the torch chain."""
    if b.is_cuda:
        return _chebyshev_fused(matvec, dinv, b, x0, coeffs, mgc.chebyshev_step)
    return _chebyshev_reference(matvec, dinv, b, x0, coeffs)


def _chebyshev_fused(matvec, dinv, b, x0, coeffs, step):
    """``_chebyshev_reference``'s operations and bits, each launch between
    two matvecs one call of ``step`` (``mg_cycle.chebyshev_step``, or its
    g++ build on the CPU): r, d and x in buffers of the call's own,
    updated in place; ``b`` and ``x0`` are only read.  The coefficients
    are read where ``mg_setup`` keeps them."""
    theta, steps = coeffs
    r, d, x = (torch.empty_like(b) for _ in range(3))
    if x0 is None:
        step(0, dinv, b, None, None, None, d, x, theta)
        r_in = b
    else:
        step(1, dinv, b, matvec(x0), x0, r, d, x, theta)
        r_in = r
    for c_old, c_new in steps:
        step(2, dinv, r_in, matvec(d), x, r, d, x, c_old, c_new)
        r_in = r
    return x


def _chebyshev_reference(matvec, dinv, b, x0, coeffs):
    """``_chebyshev`` as torch ops, one launch an operation on the card."""
    theta, steps = coeffs
    if x0 is None:
        r = b
        d = dinv * r / theta
        x = d
    else:
        r = b - matvec(x0)
        d = dinv * r / theta
        x = x0 + d
    for c_old, c_new in steps:
        r = r - matvec(d)
        d = c_old * d + c_new * (dinv * r)
        x = x + d
    return x


def mg_setup(plan, K0_cell_f32, free=None, out=None):
    """Per-Newton values: level-0 operator and diagonal, coarse values
    (level 1 by the per-cell triple product, deeper levels by their
    Galerkin maps or frozen), Jacobi diagonals, Chebyshev bounds, the
    coarsest level's explicit inverse.  All f32, no host read.

    ``K0_cell_f32`` (nc, nk, nk): bc-masked element blocks.  In dia mode
    the level-0 runtime vectors are in the lattice numbering.  ``free``:
    the level-0 element-blocked matvec's free dofs for this call
    (``ebe_matvec``; scalar and node mode), the hierarchy's otherwise.

    ``out``: an earlier call's result on the same plan, ``K0_cell_f32``
    and ``free`` (the same tensors, holding this call's values): its
    tensors take this call's values in place and it is returned, so that
    its matvecs, and a CUDA graph of a cycle captured over it, read the
    new hierarchy."""
    levels, transfers, whole = plan["levels"], plan["transfers"], plan["whole"]
    n0, degree = plan["n0"], plan["cheb_degree"]
    if plan["mode"] == "dia":
        band = plan["dia0"]
        vals0 = dedup_write(whole(K0_cell_f32).reshape(-1), band["vals"]).view(band["nb"], n0)
        d0 = vals0[band["diag"]]

        def mv0(x):
            return _dia_matvec(vals0, band, band["free"], x)
    else:
        d0 = segment_sum(whole(torch.diagonal(K0_cell_f32, dim1=1, dim2=2)).reshape(-1),
                         plan["d0"])
        mv0 = ebe_matvec(K0_cell_f32, plan["ebe"], free)
    d0 = torch.where(d0.abs() > 1e-30, d0, 1.0)
    dinv0 = 1.0 / d0
    rt = {"d0": d0, "dinv0": dinv0, "mv0": mv0, "lmax0": _power_lmax(mv0, dinv0, n0),
          "vals0": vals0 if plan["mode"] == "dia" else None}
    rt["cheb0"] = _cheb_coeffs(rt["lmax0"], degree)

    # level 1: per-cell triple product (E5 twice, (W^T K) W in a fixed
    # order: a rank's cells give the whole batch's bits), scattered into
    # the ELL values
    t0 = transfers[0]
    blocks = ec.cell_triple(t0["W"], K0_cell_f32)
    lvl_vals = [dedup_write(whole(blocks).reshape(-1), t0["blk"]).view(levels[0]["cols"].shape)]
    # deeper levels: Galerkin contribution maps, or frozen elastic values
    for t, lvl in zip(transfers[1:], levels[1:]):
        if "src" not in t:
            lvl_vals.append(lvl["frozen_vals"])
            continue
        prev = lvl_vals[-1].reshape(-1)
        lvl_vals.append(dedup_write(prev[t["src"]] * t["w"], t["dst"]).view(lvl["cols"].shape))
    rt["vals"] = lvl_vals

    rt["dinvs"], rt["lmaxs"], rt["chebs"], rt["mvs"], rt["level_ops"] = [], [], [], [], []
    dense = None
    for lvl, vals in zip(levels, lvl_vals):
        d = vals.reshape(-1)[lvl["diag_slot"]]
        dinv = 1.0 / torch.where(d.abs() > 1e-30, d, 1.0)
        n = lvl["n"]
        if lvl["kind"] == "dia":
            # level 1 banded: the smoothing matvecs run on band values
            # re-scattered from the ELL values once per Newton (padded ELL
            # slots hold zeros and alias the diagonal band); no identity
            # rows, as the ELL matvec
            band1 = lvl["dia"]
            op = dedup_write(vals.reshape(-1), band1["vals"]).view(band1["nb"], n)
            mv = (lambda v, b: lambda x: _dia_matvec(v, b, None, x))(op, band1)
        elif lvl["kind"] == "dense":
            dense = op = dedup_write(vals.reshape(-1), lvl["dense"]).view(n, n)
            mv = dense.mv
        else:
            op = vals
            mv = (lambda v, c: lambda x: _ell_matvec(v, c, x))(vals, lvl["cols"])
        lmax = _power_lmax(mv, dinv, n)
        rt["dinvs"].append(dinv)
        rt["lmaxs"].append(lmax)
        rt["chebs"].append(_cheb_coeffs(lmax, degree))
        rt["mvs"].append(mv)
        rt["level_ops"].append(op)

    # coarsest level: explicit f32 inverse (the W-cycle applies it several
    # times per cycle as one matvec); zero rows (dofs supported by bc
    # dofs only) get a unit diagonal
    last = levels[-1]
    if last["kind"] != "dense":
        dense = dedup_write(lvl_vals[-1].reshape(-1), last["dense"]).view(last["n"], last["n"])
    dL = torch.diagonal(dense)
    rt["coarse_inv"] = torch.linalg.inv(dense + torch.diag(1.0 - (dL.abs() > 1e-30).to(_F32)))
    if out is None:
        return rt
    for old, new in zip(_tensors(out), _tensors(rt)):
        old.copy_(new)
    return out


def _tensors(tree):
    """The tensors of ``mg_setup``'s result in a fixed order (its matvecs,
    closures over some of them, are skipped)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _restrict(t, r_f):
    if "Rb_idx" in t:
        # block gather form of P^T: gather fine node blocks per coarse block
        g = r_f.view(-1, t["Rb_bs"])[t["Rb_idx"]]              # (n_cb, M, bs_f)
        return torch.bmm(t["Rb_w"], g.view(g.shape[0], -1, 1)).view(-1)
    return segment_sum((t["P_w"] * r_f[:, None]).view(-1), t["R_table"])


def _prolong(t, x_c):
    if "Pb_idx" in t:
        g = x_c.view(-1, t["Pb_bs"])[t["Pb_idx"]]              # (n_fb, K, bs_c)
        return torch.bmm(t["Pb_w"], g.view(g.shape[0], -1, 1)).view(-1)
    return (t["P_w"] * x_c[t["P_idx"]]).sum(1)


def _pcg_iterations(mv32, M32, state, n):
    """``n`` iterations of ``ir_pcg``'s f32 PCG from ``state`` (``x``,
    ``r``, ``p``, ``rz``, ``nb``, ``xb``), reading nothing back: the state
    after them, each iteration's loop test (n, 3: ``good``, the residual
    norm, ``better``) and each iteration's best iterate (n, len).  On the
    card the elementwise and scalar work of an iteration is two kernels
    (``_pcg_iterations_fused``), on the CPU the torch chain."""
    if state["r"].is_cuda:
        return _pcg_iterations_fused(mv32, M32, state, n, mgc.pcg_xr, mgc.pcg_p)
    return _pcg_iterations_reference(mv32, M32, state, n)


def _pcg_iterations_fused(mv32, M32, state, n, xr, pz):
    """``_pcg_iterations_reference``'s operations and bits with ``xr``
    (``mg_cycle.pcg_xr``: alpha, x, r) after ``A p`` and ``p . A p``, and
    ``pz`` (``mg_cycle.pcg_p``: beta, p, the best iterate, the best norm
    and the test row) after the cycle, ``r . z`` and ``|r|`` (or their g++
    builds on the CPU).  The dots and the norm stay torch's.  x, r and p
    lie in buffers of the call's own, updated in place; each iteration
    writes its best iterate, best norm and test row straight into its
    slot of the results; ``state`` is only read."""
    x, r, p, rz, nb, xb = (state[k] for k in ("x", "r", "p", "rz", "nb", "xb"))
    xo, ro, po = (torch.empty_like(r) for _ in range(3))
    xbs = r.new_empty((n, r.shape[0]))
    tests, nbs = r.new_empty((n, 3)), r.new_empty(n)
    for j in range(n):
        Ap = mv32(p)
        pAp = torch.dot(p, Ap)
        xr(pAp, rz, x, r, p, Ap, xo, ro)
        x, r = xo, ro
        z = M32(r)
        rz2 = torch.dot(r, z)
        nn = torch.linalg.vector_norm(r)
        pz(pAp, rz, rz2, nn, nb, z, p, x, xb, po, xbs[j], nbs[j], tests[j])
        p, xb, nb, rz = po, xbs[j], nbs[j], rz2
    return {"x": x, "r": r, "p": p, "rz": rz, "nb": nb, "xb": xb}, tests, xbs


def _pcg_iterations_reference(mv32, M32, state, n):
    """``_pcg_iterations`` as torch ops, some thirty launches an iteration
    besides the matvec and the cycle on the card."""
    x, r, p, rz, nb, xb = (state[k] for k in ("x", "r", "p", "rz", "nb", "xb"))
    tests, xbs = [], []
    for _ in range(n):
        Ap = mv32(p)
        pAp = torch.dot(p, Ap)
        good = torch.isfinite(pAp) & (pAp > 0.0) & torch.isfinite(rz) & (rz > 0.0)
        alpha = torch.where(good, rz / torch.where(pAp > 0.0, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M32(r)
        rz2 = torch.dot(r, z)
        beta = torch.where(rz > 0.0, rz2 / torch.where(rz > 0.0, rz, 1.0), 0.0)
        p = z + beta * p
        nn = torch.linalg.vector_norm(r)
        better = nn < nb
        xb = torch.where(better, x, xb)
        nb = torch.where(better, nn, nb)
        good = good & torch.isfinite(nn) & (nn < 100.0 * nb)
        rz = rz2
        tests.append(torch.stack([good.to(_F32), nn, better.to(_F32)]))
        xbs.append(xb)
    state = {"x": x, "r": r, "p": p, "rz": rz, "nb": nb, "xb": xb}
    return state, torch.stack(tests), torch.stack(xbs)


def _pcg_start(M32, r):
    """The f32 PCG's first preconditioned residual: ``z``, ``r . z``,
    ``|r|`` and the loop's first test (``r . z >= 0``, ``|r|``)."""
    z = M32(r)
    rz = torch.dot(r, z)
    nb = torch.linalg.vector_norm(r)
    return z, rz, nb, torch.stack([(rz >= 0.0).to(_F32), nb])


def ir_pcg(mv64, mv32, M32, b, rtol, maxiter, *, atol=0.0, to_inner=None, from_inner=None,
           graphs=None):
    """Mixed-precision solve: f32 PCG rounds inside f64 iterative
    refinement.  Each round solves ``A dx = r`` in f32 (``mv32``, ``M32``)
    to the tolerance that reaches the outer target ``max(rtol * |b|,
    atol)`` (PETSc's KSP convention) in this round, floored at
    ``_INNER_FLOOR``, and re-evaluates the residual with the exact f64
    operator ``mv64``.

    ``to_inner``/``from_inner``: layout maps applied at the round boundary;
    the f32 iteration then runs in the inner layout (the DIA lattice
    numbering) while ``mv64`` and the result stay in the caller's.

    The f32 iterations run in batches of 1, 2, 4, then ``_READ_BATCH``,
    each batch's loop tests read in one host read (where a test ends the
    loop inside a batch, the best iterate of that iteration is the result:
    the iterations after it change nothing returned), and one more read
    per round.  ``graphs``: a dict the caller keeps, where ``mv32`` and
    ``M32`` read nothing but tensors that outlive it; each batch, and each
    round's first cycle, is then captured there at its first use (by the
    batch's size, and as ``"start"``; ``utils.graphs.capture``) and
    replayed after.  Counts ``solve.rounds`` and the f32 iterations as
    ``solve.inner``.  Returns (x_best, total_inner_iterations)."""
    to_inner = to_inner or (lambda v: v)
    from_inner = from_inner or (lambda v: v)
    bnorm = host_read(torch.linalg.vector_norm(b))
    target = max(rtol * bnorm, atol)

    def call(key, fn, *args):
        """``fn(*args)``, replayed from ``graphs[key]`` where given."""
        if graphs is None:
            return fn(*args)
        if key not in graphs:
            graphs[key] = capture(fn, *args)
        return graphs[key](*args)

    def pcg32(r32, tgt, budget):
        """Safeguarded f32 PCG on A dx = r32 down to |r| <= tgt.  Exits on
        the target, the budget, SPD breakdown, divergence past 100x the
        best residual, or stagnation (no new best iterate within
        ``_STALL_WINDOW`` iterations).  The iterate returned is a copy: a
        graph's outputs are overwritten by its next replay."""
        z, rz, nb, test = call("start", _pcg_start, M32, r32)
        ok, ncur = host_read(test, torch.Tensor.tolist)
        x = torch.zeros_like(r32)
        state = {"x": x, "r": r32, "p": z, "rz": rz, "nb": nb, "xb": x}
        k, k_best, batch = 0, 0, 1
        while ok and ncur > tgt and k < budget and k - k_best < _STALL_WINDOW:
            n = min(batch, budget - k)
            state, tests, xbs = call(n, _pcg_iterations, mv32, M32, state, n)
            for j, (ok, ncur, is_better) in enumerate(host_read(tests, torch.Tensor.tolist)):
                k += 1
                if is_better:
                    k_best = k
                if not (ok and ncur > tgt and k < budget and k - k_best < _STALL_WINDOW):
                    return xbs[j].clone(), k
            batch = min(2 * batch, _READ_BATCH)
        return state["xb"].clone(), k

    x = torch.zeros_like(b)
    r64, rnorm, k_tot, rounds, ok = b, bnorm, 0, 0, True
    xb, nbest = x, bnorm
    while ok and rnorm > target and rounds < _MAX_ROUNDS and k_tot < maxiter:
        # inner tolerance: enough to reach the outer target in this round,
        # floored at the f32 attainable range
        t_rel = min(max(target / max(rnorm, 1e-300), _INNER_FLOOR), 0.5)
        with span("deo.solve.round"):
            dx, k = pcg32(to_inner(r64.to(_F32)), float(np.float32(t_rel * rnorm)),
                          min(maxiter - k_tot, _INNER_CAP))
            x = x + from_inner(dx).to(b.dtype)
            r64 = b - mv64(x)
            rn = host_read(torch.linalg.vector_norm(r64))
        count("solve.rounds")
        count("solve.inner", k)
        if rn < nbest:
            xb, nbest = x, rn
        ok = np.isfinite(rn) and rn < rnorm  # stop when a round stalls
        rnorm, k_tot, rounds = rn, k_tot + k, rounds + 1
    return xb, k_tot


def vcycle(plan, rt, r0, *, gamma_coarse=(1, 2)):
    """One multigrid cycle as a preconditioner application z = M^-1 r0
    (f32 in and out).

    ``gamma_coarse``: cycle index below each level, an int (uniform) or a
    tuple indexed by level (the last entry repeats).  The default ``(1, 2)``
    visits level 2 once and W-cycles below it, where the dense small-level
    matvecs make repeat visits cheap.  With the plan's stencil transfers,
    level-0 vectors are in the DIA lattice numbering."""
    levels, transfers = plan["levels"], plan["transfers"]
    L = len(levels)
    gammas = (gamma_coarse,) if isinstance(gamma_coarse, int) else tuple(gamma_coarse)

    def level_solve(k, r):
        """Approximate solve at level k (1-based; levels[k - 1])."""
        if k == L:
            return rt["coarse_inv"] @ r
        mv, dinv, cheb = rt["mvs"][k - 1], rt["dinvs"][k - 1], rt["chebs"][k - 1]
        x = _chebyshev(mv, dinv, r, None, cheb)
        r_c = _restrict(transfers[k], r - mv(x))
        x_c = level_solve(k + 1, r_c)
        for _ in range(gammas[min(k - 1, len(gammas) - 1)] - 1):
            x_c = x_c + level_solve(k + 1, r_c - rt["mvs"][k](x_c))
        x = x + _prolong(transfers[k], x_c)
        return _chebyshev(mv, dinv, r, x, cheb)

    mv0, dinv0, cheb0 = rt["mv0"], rt["dinv0"], rt["cheb0"]
    st = plan.get("stencil")
    x0 = _chebyshev(mv0, dinv0, r0, None, cheb0)
    resid = r0 - mv0(x0)
    r1 = _restrict(transfers[0], resid) if st is None else _stencil_restrict(st, resid)
    x1 = level_solve(1, r1) if L > 1 else rt["coarse_inv"] @ r1
    x0 = x0 + (_prolong(transfers[0], x1) if st is None else _stencil_prolong(st, x1))
    return _chebyshev(mv0, dinv0, r0, x0, cheb0)


class AMGCG:
    """The AMG-CG solve of both Newton loops: ``ir_pcg`` with one cycle
    (``vcycle``) per f32 iteration, over a workspace kept for the solver's
    life.

    ``plan``: ``mg_plan``'s.  ``device_mesh``: the ranks whose cells the
    plan's sums make whole (``None``: one device).  ``secondary``: the
    ``ebe_plan``s of further cell batches of the operator (the general
    path's), whose f32 matvecs add to level 0's, each less the identity it
    puts on the masked rows.  ``gamma_coarse``: the cycle's.

    ``setup`` writes an update's f32 element blocks and mask into the
    workspace and the hierarchy's values over them (``mg_setup(...,
    out=)``); ``solve`` runs ``ir_pcg`` on them, in dia mode with the f32
    iteration in the lattice numbering.  Whether the f32 work replays from
    CUDA graphs is decided once, by ``utils.graphs.replayable``: sharded,
    the element-blocked matvecs all-reduce, while dia mode's banded level 0
    and the levels below it are whole on every rank.  The graphs are
    captured at the first solve, over the workspace."""

    def __init__(self, plan, device_mesh=None, secondary=(), gamma_coarse=(1, 2)):
        self.plan, self.secondary, self.gamma = plan, tuple(secondary), gamma_coarse
        dia = plan["mode"] == "dia"
        self.graphs = ({} if replayable(plan["ebe"]["free"].device, device_mesh,
                                        collective=not dia or bool(self.secondary)) else None)
        self.inner = ({"to_inner": lambda v: v[plan["perm0_l2o"]],
                       "from_inner": lambda v: v[plan["perm0_o2l"]]} if dia else {})
        self.ws = None

    def setup(self, K32, mask=None, secondary=()):
        """This update's operator: ``K32`` the bc-masked element blocks of
        the plan's cells and ``secondary`` those of the further batches
        (any float dtype; the workspace holds them in f32), ``mask`` the
        rows eliminated in this call (the element-blocked level 0 only;
        default: the plan's Dirichlet rows, in dia mode in the lattice
        numbering).  Then the hierarchy's values.  In a ``deo.solve.setup``
        span; counts ``mg.setups``."""
        with span("deo.solve.setup"):
            ws = self.ws
            if ws is None:
                plan = self.plan
                ws = self.ws = {"K32": K32.to(_F32, copy=True),
                                "K32s": [K.to(_F32, copy=True) for K in secondary]}
                if mask is None:
                    ws["free"] = None
                    ws["mask"] = (plan["mask0_lat"] if plan["mode"] == "dia"
                                  else ~plan["ebe"]["free"])
                else:
                    ws["mask"], ws["free"] = mask.clone(), ~mask
                ws["sec32"] = [ebe_matvec(K, e, ws["free"])
                               for K, e in zip(ws["K32s"], self.secondary)]
            else:
                ws["K32"].copy_(K32)
                for K, new in zip(ws["K32s"], secondary):
                    K.copy_(new)
                if mask is not None:
                    ws["mask"].copy_(mask)
                    torch.logical_not(mask, out=ws["free"])
            # through the module's name: a wrapper put there runs
            ws["rt"] = mg_setup(self.plan, ws["K32"], ws["free"], out=ws.get("rt"))
            count("mg.setups")

    def mv32(self, x):
        """The f32 operator: level 0's matvec and the further batches'."""
        ws = self.ws
        out = ws["rt"]["mv0"](x)
        for mv in ws["sec32"]:
            out = out + mv(x) - torch.where(ws["mask"], x, 0.0)
        return out

    def cycle(self, r):
        """The preconditioner: a cycle on ``r`` in f32 with the masked rows
        zeroed, in ``r``'s dtype, and ``r`` itself on those rows."""
        mask = self.ws["mask"]
        z = vcycle(self.plan, self.ws["rt"], torch.where(mask, 0.0, r.to(_F32)),
                   gamma_coarse=self.gamma)
        return torch.where(mask, r, z.to(r.dtype))

    def solve(self, mv64, b, rtol, maxiter, atol=0.0):
        """``ir_pcg`` on the last ``setup``'s operator, ``mv64`` the exact
        one: (x, inner iterations)."""
        return ir_pcg(mv64, self.mv32, self.cycle, b, rtol, maxiter, atol=atol,
                      graphs=self.graphs, **self.inner)

    def preconditioner(self, like):
        """The cycle for an outer Krylov method on vectors such as
        ``like``: where the solver replays, from a CUDA graph captured at
        the first call, each call returning a new tensor."""
        if self.graphs is None:
            return self.cycle
        if "cycle" not in self.graphs:
            self.graphs["cycle"] = capture(self.cycle, like)
        run = self.graphs["cycle"]
        return lambda r: run(r).clone()

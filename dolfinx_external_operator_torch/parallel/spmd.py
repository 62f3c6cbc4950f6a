"""Fused plasticity load step on one device (PyTorch).

The port of ``dolfinx_external_operator_tpu/parallel/spmd.py::
FusedPlasticityStep`` for one device and the ``"cg"``, ``"dense"``,
``"bcr"`` and ``"auto"`` linear solvers.  Per Newton pass:

  deps = B @ u_cell                    (einsum over precomputed B-matrices)
  C_tang, sigma = batched return map   (the SoA constitutive kernel)
  r = scatter(B^T sigma) - load        (deterministic gather-table sum)
  K dx = -r                            (safeguarded Jacobi-CG, or an f32
                                        factorization, dense or block-cyclic
                                        reduction, + f64 refinement)

PyTorch runs eagerly, so the JAX package's ``lax.while_loop``s are Python
loops: the Newton loop reads the residual norm on the host once per pass
and CG once per iteration.  Both keep the JAX semantics exactly (see
``_newton``).

Scatter-adds never use ``index_add_``, whose CUDA form uses atomics: each
dof sums a fixed, padded table of its (cell, local dof) contributions in
increasing order, so results are bitwise repeatable on every device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..convert import statics_from_numpy
from . import bcr as _bcr
from ..elements import Element
from ..mesh import Mesh
from ..quadrature import make_quadrature

__all__ = ["FusedPlasticityStep", "host_statics"]

_F = torch.float64

# solvers of the JAX package that are still to be ported, with their
# ROADMAP queue 1 item
_NOT_PORTED = {"mg": "item 6 (AMG-CG and lagged-elastic solvers)",
               "elastic": "item 6 (AMG-CG and lagged-elastic solvers)"}


def host_statics(mesh: Mesh, V, S, bc_dofs, bc_vals=None, body_dir=(0.0, -1.0)):
    """Host precompute of the JAX package (``spmd.py:200-261``) for one
    device: per-cell B-matrices in Mandel notation, quadrature weights
    times |det J|, the unit body-force element vectors, the unrolled
    dofmap and the Dirichlet data, as numpy arrays.  Bitwise equal to the
    JAX package's ``fp.statics``."""
    qdeg = S.element.degree
    qpts, qwts = make_quadrature(mesh.cell_type, qdeg)
    nq = qpts.shape[0]
    geo = Element("Lagrange", mesh.cell_type, 1)
    phi_g, dphi_g = geo.tabulate(qpts)
    phi_u, dphi_u = V.element.tabulate(qpts)  # scalar basis of V
    nb = phi_u.shape[1]
    bs = V.bs
    if bs != 2:
        raise ValueError("the fused step implements the 2D Mandel pattern (bs == 2)")
    n_dofs = V.num_dofs

    coords = mesh.points[mesh.cells]  # (nc, nv, g)
    J = np.einsum("qvd,cvg->cqgd", dphi_g, coords)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    gp = np.einsum("qbd,cqdg->cqbg", dphi_u, Jinv)  # scalar-basis phys grads
    nc = mesh.num_cells
    # B: (nc, nq, 4, nb*bs) strain-displacement in Mandel notation
    B = np.zeros((nc, nq, 4, nb * bs))
    B[:, :, 0, 0::2] = gp[:, :, :, 0]                    # e_xx = du_x/dx
    B[:, :, 1, 1::2] = gp[:, :, :, 1]                    # e_yy = du_y/dy
    s2 = np.sqrt(2.0) * 0.5
    B[:, :, 3, 0::2] = s2 * gp[:, :, :, 1]               # sqrt2 e_xy
    B[:, :, 3, 1::2] = s2 * gp[:, :, :, 0]
    wdet = detJ * qwts[None, :]  # (nc, nq)

    # body-force element vector for unit magnitude: f_cell[k] = int N_k b
    Nmat = np.zeros((nq, 2, nb * bs))
    Nmat[:, 0, 0::2] = phi_u
    Nmat[:, 1, 1::2] = phi_u
    bdir = np.asarray(body_dir, dtype=np.float64)
    f_cell = np.einsum("cq,qik,i->ck", wdet, Nmat, bdir)

    bc_mask = np.zeros(n_dofs, dtype=bool)
    bc_mask[np.asarray(bc_dofs, dtype=np.int64)] = True
    bc_vals_np = np.zeros(n_dofs)
    if bc_vals is not None:
        bc_vals_np[np.asarray(bc_dofs, dtype=np.int64)] = bc_vals

    return {
        "B": B,
        "wdet": wdet,
        "f_cell": f_cell,
        "dofmap": V.unrolled_dofmap.astype(np.int64),
        "bc_mask": bc_mask,
        "bc_vals": bc_vals_np,
    }


def _segment_table(seg, n_segments):
    """Padded gather table for a deterministic segment sum: row ``s`` lists,
    in increasing order, the positions ``i`` with ``seg[i] == s``; the pad
    entry is ``len(seg)``, which points at an appended zero.  Segment ids
    outside ``[0, n_segments)`` (padded cells) are dropped."""
    seg = np.asarray(seg, dtype=np.int64).ravel()
    pad = seg.size
    keep = np.flatnonzero((seg >= 0) & (seg < n_segments))
    order = keep[np.argsort(seg[keep], kind="stable")]
    s_sorted = seg[order]
    counts = np.bincount(s_sorted, minlength=n_segments)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(order.size) - starts[s_sorted]
    table = np.full((n_segments, max(int(counts.max(initial=0)), 1)), pad, dtype=np.int64)
    table[s_sorted, slot] = order
    return table


def _segment_sum(vals, table):
    """``vals`` flat (m,) -> (n_segments,) sums by ``_segment_table``."""
    ext = torch.cat([vals, vals.new_zeros(1)])
    return ext[table].sum(dim=1)


class FusedPlasticityStep:
    """Fused Newton load step for vector-displacement / quadrature-stress
    plasticity on one device.

    Parameters
    ----------
    mesh, V, S : the mesh, displacement space (blocked vector Lagrange) and
        stress quadrature space.
    batched_kernel : the SoA constitutive map ``(deps (4, n), sigma_n
        (4, n)) -> (C_tang (4, 4, n), sigma (4, n))`` over all n Gauss
        points (``models.von_mises.batched_kernel_f64`` or
        ``batched_kernel_f32``, ``MohrCoulombMaterial.batched_kernel``).
    bc_dofs, bc_vals : Dirichlet data on the displacement space.
    body_dir : direction of the unit body force; ``load`` scales it.
    device : ``None`` -> ``"cuda"`` (raises without a card), or ``"cpu"``.
    linear_solver : ``"cg"``, ``"dense"``, ``"bcr"`` (block-cyclic
        reduction, lattice meshes only) or ``"auto"`` (dense up to 10k dofs,
        BCR up to 130k).  The JAX package's ``"mg"`` and ``"elastic"`` are
        not ported yet and raise ``NotImplementedError``; so does ``"auto"``
        where the JAX package would fall back to ``"mg"``.
    dense_refine : f64 refinement rounds after the dense path's f32 solve
        (the JAX package's ``_dense_refine``, default 1); the other solvers
        ignore it.
    """

    def __init__(self, mesh: Mesh, V, S, batched_kernel, bc_dofs, bc_vals=None,
                 body_dir=(0.0, -1.0), device=None, **opts):
        self.mesh, self.V, self.S = mesh, V, S
        self._setup(host_statics(mesh, V, S, bc_dofs, bc_vals, body_dir),
                    batched_kernel, device, **opts)

    @classmethod
    def from_statics(cls, statics, batched_kernel, device=None, **opts):
        """A step built on given statics (numpy arrays keyed as the JAX
        package's ``fp.statics``), e.g. those of a JAX step.  The BCR solver
        needs ``statics["bcr"]``, the lattice map of ``bcr.build_bcr_statics``
        (``convert.bcr_statics_from_numpy`` carries a JAX step's across)."""
        self = cls.__new__(cls)
        self.mesh = self.V = self.S = None
        self._setup({k: v if k == "bcr" else np.asarray(v) for k, v in statics.items()},
                    batched_kernel, device, **opts)
        return self

    def _setup(self, st_np, batched_kernel, device, newton_atol=1e-8, newton_rtol=1e-8,
               newton_max_it=100, cg_rtol=1e-13, cg_maxiter=10000, linear_solver="cg",
               device_mesh=None, dense_refine=1):
        self.device = resolve_device(device)
        if device_mesh is not None:
            raise NotImplementedError(
                "cell sharding over several devices is ROADMAP queue 1 item 7")
        self._vkernel = batched_kernel
        self.newton_atol = newton_atol
        self.newton_rtol = newton_rtol
        self.newton_max_it = newton_max_it
        self.cg_rtol = cg_rtol
        self.cg_maxiter = cg_maxiter

        self.n_dofs = int(st_np["bc_mask"].shape[0])
        self.nc_pad, self.nq = st_np["B"].shape[:2]
        self.nc = self.nc_pad if self.mesh is None else self.mesh.num_cells
        auto = linear_solver == "auto"
        if auto:
            # the JAX package's crossovers (spmd.py:162-167); above 130k
            # dofs "auto" picks AMG-CG, which is not ported yet
            linear_solver = "dense" if self.n_dofs <= 10_000 else (
                "bcr" if self.n_dofs <= 130_000 else "mg")
        if linear_solver in _NOT_PORTED:
            raise NotImplementedError(
                f"linear_solver={linear_solver!r} is not ported yet: ROADMAP queue 1 "
                f"{_NOT_PORTED[linear_solver]}")
        if linear_solver not in ("cg", "dense", "bcr"):
            raise ValueError(f"unknown linear_solver {linear_solver!r}")
        self.linear_solver = linear_solver
        self.statics = statics_from_numpy(st_np, self.device)

        # deterministic scatter: dof <- its (cell, local dof) slots
        dev = self.device
        self._scatter_table = torch.as_tensor(
            _segment_table(st_np["dofmap"], self.n_dofs), device=dev)
        self._dense_asm = None
        if linear_solver == "dense":
            self._setup_dense_asm(st_np["dofmap"].astype(np.int64))
        self._bcr = None
        if linear_solver == "bcr":
            self._setup_bcr(st_np, auto)
        # dense-path factorization: "lu" on the CPU, "chol" on the card,
        # from where the statics landed (spmd.py:802-804)
        self._dense_fact = "lu" if dev.type == "cpu" else "chol"
        # f64 refinement rounds on top of the equilibrated f32 solve (the
        # JAX package's default is 1, validated Newton-iterate-identical)
        self._dense_refine = int(dense_refine)

    def _setup_dense_asm(self, dofmap_p):
        """Host precompute of the duplicate-free dense-assembly map: the
        (nc*nk*nk) per-cell contributions summed per unique (i, j) through
        a padded gather table, then written once into the global matrix
        (the JAX package's sorted ``segment_sum`` + unique scatter)."""
        n = self.n_dofs
        nk = dofmap_p.shape[1]
        ii = np.repeat(dofmap_p, nk, axis=1).ravel()
        jj = np.tile(dofmap_p, (1, nk)).ravel()
        key = ii * np.int64(n + 1) + jj
        uniq, inv = np.unique(key, return_inverse=True)
        dev = self.device
        self._dense_asm = {
            "table": torch.as_tensor(_segment_table(inv, uniq.size), device=dev),
            # flat index into the (n + 1, n + 1) matrix
            "flat": torch.as_tensor(uniq, device=dev),
        }

    def _setup_bcr(self, st_np, auto):
        """Host build of the block-cyclic-reduction map (spmd.py:455-474):
        the lattice detection and the (cell, a, b) -> row-band slot map,
        deduplicated as the dense map is (the JAX package's ``segment_sum``
        into ``sentinel + 1`` slots would need a gather table of
        ``sentinel`` rows): the element-stiffness entries are summed per
        unique slot through a padded gather table and written once into a
        zeroed flat band array."""
        if self.mesh is not None:
            info = _bcr.build_bcr_statics(self.mesh, self.V, st_np["bc_mask"])
        elif "bcr" in st_np:
            info = st_np["bcr"]
        else:
            raise ValueError(
                "linear_solver='bcr' without a mesh needs statics['bcr'] (the lattice map "
                "of bcr.build_bcr_statics; convert.bcr_statics_from_numpy carries a JAX "
                "step's across)")
        if info is None:
            if auto:
                raise NotImplementedError(
                    "linear_solver='auto' picks BCR at this size, and the mesh is not "
                    "lattice-structured: the JAX package falls back to AMG-CG ('mg'), which "
                    f"is not ported yet: ROADMAP queue 1 {_NOT_PORTED['mg']}")
            raise ValueError(
                "linear_solver='bcr' requires a lattice-structured mesh (structured-"
                "rectangle P1/P2; see bcr._lattice_node_perm)")
        m, B, n, sentinel = (int(info[k]) for k in ("m", "B", "n", "sentinel"))
        dst = np.asarray(info["dst"], dtype=np.int64).ravel()
        keep = np.flatnonzero(dst < sentinel)  # padded cells point at the sentinel
        uniq, inv = np.unique(dst[keep], return_inverse=True)
        seg = np.full(dst.size, -1, dtype=np.int64)
        seg[keep] = inv
        dev = self.device
        keep_ext = np.concatenate([~st_np["bc_mask"], [False]])

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        self._bcr = {
            "m": m, "B": B, "n": n, "size": sentinel,
            "table": t(_segment_table(seg, uniq.size)),
            "slots": t(uniq),
            "diag_fix": t(info["diag_fix"]),
            "diag_slot": t(info["diag_slot"]),
            "perm_l2o": t(info["perm_l2o"]),
            "perm_o2l": t(info["perm_o2l"]),
            # bc mask of each cell dof (padded cells: all masked), f32
            "keep32": torch.as_tensor(keep_ext[st_np["dofmap"]], dtype=torch.float32,
                                      device=dev),
        }
        # levels of the factorizations that fell back to the LU inverse
        self.bcr_stats = {"factorizations": 0, "inv_levels": 0}

    def _assemble_dense_f32(self, K_cell32):
        """Global (n, n) f32 matrix from per-cell (nk, nk) blocks."""
        n = self.n_dofs
        asm = self._dense_asm
        vals = _segment_sum(K_cell32.reshape(-1), asm["table"])
        K = torch.zeros((n + 1) * (n + 1), dtype=torch.float32, device=self.device)
        K[asm["flat"]] = vals
        return K.view(n + 1, n + 1)[:n, :n]

    # ------------------------------------------------------------------
    # element chain (spmd.py:477-524)
    def _gather(self, u):
        return torch.cat([u, u.new_zeros(1)])[self.statics["dofmap"]]  # (nc, nk)

    def _scatter(self, cell_vals):
        return _segment_sum(cell_vals.reshape(-1), self._scatter_table)

    def _constitutive(self, Du, sigma_n):
        st = self.statics
        u_cell = self._gather(Du)
        deps = torch.einsum("cqik,ck->cqi", st["B"], u_cell)
        nc = deps.shape[0]
        C_t, sig_t = self._vkernel(deps.reshape(-1, 4).T, sigma_n.reshape(-1, 4).T)
        C_tang = C_t.permute(2, 0, 1).reshape(nc, self.nq, 4, 4)
        sigma = sig_t.T.reshape(nc, self.nq, 4)
        return C_tang, sigma

    def _assemble_f(self):
        return self._scatter(self.statics["f_cell"])

    def _residual(self, sigma, load, fvec):
        st = self.statics
        r_cell = torch.einsum("cqik,cqi,cq->ck", st["B"], sigma, st["wdet"])
        return self._scatter(r_cell) - fvec * load

    def _tangent_matvec(self, C_tang, x):
        st = self.statics
        x_cell = self._gather(x)
        dde = torch.einsum("cqik,ck->cqi", st["B"], x_cell)
        dsig = torch.einsum("cqij,cqj->cqi", C_tang, dde)
        k_cell = torch.einsum("cqik,cqi,cq->ck", st["B"], dsig, st["wdet"])
        return self._scatter(k_cell)

    def _tangent_diag(self, C_tang):
        st = self.statics
        d_cell = torch.einsum("cqik,cqij,cqjk,cq->ck", st["B"], C_tang, st["B"], st["wdet"])
        return self._scatter(d_cell)

    def _bc_matvec(self, C_tang, x):
        mask = self.statics["bc_mask"]
        y = self._tangent_matvec(C_tang, torch.where(mask, 0.0, x))
        return torch.where(mask, x, y)

    # ------------------------------------------------------------------
    # linear solvers
    def _cg_solve(self, C_tang, b, cg_rtol, maxiter):
        """Safeguarded Jacobi-CG (spmd.py:536-593): tracks the best iterate
        and exits on an SPD-invariant breakdown or on residual growth past
        100x the best seen; returns the best iterate.  One host sync per
        iteration (the loop test)."""
        mask = self.statics["bc_mask"]
        diag = torch.where(mask, 1.0, self._tangent_diag(C_tang))
        Minv = 1.0 / diag

        def mv(x):
            return self._bc_matvec(C_tang, x)

        x = torch.zeros_like(b)
        r = b - mv(x)
        z = Minv * r
        rz = torch.dot(r, z)
        p = z
        target = cg_rtol * torch.sqrt(torch.dot(b, b))
        n_cur = torch.sqrt(torch.dot(r, r))
        n_best = n_cur
        x_best = x
        ok = rz >= 0.0
        k = 0
        while k < maxiter and bool(ok & (n_cur > target)):
            Ap = mv(p)
            pAp = torch.dot(p, Ap)
            ok = torch.isfinite(pAp) & (pAp > 0.0) & torch.isfinite(rz) & (rz > 0.0)
            alpha = torch.where(ok, rz / torch.where(pAp > 0.0, pAp, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Minv * r
            rz2 = torch.dot(r, z)
            beta = torch.where(rz > 0.0, rz2 / torch.where(rz > 0.0, rz, 1.0), 0.0)
            p = z + beta * p
            n_cur = torch.sqrt(torch.dot(r, r))
            better = n_cur < n_best
            x_best = torch.where(better, x, x_best)
            n_best = torch.where(better, n_cur, n_best)
            ok = ok & torch.isfinite(n_cur) & (n_cur < 100.0 * n_best)
            rz = rz2
            k += 1
        return x_best, k

    def _dense_solve(self, C_tang, b):
        """Assembled dense f32 tangent, Jacobi-equilibrated, factorized in
        f32, with f64 iterative refinement against the exact f64
        element-by-element operator (spmd.py:777-843).

        ``"lu"`` (CPU): LU factor + solve.  ``"chol"`` (CUDA): Cholesky and
        two triangular solves per application (``cholesky_solve``) in
        place of the JAX package's blocked triangular inverse, which was a
        TPU workaround; a non-SPD tangent (``info != 0``) takes the
        pivoted-LU inverse instead, as the JAX package does."""
        mask = self.statics["bc_mask"]
        f32 = torch.float32
        K = self._assemble_dense_f32(self._k_cell32(C_tang))
        keep32 = (~mask).to(f32)
        K = K * keep32[:, None] * keep32[None, :] + torch.diag(mask.to(f32))
        d = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diagonal(K)), min=1e-30).to(_F))
        Ks32 = K * (d[:, None] * d[None, :]).to(f32)
        if self._dense_fact == "lu":
            LU, piv = torch.linalg.lu_factor(Ks32)

            def solve32(rr):
                y = torch.linalg.lu_solve(LU, piv, (rr * d).to(f32)[:, None])[:, 0]
                return y.to(_F) * d
        else:
            L, info = torch.linalg.cholesky_ex(Ks32)
            if int(info) == 0:
                def solve32(rr):
                    y = torch.cholesky_solve((rr * d).to(f32)[:, None], L)[:, 0]
                    return y.to(_F) * d
            else:
                Kinv = torch.linalg.inv(Ks32)

                def solve32(rr):
                    return (Kinv @ (rr * d).to(f32)).to(_F) * d

        x = solve32(b)
        for _ in range(self._dense_refine):
            x = x + solve32(b - self._bc_matvec(C_tang, x))
        return x, 0

    def _k_cell32(self, C_tang):
        """Element stiffness in f32 (it only feeds an f32 factorization)."""
        st = self.statics
        f32 = torch.float32
        return torch.einsum("cqik,cqij,cqjl,cq->ckl", st["B"].to(f32), C_tang.to(f32),
                            st["B"].to(f32), st["wdet"].to(f32))

    def _bcr_bands(self, C_tang):
        """The flat f32 row bands ``[L | D | U]`` of the bc-masked tangent in
        lattice numbering, with identity bc and padding rows
        (spmd.py:745-763)."""
        plan = self._bcr
        km = plan["keep32"]
        K_cell = self._k_cell32(C_tang) * km[:, :, None] * km[:, None, :]
        Tflat = torch.zeros(plan["size"], dtype=torch.float32, device=self.device)
        Tflat[plan["slots"]] = _segment_sum(K_cell.reshape(-1), plan["table"])
        Tflat[plan["diag_fix"]] += 1.0  # unique slots
        return Tflat

    def _bcr_apply(self, fact, d, rr):
        """One f32 application of the factorization in the original dof
        numbering: permute into the lattice, scale, solve, scale back."""
        plan = self._bcr
        d64 = d.to(_F)
        r_lat = torch.cat([rr[plan["perm_l2o"]], rr.new_zeros(plan["m"] * plan["B"] - plan["n"])])
        x_lat = _bcr.bcr_apply(fact, d * r_lat.to(torch.float32))
        return (d64 * x_lat.to(_F))[:plan["n"]][plan["perm_o2l"]]

    def _bcr_solve(self, C_tang, b, rtol):
        """Block-cyclic-reduction direct solve (spmd.py:724-775): the f32
        factorization of the lattice block-tridiagonal tangent inside f64
        iterative refinement on the exact element-by-element operator.
        Returns (dx, signed refinement rounds)."""
        plan = self._bcr
        T, d = _bcr.equilibrate(self._bcr_bands(C_tang), plan["diag_slot"], plan["m"],
                                plan["B"])
        fact = _bcr.bcr_factor(T, plan["m"], plan["B"], self.bcr_stats)
        self.bcr_stats["factorizations"] += 1
        return _bcr.ir_direct(lambda x: self._bc_matvec(C_tang, x),
                              lambda rr: self._bcr_apply(fact, d, rr), b, rtol)

    # ------------------------------------------------------------------
    def _newton(self, Du, sigma_n, load, max_it, cg_rtol, norm0_ref):
        """Full Newton solve of one load step (spmd.py:845-935).

        Do-while semantics of the JAX loop: each pass evaluates the
        constitutive kernel and the residual at the CURRENT iterate; a
        converged pass performs no solve and returns sigma at that iterate.
        ``it`` counts updates only and ``max_it`` bounds them; ``norm0_ref``
        NaN means the rtol reference self-initialises from the first
        residual."""
        st = self.statics
        mask, bc_vals = st["bc_mask"], st["bc_vals"]
        fvec = self._assemble_f()
        sigma = torch.zeros_like(sigma_n)
        norm, norm0 = math.nan, float(norm0_ref)
        it = cg_tot = 0
        while it < max_it:
            C_tang, sigma = self._constitutive(Du, sigma_n)
            r = self._residual(sigma, load, fvec)
            r = torch.where(mask, Du - bc_vals, r)
            norm = float(torch.sqrt(torch.dot(r, r)))
            if math.isnan(norm0):
                norm0 = norm
            if norm < self.newton_atol or norm < self.newton_rtol * norm0:
                break
            if self.linear_solver == "dense":
                dx, cg_k = self._dense_solve(C_tang, -r)
            elif self.linear_solver == "bcr":
                dx, cg_k = self._bcr_solve(C_tang, -r, cg_rtol)
            else:
                dx, cg_k = self._cg_solve(C_tang, -r, cg_rtol, self.cg_maxiter)
            Du = Du + dx
            it += 1
            cg_tot += cg_k
        return Du, sigma, norm, it, cg_tot

    def _state_in(self, Du, sigma_n):
        return (torch.as_tensor(Du, dtype=_F, device=self.device),
                torch.as_tensor(sigma_n, dtype=_F, device=self.device))

    def run_step(self, Du, sigma_n, load):
        """One load step: (Du (n,), sigma_n (nc_pad, nq, 4), load) ->
        (Du_new, sigma (nc_pad, nq, 4), residual_norm, newton_its, cg_its)."""
        Du, sigma_n = self._state_in(Du, sigma_n)
        return self._newton(Du, sigma_n, float(load), self.newton_max_it, self.cg_rtol,
                            math.nan)

    def run_schedule(self, loads, Du=None, sigma_n=None):
        """``run_step`` over ``loads``, committing the state between steps.
        Returns ``(Du, sigma, norms, newton_its, cg_its)`` with per-step
        history tensors (on the CPU)."""
        Du0, sig0 = self.zero_state()
        Du = Du0 if Du is None else Du
        sigma = sig0 if sigma_n is None else sigma_n
        norms, its, cgs = [], [], []
        for load in np.asarray(loads, dtype=np.float64).ravel():
            Du, sigma, norm, it, cg = self.run_step(Du, sigma, load)
            norms.append(norm)
            its.append(it)
            cgs.append(cg)
        return (Du, sigma, torch.tensor(norms, dtype=_F), torch.tensor(its),
                torch.tensor(cgs))

    def run_step_host(self, Du, sigma_n, load, forcing=True):
        """One load step driven one Newton update at a time (the Newton
        core called with ``max_it = 1``), with Eisenstat-Walker CG
        tolerances when ``forcing`` (spmd.py:1065-1134).  The first
        iterate's norm is carried as ``norm0_ref``; the loop ends on a pass
        that performs no update, which also recomputes sigma at the
        converged iterate.  Raises ``RuntimeError`` if ``newton_max_it``
        updates do not converge."""
        Du, sigma_n = self._state_in(Du, sigma_n)
        load = float(load)
        its_total = cg_total = 0
        norm0 = norm = None
        sigma = sigma_n
        converged = False
        for _ in range(self.newton_max_it + 1):
            if forcing and norm0 is not None and norm is not None and norm0 > 0:
                eta = float(np.sqrt(max(min(norm / norm0, 1.0), 0.0)))
                rtol_eff = max(min(0.1, eta), self.cg_rtol)
            else:
                rtol_eff = min(1e-2, max(self.cg_rtol, 1e-6)) if forcing else self.cg_rtol
            norm0_ref = math.nan if norm0 is None else norm0
            Du, sigma, norm, its, cg = self._newton(Du, sigma_n, load, 1, rtol_eff, norm0_ref)
            its_total += its
            cg_total += cg
            if norm0 is None:
                norm0 = norm
            if its == 0:  # converged: no update; sigma is at this iterate
                converged = True
                break
        if not converged:
            raise RuntimeError(
                f"host-driven Newton failed to converge within "
                f"{self.newton_max_it} updates ({its_total} performed; last "
                f"observed |r| = {norm:.3e} predates the final update), "
                f"target {max(self.newton_atol, self.newton_rtol * (norm0 or 0.0)):.3e}")
        return Du, sigma, norm, its_total, cg_total

    def zero_state(self):
        sig = torch.zeros((self.nc_pad, self.nq, 4), dtype=_F, device=self.device)
        Du = torch.zeros(self.n_dofs, dtype=_F, device=self.device)
        return Du, sig

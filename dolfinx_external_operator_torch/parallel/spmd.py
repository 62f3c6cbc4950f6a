"""Fused plasticity load step (PyTorch), on one device or cell-sharded.

The port of ``dolfinx_external_operator_tpu/parallel/spmd.py::
FusedPlasticityStep`` with every linear solver of the JAX package:
``"cg"``, ``"dense"``, ``"bcr"``, ``"mg"``, ``"elastic"`` and ``"auto"``.
Per Newton pass:

  deps = B @ u_cell                    (einsum over precomputed B-matrices)
  C_tang, sigma = batched return map   (the SoA constitutive kernel)
  r = scatter(B^T sigma) - load        (deterministic gather-table sum)
  K dx = -r                            (safeguarded Jacobi-CG; an f32
                                        factorization, dense or block-cyclic
                                        reduction, + f64 refinement; or f32
                                        PCG, preconditioned by AMG or by a
                                        lagged elastic inverse, inside f64
                                        refinement)

PyTorch runs eagerly, so the JAX package's ``lax.while_loop``s are Python
loops: the Newton loop reads the residual norm on the host once per pass
and the Krylov loops once per iteration.  They keep the JAX semantics
exactly (see ``_newton``).

Scatter-adds never use ``index_add_``, whose CUDA form uses atomics: each
destination sums a fixed, padded table of its contributions in increasing
order (``scatter.py``), so results are bitwise repeatable on every device.

With a ``device_mesh`` (``dist.make_device_mesh``, one process per rank)
the cells are padded to a multiple of the rank count and each rank owns a
contiguous slice of them: its B-matrices, weights, dofmap and Gauss-point
state.  Dof vectors are whole on every rank.  Each scatter is the rank's
segment sum over its own cells followed by one all-reduce
(``dist.psum``), as the JAX package's ``shard_map`` follows each with
``psum`` (``spmd.py:955-989``); everything after a sum is the same work on
the same bits on every rank, so the ranks take the same branches.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..convert import statics_from_numpy
from . import bcr as _bcr
from . import dist
from . import mg as _mg
from .scatter import dedup_table, dedup_write, segment_sum, segment_table
from ..elements import Element
from ..mesh import Mesh
from ..quadrature import make_quadrature

__all__ = ["FusedPlasticityStep", "host_statics"]

_F = torch.float64


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


class FusedPlasticityStep:
    """Fused Newton load step for vector-displacement / quadrature-stress
    plasticity, on one device or cell-sharded over ranks.

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
        With a ``device_mesh``, the mesh's device (``device`` must be
        ``None`` or the same).
    device_mesh : ``None`` (one device), or this rank's
        ``dist.DeviceMesh``: the cells are sharded over its ranks, and
        every rank constructs the step and calls it alike.  ``sigma_n``
        and the returned sigma are then the rank's
        ``(nc_pad // size, nq, 4)`` slice; Du is whole on every rank.
    linear_solver : ``"cg"``, ``"dense"``, ``"bcr"`` (block-cyclic
        reduction, lattice meshes only), ``"mg"`` (aggregation AMG as the
        preconditioner of mixed-precision CG), ``"elastic"`` (a dense f32
        inverse of the tangent, lagged one load step, as the
        preconditioner) or ``"auto"`` (dense up to 10k dofs, BCR up to 130k,
        AMG-CG above that and wherever BCR finds no lattice; with a
        ``device_mesh``, AMG-CG above 10k dofs, as the JAX package does:
        BCR's factorization would be the same work on every rank).
    dense_refine : f64 refinement rounds after the dense path's f32 solve
        (the JAX package's ``_dense_refine``, default 1); the other solvers
        ignore it.
    mg_opts : options of the AMG hierarchy (``parallel.mg.build_mg_statics``)
        and of its cycle: ``mv0_mode`` (``"auto"``: the banded lattice
        layout ``"dia"`` where the mesh is a lattice, else ``"node"``; or
        ``"dia"``, ``"node"``, ``"scalar"``), ``gamma_coarse`` (default
        ``(1, 2)``), ``galerkin_levels`` (default all levels up to 30k dofs,
        1 above), ``coarse_target``, ``max_levels``, ``smooth_sa``,
        ``cheb_degree``, ``agg_reach``.
    fused_forcing : Eisenstat-Walker tolerances inside the Newton loop:
        False (default) solves every update to ``cg_rtol``; True caps the
        forcing term at 1e-4; a float is the cap.  The factorizing solvers
        (dense) ignore it.
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
        (``convert.bcr_statics_from_numpy`` carries a JAX step's across);
        the AMG solver needs ``statics["mg"]``, the hierarchy
        (``convert.mg_statics_from_numpy``).  The statics are whole (all
        cells, possibly padded); with ``device_mesh=`` each rank pads them
        to its rank count and takes its own cells, those of ``"mg"`` and
        ``"bcr"`` included."""
        self = cls.__new__(cls)
        self.mesh = self.V = self.S = None
        self._setup({k: v if k in ("bcr", "mg") else np.asarray(v) for k, v in statics.items()},
                    batched_kernel, device, **opts)
        return self

    def _setup(self, st_np, batched_kernel, device, newton_atol=1e-8, newton_rtol=1e-8,
               newton_max_it=100, cg_rtol=1e-13, cg_maxiter=10000, linear_solver="cg",
               device_mesh=None, dense_refine=1, mg_opts=None, fused_forcing=False):
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.device = resolve_device(device)
            self._psum = _mg._no_sum
        else:
            if device is not None and resolve_device(device) != device_mesh.device:
                raise ValueError(f"device {device!r} is not the mesh's {device_mesh.device}")
            self.device = device_mesh.device
            self._psum = functools.partial(dist.psum, group=device_mesh.group)
        self._vkernel = batched_kernel
        self.newton_atol = newton_atol
        self.newton_rtol = newton_rtol
        self.newton_max_it = newton_max_it
        self.cg_rtol = cg_rtol
        self.cg_maxiter = cg_maxiter
        # Eisenstat-Walker cap inside the Newton loop (spmd.py:189-198):
        # True = 1e-4, which keeps the slope's Newton counts those of exact
        # solves, where the classic 0.1 inflates them
        self.fused_forcing = 1e-4 if fused_forcing is True else fused_forcing

        self.n_dofs = n = int(st_np["bc_mask"].shape[0])
        self.nq = st_np["B"].shape[1]
        # the real cells; padded ones (a sharded JAX step's statics) come
        # last, every dof at the dummy index n
        self.nc = int((np.asarray(st_np["dofmap"]) < n).any(axis=1).sum())
        # cells padded to a multiple of the rank count (spmd.py:238-246)
        ranks = 1 if device_mesh is None else device_mesh.size
        self.nc_pad = -(-st_np["B"].shape[0] // ranks) * ranks
        auto = linear_solver == "auto"
        if auto:
            # the JAX package's crossovers (spmd.py:162-167)
            linear_solver = "dense" if n <= 10_000 else (
                "bcr" if n <= 130_000 and device_mesh is None else "mg")
        if linear_solver not in ("cg", "dense", "bcr", "mg", "elastic"):
            raise ValueError(f"unknown linear_solver {linear_solver!r}")
        # this rank's cells (spmd.py:301-307): bc data whole
        local = {k: self._cells(st_np[k]) for k in ("B", "wdet", "f_cell")}
        local.update(dofmap=self._cells(st_np["dofmap"], n), bc_mask=st_np["bc_mask"],
                     bc_vals=st_np["bc_vals"])
        self.statics = statics_from_numpy(local, self.device)
        dofmap = local["dofmap"].astype(np.int64)

        # deterministic scatter: dof <- its (cell, local dof) slots
        dev = self.device
        self._scatter_table = torch.as_tensor(segment_table(dofmap, n), device=dev)
        # bc mask of each cell dof (padded cells: all masked)
        keep_ext = np.concatenate([~st_np["bc_mask"], [False]])
        self._keep_cell = torch.as_tensor(keep_ext[dofmap], dtype=_F, device=dev)
        self._dense_asm = None
        if linear_solver in ("dense", "elastic"):
            self._dense_asm = dedup_table(*self._dense_keys(dofmap), device=dev)
        self._bcr = None
        if linear_solver == "bcr" and not self._setup_bcr(st_np, auto):
            # auto-selected BCR on a mesh that turned out non-lattice
            linear_solver = "mg"
        self.linear_solver = linear_solver
        # the hierarchy and the elastic inverse are built from all cells,
        # the same on every rank (the JAX package's design)
        if linear_solver == "mg":
            self._setup_mg(st_np, dict(mg_opts or {}), dofmap)
        elif linear_solver == "elastic":
            self._setup_elastic_inverse(st_np, dofmap)
        # dense-path factorization: "lu" on the CPU, "chol" on the card,
        # from where the statics landed (spmd.py:802-804)
        self._dense_fact = "lu" if dev.type == "cpu" else "chol"
        # f64 refinement rounds on top of the equilibrated f32 solve (the
        # JAX package's default is 1, validated Newton-iterate-identical)
        self._dense_refine = int(dense_refine)

    def _cells(self, a, pad=0):
        """This rank's rows of the per-cell array ``a`` (all cells), after
        padding it to ``nc_pad`` rows of ``pad``: the index that drops a
        padded cell's contributions from its map."""
        a = np.asarray(a)
        a = np.concatenate([a, np.full((self.nc_pad - a.shape[0],) + a.shape[1:], pad, a.dtype)])
        if self.device_mesh is None:
            return a
        k = self.nc_pad // self.device_mesh.size
        return a[self.device_mesh.rank * k:(self.device_mesh.rank + 1) * k]

    def _dense_keys(self, dofmap_p):
        """Flat index into the (n + 1, n + 1) matrix of each per-cell
        (nk, nk) contribution, and that size: the dense assembly map, summed
        per unique (i, j) and written once (the JAX package's sorted
        ``segment_sum`` + unique scatter)."""
        n = self.n_dofs
        nk = dofmap_p.shape[1]
        ii = np.repeat(dofmap_p, nk, axis=1).ravel()
        jj = np.tile(dofmap_p, (1, nk)).ravel()
        return ii * np.int64(n + 1) + jj, (n + 1) * (n + 1)

    def _setup_bcr(self, st_np, auto):
        """Host build of the block-cyclic-reduction map (spmd.py:455-474):
        the lattice detection and the (cell, a, b) -> row-band slot map,
        deduplicated as the dense map is (the JAX package's ``segment_sum``
        into ``sentinel + 1`` slots would need a gather table of
        ``sentinel`` rows).  Returns False where ``auto`` picked BCR and
        the mesh is not lattice-structured."""
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
                return False
            raise ValueError(
                "linear_solver='bcr' requires a lattice-structured mesh (structured-"
                "rectangle P1/P2; see bcr._lattice_node_perm); use linear_solver='mg' "
                "on unstructured meshes")
        m, B, n, sentinel = (int(info[k]) for k in ("m", "B", "n", "sentinel"))
        dev = self.device

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        self._bcr = {
            "m": m, "B": B, "n": n,
            # this rank's cells; padded cells point at the sentinel, which
            # the map drops
            "bands": dedup_table(self._cells(info["dst"], sentinel), sentinel, dev),
            "diag_fix": t(info["diag_fix"]),
            "diag_slot": t(info["diag_slot"]),
            "perm_l2o": t(info["perm_l2o"]),
            "perm_o2l": t(info["perm_o2l"]),
        }
        # levels of the factorizations that fell back to the LU inverse
        self.bcr_stats = {"factorizations": 0, "inv_levels": 0}
        return True

    def _elastic_tangent(self):
        """The tangent at zero strain and stress: the batched kernel at one
        zero point, as numpy (4, 4)."""
        z = torch.zeros((4, 1), dtype=_F, device=self.device)
        return self._vkernel(z, z)[0][:, :, 0].cpu().numpy()

    def _elastic_blocks(self, st_np):
        """ELASTIC element stiffness blocks (nc, nk, nk), numpy f64, as the
        JAX package computes them (spmd.py:374-376, :398-401)."""
        B_np = st_np["B"][:self.nc]
        return np.einsum("cqik,ij,cqjl,cq->ckl", B_np, self._elastic_tangent(), B_np,
                         st_np["wdet"][:self.nc], optimize=True)

    def _setup_mg(self, st_np, mg_opts, dofmap):
        """The AMG hierarchy (spmd.py:391-453): built on the host from the
        elastic tangent (``mg.build_mg_statics``), or taken from
        ``statics["mg"]`` without a mesh; then its device plan
        (``mg.mg_plan``) over this rank's cells (``dofmap``): the level-0
        maps ``W``, ``blk_dst`` and ``dia0_dst`` are sliced as the JAX
        package shards them (spmd.py:308-314, :449-452), each scatter of
        ``mg_setup`` and of the level-0 element-blocked matvecs is
        followed by ``psum``, and the coarse levels stay whole."""
        if self.mesh is not None:
            # above ~30k dofs the aggregation levels keep their elastic
            # Galerkin values (the per-Newton maps would dwarf the few CG
            # iterations they save)
            mg_opts.setdefault("galerkin_levels", None if self.n_dofs <= 30_000 else 1)
            mode = mg_opts.pop("mv0_mode", "auto")
            gamma = mg_opts.pop("gamma_coarse", (1, 2))
            mgs = _mg.build_mg_statics(self.mesh, self.V, st_np["bc_mask"],
                                       self._elastic_blocks(st_np),
                                       dia=mode in ("dia", "auto"), **mg_opts)
        elif "mg" in st_np:
            mgs = dict(st_np["mg"])
            mode, gamma = mgs.pop("mv0_mode"), mgs.pop("gamma_coarse")
        else:
            raise ValueError(
                "linear_solver='mg' without a mesh needs statics['mg'] (the hierarchy of "
                "mg.build_mg_statics; convert.mg_statics_from_numpy carries a JAX step's "
                "across)")
        static = {k: mgs.pop(k, None) for k in ("cheb_degree", "dia0_offsets", "dia1_offsets",
                                                "t0_stencil", "lat_shapes")}
        if mode == "auto":
            mode = "dia" if static["dia0_offsets"] is not None else "node"
        elif mode == "dia" and static["dia0_offsets"] is None:
            warnings.warn(
                "mv0_mode='dia' unavailable: the mesh is not lattice-structured (or its "
                "operator exceeds the 128-band cap in build_mg_statics); falling back to "
                "'node'", stacklevel=4)
            mode = "node"
        self._mg_mv0_mode, self._mg_gamma = mode, gamma
        dia = mode == "dia"
        t0 = dict(mgs["transfers"][0])
        t0["W"] = self._cells(t0["W"])
        t0["blk_dst"] = self._cells(t0["blk_dst"], np.asarray(mgs["levels"][0]["cols"]).size)
        mgs["transfers"] = [t0] + list(mgs["transfers"][1:])
        if static["dia0_offsets"] is not None:
            mgs["dia0_dst"] = self._cells(mgs["dia0_dst"],
                                          len(static["dia0_offsets"]) * self.n_dofs)
        self._mg = _mg.mg_plan(
            mgs, dofmap, st_np["bc_mask"], self.device, psum=self._psum, mv0_mode=mode,
            dia_offsets=static["dia0_offsets"],
            dia1_offsets=static["dia1_offsets"] if dia else None,
            t0_stencil=static["t0_stencil"] if dia else None,
            lat_shapes=static["lat_shapes"], cheb_degree=static["cheb_degree"])
        # dofs per level: level 0, then the P1 level and the aggregates
        self.mg_sizes = [self.n_dofs] + [lvl["n"] for lvl in self._mg["levels"]]

    def _setup_elastic_inverse(self, st_np, dofmap):
        """Dense f32 inverse of the Jacobi-equilibrated ELASTIC stiffness,
        the first preconditioner of ``linear_solver="elastic"``
        (spmd.py:360-389).  Built with numpy from all cells as in the JAX
        package, so it is the same matrix bit for bit (and on every rank).
        The (Minv, d) pair is step state: every load step refreshes it from
        its converged tangent.  The element-blocked matvecs run over this
        rank's cells (``dofmap``)."""
        n = self.n_dofs
        dm = st_np["dofmap"][:self.nc].astype(np.int64)
        K = np.zeros((n, n), np.float64)
        np.add.at(K, (np.repeat(dm, dm.shape[1], 1), np.tile(dm, (1, dm.shape[1]))),
                  self._elastic_blocks(st_np).reshape(self.nc, -1))
        mask = st_np["bc_mask"]
        K = K * ~mask[:, None] * ~mask[None, :] + np.diag(mask.astype(np.float64))
        d = 1.0 / np.sqrt(np.clip(np.abs(np.diag(K)), 1e-30, None))
        Ks = (K * d[:, None] * d[None, :]).astype(np.float32)
        self._el_precond = (torch.as_tensor(np.linalg.inv(Ks), device=self.device),
                            torch.as_tensor(d, dtype=torch.float32, device=self.device))
        self._el_ebe = _mg.ebe_plan(dofmap, mask, n, self.device, psum=self._psum)

    def _assemble_dense_f32(self, K_cell32):
        """Global (n, n) f32 matrix from per-cell (nk, nk) blocks (sharded:
        an all-reduce of the (n + 1)^2 matrix, spmd.py:356-358)."""
        n = self.n_dofs
        K = self._psum(dedup_write(K_cell32.reshape(-1), self._dense_asm))
        return K.view(n + 1, n + 1)[:n, :n]

    # ------------------------------------------------------------------
    # element chain (spmd.py:477-524)
    def _gather(self, u):
        return torch.cat([u, u.new_zeros(1)])[self.statics["dofmap"]]  # (nc, nk)

    def _scatter(self, cell_vals):
        return self._psum(segment_sum(cell_vals.reshape(-1), self._scatter_table))

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

    def _k_cell_masked(self, C_tang, dtype=_F):
        """bc-masked element stiffness blocks ``km K km^T`` (padded cells:
        zero): in f64 the blocks of the exact refinement operator, in f32
        those of a factorization or preconditioner."""
        km = self._keep_cell.to(dtype)
        if dtype == _F:
            st = self.statics
            K = torch.einsum("cqik,cqij,cqjl,cq->ckl", st["B"], C_tang, st["B"], st["wdet"])
        else:
            K = self._k_cell32(C_tang)
        return K * km[:, :, None] * km[:, None, :]

    def _bcr_bands(self, C_tang):
        """The flat f32 row bands ``[L | D | U]`` of the bc-masked tangent in
        lattice numbering, with identity bc and padding rows
        (spmd.py:745-763)."""
        plan = self._bcr
        Tflat = self._psum(dedup_write(self._k_cell_masked(C_tang, torch.float32),
                                       plan["bands"]))
        Tflat[plan["diag_fix"]] += 1.0  # unique slots, after the sum over ranks
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

    def _mg_solve(self, C_tang, b, rtol):
        """AMG-preconditioned mixed-precision CG (spmd.py:639-722): the
        hierarchy's f32 values from the current tangent (``mg.mg_setup``),
        f32 PCG with one cycle per iteration inside f64 refinement on the
        exact element-blocked operator (node layout; scalar in scalar
        mode).  In dia mode the f32 iteration runs in the lattice
        numbering, permuted at the refinement-round boundary.  On the card
        the cycle is replayed from a CUDA graph (``mg.cuda_graphed``).
        Returns (dx, inner iterations)."""
        plan = self._mg
        K_cell = self._k_cell_masked(C_tang)
        rt = _mg.mg_setup(plan, K_cell.to(torch.float32))
        mv64 = _mg.ebe_matvec(K_cell, plan["ebe"])
        if self._mg_mv0_mode == "dia":
            mask, l2o, o2l = plan["mask0_lat"], plan["perm0_l2o"], plan["perm0_o2l"]
            inner = {"to_inner": lambda v: v[l2o], "from_inner": lambda v: v[o2l]}
        else:
            mask, inner = self.statics["bc_mask"], {}

        def M32(r):
            z = _mg.vcycle(plan, rt, torch.where(mask, 0.0, r), gamma_coarse=self._mg_gamma)
            return torch.where(mask, r, z)

        # on the card one cycle is hundreds of small launches: replay them
        # from a CUDA graph captured once per update.  Sharded, the cycle
        # of node and scalar mode all-reduces in its level-0 matvec (dia
        # mode's is banded and whole on every rank): a graph can hold an
        # NCCL all-reduce, not gloo's, which stages through the host, so
        # over gloo that cycle runs eager
        mesh = self.device_mesh
        if mesh is None or self._mg_mv0_mode == "dia" or mesh.backend == "nccl":
            M32 = _mg.cuda_graphed(M32, torch.zeros(self.n_dofs, dtype=torch.float32,
                                                    device=self.device))
        return _mg.ir_pcg(mv64, rt["mv0"], M32, b, rtol, self.cg_maxiter, **inner)

    def _elastic_solve(self, C_tang, b, rtol):
        """Mixed-precision CG preconditioned by the lagged inverse
        (spmd.py:601-637): no factorization per Newton update, one (n, n)
        f32 matvec per inner iteration, f64 refinement outside.  Returns
        (dx, inner iterations)."""
        mask = self.statics["bc_mask"]
        K_cell = self._k_cell_masked(C_tang)
        plan = self._el_ebe
        Minv, d32 = self._el_precond

        def M32(r):
            z = d32 * (Minv @ (d32 * torch.where(mask, 0.0, r)))
            return torch.where(mask, r, z)

        return _mg.ir_pcg(_mg.ebe_matvec(K_cell, plan),
                          _mg.ebe_matvec(K_cell.to(torch.float32), plan), M32, b, rtol,
                          self.cg_maxiter)

    def _refresh_elastic(self, C_tang):
        """The lagged preconditioner from the step's last tangent
        (spmd.py:936-953): one dense f32 assembly and SPD inversion per
        load step, through Cholesky, a triangular inverse against I and a
        Gram product (the pivoted-LU inverse where Cholesky breaks down)."""
        mask = self.statics["bc_mask"]
        f32 = torch.float32
        Kd = self._assemble_dense_f32(self._k_cell_masked(C_tang, f32)) + torch.diag(mask.to(f32))
        d = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diagonal(Kd)), min=1e-30))
        self._el_precond = (_bcr._spd_inv_batched(Kd * d[:, None] * d[None, :]), d)

    def _solve(self, C_tang, b, rtol):
        """One Newton update's linear solve: (dx, inner count)."""
        if self.linear_solver == "dense":
            return self._dense_solve(C_tang, b)
        if self.linear_solver == "bcr":
            return self._bcr_solve(C_tang, b, rtol)
        if self.linear_solver == "mg":
            return self._mg_solve(C_tang, b, rtol)
        if self.linear_solver == "elastic":
            return self._elastic_solve(C_tang, b, rtol)
        return self._cg_solve(C_tang, b, rtol, self.cg_maxiter)

    # ------------------------------------------------------------------
    def _newton(self, Du, sigma_n, load, max_it, cg_rtol, norm0_ref):
        """Full Newton solve of one load step (spmd.py:845-935).

        Do-while semantics of the JAX loop: each pass evaluates the
        constitutive kernel and the residual at the CURRENT iterate; a
        converged pass performs no solve and returns sigma at that iterate.
        ``it`` counts updates only and ``max_it`` bounds them; ``norm0_ref``
        NaN means the rtol reference self-initialises from the first
        residual.  With ``fused_forcing`` each update's solve tolerance is
        the Eisenstat-Walker term sqrt(norm / norm0), clipped to
        [cg_rtol, cap] (spmd.py:892-898).  The elastic solver's lagged
        preconditioner is refreshed from the last pass's tangent on the way
        out, as the JAX step does at the end of every execution."""
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
            rtol_it = cg_rtol
            if self.fused_forcing:
                eta = math.sqrt(min(max(norm / max(norm0, 1e-300), 0.0), 1.0))
                rtol_it = min(max(eta, cg_rtol), self.fused_forcing)
            dx, cg_k = self._solve(C_tang, -r, rtol_it)
            Du = Du + dx
            it += 1
            cg_tot += cg_k
        if self.linear_solver == "elastic":
            self._refresh_elastic(C_tang)
        return Du, sigma, norm, it, cg_tot

    def _state_in(self, Du, sigma_n):
        return (torch.as_tensor(Du, dtype=_F, device=self.device),
                torch.as_tensor(sigma_n, dtype=_F, device=self.device))

    def run_step(self, Du, sigma_n, load):
        """One load step: (Du (n,), sigma_n (nc_pad // ranks, nq, 4), load)
        -> (Du_new, sigma (nc_pad // ranks, nq, 4), residual_norm,
        newton_its, cg_its)."""
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
        """(Du, sigma_n) of zeros: Du whole, sigma_n this rank's cells."""
        sig = torch.zeros((self.statics["B"].shape[0], self.nq, 4), dtype=_F, device=self.device)
        Du = torch.zeros(self.n_dofs, dtype=_F, device=self.device)
        return Du, sig

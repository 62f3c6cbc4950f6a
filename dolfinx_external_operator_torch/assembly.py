"""Form assembly: batched element kernels + deterministic global scatter.

The port of ``dolfinx_external_operator_tpu/assembly.py:46-831``.  Each
integral is split into
batches of cells (cells, or the facets of each local facet number); a
batch's geometry, basis tabulations and index tensors are made on the
form's device once, when the form is compiled, and each call evaluates the
integrand once over all cells, basis pairs and quadrature points with
explicit batch axes (``compile.py``), then sums the weighted points.

Where the JAX package wraps one point's evaluation in three ``jax.vmap``
(cells x test x trial), the port carries those axes on every tensor:
``torch.func.vmap`` would walk the tree once per quadrature point under
batching dispatch, and would evaluate argument-free terms per basis pair
unless each level is tracked; with explicit broadcast axes one walk per
call serves every point, and a term without an argument is computed once
per cell and point.

Every scatter is deterministic (``parallel/scatter.py``): vectors, actions
and diagonals sum through one gather table over the test dofs of every
batch, the dense matrix and the sparse one (``matrix_bcoo``) through a
deduplicated table over the flat slots ``row * m + col``.  Each table is
built once per compiled form.

Cell sharding (``parallel.set_default_device_mesh``): a form compiled
under an installed mesh takes this rank's rows of each batch
(``parallel.rank_rows``: the batch padded to a multiple of the rank count
by repeating row 0, the rank's contiguous block), and a ``valid`` mask
zeroes the element tensors of the padded rows, as JAX
``assembly.py:336-392`` does.  ``scalar``, ``vector``, ``action``,
``diagonal``, ``matrix`` and ``matrix_bcoo`` gather the ranks' per-cell
contributions whole (one ``dist.all_gather``, the padded rows sliced off)
and sum them through the unsharded tables on every rank, so their results
are the same on every rank and the unsharded bits for any rank count;
``element_tensors`` stays rank-local.  (A partial sum per rank followed
by ``dist.psum`` moves as many bytes, but its sum order depends on the
rank count: the von Mises demo's final displacement then moved by
3.8e-12 relative from one rank to two, 7.1e-12 in the JAX package from
one device to eight.)

Dirichlet BCs use symmetric elimination with lifting, reproducing the
``apply_lifting`` + ``set_bc`` semantics of the reference SNES shim
(``petsc/petsc.py:55-68``): residual rows at constrained dofs become
``x - g`` and Jacobian rows/cols become identity.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device, sym
from .compile import (
    NB,
    CellBatch,
    Ctx,
    analyze,
    coefficient_inputs,
    eval_expr,
    geometry_factors,
)
from .elements import Element
from .mesh import CELL_FACETS, FACET_CELL, REFERENCE_VERTICES, Mesh
from .parallel.scatter import dedup_table, segment_sum, segment_table
from .quadrature import make_quadrature

__all__ = [
    "assemble_scalar", "assemble_vector", "assemble_matrix",
    "DirichletBC", "dirichletbc", "locate_dofs_topological", "locate_dofs_geometrical",
    "apply_lifting", "set_bc", "create_form", "form",
]

_F = torch.float64


def expr_device(exprs, device=None) -> torch.device:
    """The device of the Functions in ``exprs`` and of the coefficients of
    the external operators there (all must agree); ``device`` if given must
    agree with them; without any, ``device`` resolved (``None``: the
    card)."""
    from .function import Function

    def device_of(t):
        f = t if isinstance(t, Function) else getattr(t, "ref_coefficient", None)
        return None if f is None else f.device

    def indexed(dev):
        dev = resolve_device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    devs = {device_of(t) for e in exprs for t in sym._terminals(e)} - {None}
    if device is not None:
        dev = indexed(device)
        if devs - {dev}:
            raise ValueError(f"coefficients lie on {sorted(map(str, devs))}, not on {dev}")
        return dev
    if len(devs) > 1:
        raise ValueError(f"coefficients lie on several devices: {sorted(map(str, devs))}")
    return devs.pop() if devs else indexed(None)


def _t(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _idx(a, device):
    return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)


# ----------------------------------------------------------------------
# Kernel construction for one integral on one cell batch
# ----------------------------------------------------------------------

def _basis_arrays(space, tab, Jinv, dtype=None):
    """Blocked basis values/gradients for all element dofs of the cells.

    tab = (phi (nq, nb), dphi (nq, nb, tdim)) -- or a list of per-sub tabs
    for mixed spaces.  Jinv (nc, nq, tdim, gdim).
    Returns tv (1, nk, nq, *vs), tg (nc, nk, nq, *vs, gdim) with
    k = i*bs + comp (mixed: sub-space blocks concatenated along k, values
    embedded in the flattened mixed vector shape)."""
    dtype = dtype or _F
    dev = Jinv.device
    if space.num_sub_spaces > 0:
        vs_total = space.value_shape[0]
        g = Jinv.shape[-1]
        nc = Jinv.shape[0]
        tvs, tgs = [], []
        off = 0
        for i in range(space.num_sub_spaces):
            sub = space.sub(i)
            tv_s, tg_s = _basis_arrays(sub, tab[i], Jinv, dtype)
            nk, nq = tv_s.shape[1], tv_s.shape[2]
            bs_s = sub.bs
            tv_pad = torch.zeros((1, nk, nq, vs_total), dtype=dtype, device=dev)
            tv_pad[:, :, :, off: off + bs_s] = tv_s.reshape(1, nk, nq, bs_s)
            tg_pad = torch.zeros((nc, nk, nq, vs_total, g), dtype=dtype, device=dev)
            tg_pad[:, :, :, off: off + bs_s, :] = tg_s.reshape(nc, nk, nq, bs_s, g)
            tvs.append(tv_pad)
            tgs.append(tg_pad)
            off += bs_s
        return torch.cat(tvs, dim=1), torch.cat(tgs, dim=1)
    phi, dphi = tab
    phi = _t(phi, dtype, dev)
    dphi = _t(dphi, dtype, dev)
    bs = space.bs
    vshape = tuple(space.value_shape)
    nq, nb = phi.shape
    gphys = torch.einsum("qbd,cqdg->cqbg", dphi, Jinv)  # (nc, nq, nb, g)
    eye = torch.eye(bs, dtype=dtype, device=dev)
    tv = torch.einsum("qb,ck->bcqk", phi, eye)  # (nb, bs, nq, bs)
    tg = torch.einsum("xqbg,ck->xbcqkg", gphys, eye)  # (nc, nb, bs, nq, bs, g)
    g = gphys.shape[-1]
    nc = gphys.shape[0]
    tv = tv.reshape(1, nb * bs, nq, *vshape)
    tg = tg.reshape(nc, nb * bs, nq, *(vshape + (g,)))
    return tv, tg


def _coeff_tables(plan, Jinv, dtype):
    """Device tabulations of each coefficient of ``plan``: ``(phi, gphys)``
    per (sub-)space, ``gphys`` (nc, nq, nb, g) where gradients are needed."""
    dev = Jinv.device
    out = []
    for f, kind, static in plan:
        if kind == "qp":
            out.append(None)
        elif kind == "tab":
            phi, dphi, needs_grad = static
            gp = (torch.einsum("qbd,cqdg->cqbg", _t(dphi, dtype, dev), Jinv) if needs_grad
                  else None)
            out.append((_t(phi, dtype, dev), gp))
        else:
            tabs, subs, needs_grad = static
            out.append([(_t(phi, dtype, dev),
                         torch.einsum("qbd,cqdg->cqbg", _t(dphi, dtype, dev), Jinv)
                         if needs_grad else None) for phi, dphi in tabs])
    return out


def _batch_form(t, nq, shape):
    """(nc, nq * ...) or (nc, nq, ...) -> (nc, 1, 1, nq) + shape."""
    return t.reshape((t.shape[0], 1, 1, nq) + tuple(shape))


def _coeff_values_at_qps(plan, coeff_cell_data, tables):
    """Evaluate coefficients at all qps of the cells.

    Returns dict f -> (vals (nc, 1, 1, nq, *shape),
    grads (nc, 1, 1, nq, *shape, g) | None)."""
    out = {}
    for (f, kind, static), data, tab in zip(plan, coeff_cell_data, tables):
        vshape = tuple(f.function_space.value_shape)
        nc = data.shape[0]
        if kind == "tab_mixed":
            _, subs, needs_grad = static
            off = 0
            vals_parts, grads_parts = [], []
            for (phi, gp), (nb, bs) in zip(tab, subs):
                d2 = data[:, off: off + nb * bs].reshape(nc, nb, bs)
                off += nb * bs
                vals_parts.append(torch.einsum("qb,cbk->cqk", phi, d2))
                if needs_grad:
                    grads_parts.append(torch.einsum("cqbg,cbk->cqkg", gp, d2))
            vals = torch.cat(vals_parts, dim=2)  # (nc, nq, vs_total)
            nq = vals.shape[1]
            grads = torch.cat(grads_parts, dim=2) if needs_grad else None
            out[f] = (_batch_form(vals, nq, vals.shape[2:]),
                      None if grads is None else _batch_form(grads, nq, grads.shape[2:]))
            continue
        if kind == "qp":
            bs = f.function_space.bs
            nq = data.shape[1] // bs
            out[f] = (_batch_form(data, nq, vshape), None)
        else:
            phi, gp = tab
            _, _, needs_grad = static
            bs = f.function_space.bs
            nq, nb = phi.shape
            d2 = data.reshape(nc, nb, bs)
            vals = torch.einsum("qb,cbk->cqk", phi, d2)
            grads = None
            if needs_grad:
                grads = torch.einsum("cqbg,cbk->cqkg", gp, d2)
                g = gp.shape[-1]
                grads = _batch_form(grads, nq, vshape + (g,))
            out[f] = (_batch_form(vals, nq, vshape), grads)
    return out


class _IntegralKernel:
    """A compiled integral: evaluates element tensors on its cell batches."""

    def __init__(self, integral: sym.Integral, rank: int, mesh: Mesh, device, dtype,
                 device_mesh=None):
        self.device_mesh = device_mesh
        self.integrand = integral.integrand
        self.measure = integral.measure
        self.rank = rank
        self.mesh = mesh
        self.device = device
        self.dtype = dtype
        self.info = analyze(self.integrand)
        self.functions = list(self.info["coeff_vals"])
        self.constants = list(self.info["constants"])
        self.test_space = self.info["arguments"].get(0)
        self.trial_space = self.info["arguments"].get(1)
        assert rank == len(self.info["arguments"]), (
            f"form rank mismatch: expected {rank} arguments, found {sorted(self.info['arguments'])}"
        )

        qd = self.measure.quadrature_degree
        if qd is None:
            degs = [2]
            for f in self.functions:
                degs.append(2 * max(1, f.function_space.element.degree))
            for sp in self.info["arguments"].values():
                degs.append(2 * max(1, sp.element.degree))
            qd = max(degs)
        self.quadrature_degree = int(qd)

        if self.measure.kind == "dx":
            self._setup_cell()
        else:
            self._setup_facet()

    # -- cell integrals ------------------------------------------------
    def _setup_cell(self):
        mesh = self.mesh
        qpts, qwts = make_quadrature(mesh.cell_type, self.quadrature_degree)
        sub_id = self.measure.subdomain_id
        if sub_id is None:
            cells = None
            positions = None
        else:
            if self.measure.subdomain_data is not None and not isinstance(sub_id, np.ndarray):
                cells = np.asarray(self.measure.subdomain_data[sub_id], dtype=np.int32)
            else:
                cells = np.asarray(sub_id, dtype=np.int32)
            positions = np.arange(cells.shape[0], dtype=np.int32)
        batch = CellBatch(mesh, qpts, cells)
        self.batches = [self._make_batch_fn(batch, qwts, facet_dir=None, normal_sign=None,
                                            subset_positions=positions)]

    # -- exterior facet integrals ---------------------------------------
    def _setup_facet(self):
        mesh = self.mesh
        sub_id = self.measure.subdomain_id
        if sub_id is None:
            facets = mesh.exterior_facets
        elif isinstance(sub_id, (str, int)) and self.measure.subdomain_data is not None:
            facets = np.asarray(self.measure.subdomain_data[sub_id], dtype=np.int32)
        else:
            facets = np.asarray(sub_id, dtype=np.int32)  # direct facet-index array

        fcell = FACET_CELL[mesh.cell_type]
        fq, fw = make_quadrature(fcell, self.quadrature_degree)
        ref_verts = REFERENCE_VERTICES[mesh.cell_type]
        self.batches = []
        cells_of = mesh.facet_cells[facets, 0]
        local_of = mesh.facet_local_index[facets, 0]
        # host-side outward orientation sign per facet
        signs = _facet_orientation_signs(mesh, facets)
        for lf in range(len(CELL_FACETS[mesh.cell_type])):
            sel = np.where(local_of == lf)[0]
            if sel.size == 0:
                continue
            fverts_local = np.asarray(CELL_FACETS[mesh.cell_type][lf])
            V = ref_verts[fverts_local]  # (nvf, tdim)
            if fcell == "point":
                pts = V  # (1, tdim)
                D = np.zeros((mesh.tdim, 0))
            else:
                fgeo = Element("Lagrange", fcell, 1)
                phi_f, dphi_f = fgeo.tabulate(fq)
                pts = phi_f @ V  # (nqf, tdim) facet qps in parent ref coords
                # facet direction matrix dX/dt (tdim, tdim_f); constant because
                # the facet geometry map is P1/Q1 evaluated at a fixed point
                # (exact for the affine facets of all supported cells)
                D = V.T @ dphi_f[0]  # (tdim, nvf) @ (nvf, tdim_f)
            batch = CellBatch(mesh, pts, cells=cells_of[sel])
            self.batches.append(
                self._make_batch_fn(batch, fw, facet_dir=D, normal_sign=signs[sel],
                                    subset_positions=sel.astype(np.int32))
            )

    # -- the per-batch element function ---------------------------------
    def _make_batch_fn(self, batch: CellBatch, qwts, facet_dir, normal_sign, subset_positions=None):
        integrand = self.integrand
        info = self.info
        plan = coefficient_inputs(info, batch, self.quadrature_degree if self.measure.kind == "dx" else None)
        rank = self.rank
        test_space, trial_space = self.test_space, self.trial_space
        dt, dev = self.dtype, self.device
        # the dofs of every cell of the batch (host; the form's slot table
        # spans the cells of all ranks)
        all_dofs = {k: None if sp is None else sp.unrolled_dofmap[batch.cells]
                    for k, sp in (("test", test_space), ("trial", trial_space))}
        nc_all = batch.cells.shape[0]
        valid = None
        if self.device_mesh is not None:
            from .parallel import rank_rows

            rows, ok = rank_rows(batch.cells.shape[0], self.device_mesh)
            batch = CellBatch(batch.mesh, batch.points, batch.cells[rows])
            if normal_sign is not None:
                normal_sign = np.asarray(normal_sign)[rows]
            if subset_positions is not None:
                subset_positions = np.asarray(subset_positions)[rows]
            if not ok.all():
                valid = _t(ok, dt, dev)[:, None, None]
        nq = batch.nq
        nc = batch.cells.shape[0]

        # geometry, tabulations and index tensors: made once, on the device
        coords = _t(batch.coords, dt, dev)
        J, Jinv, detJ = geometry_factors(coords, _t(batch.dphi_g, dt, dev))
        if facet_dir is None:
            scale = torch.abs(detJ)  # (nc, nq)
            normal = None
        else:
            nsign = _t(normal_sign, dt, dev)[:, None, None]
            T = torch.einsum("cqgd,df->cqgf", J, _t(facet_dir, dt, dev))  # physical tangents
            if T.shape[-1] == 0:  # point facet (1D mesh)
                scale = torch.ones((nc, nq), dtype=dt, device=dev)
                normal = None
            elif T.shape[-1] == 1:
                tau = T[..., 0]
                scale = torch.sqrt((tau * tau).sum(-1))
                nrm = torch.stack([tau[..., 1], -tau[..., 0]], dim=-1) / scale[..., None]
                normal = nrm * nsign
            else:
                cr = torch.linalg.cross(T[..., 0], T[..., 1], dim=-1)
                scale = torch.sqrt((cr * cr).sum(-1))
                normal = cr / scale[..., None] * nsign
        xq = (torch.einsum("qv,cvg->cqg", _t(batch.phi_g, dt, dev), coords)
              if info["needs_x"] else None)

        def _tab(space):
            if space.num_sub_spaces > 0:
                return [space.sub(i).tabulate(batch.points) for i in range(space.num_sub_spaces)]
            return tuple(np.asarray(a) for a in space.tabulate(batch.points))

        args = {}
        if test_space is not None:
            tv, tg = _basis_arrays(test_space, _tab(test_space), Jinv, dt)
            args[0] = (tv.unsqueeze(2), tg.unsqueeze(2))  # (., nk, 1, nq, ...)
        if trial_space is not None:
            uv, ug = _basis_arrays(trial_space, _tab(trial_space), Jinv, dt)
            args[1] = (uv.unsqueeze(1), ug.unsqueeze(1))  # (., 1, nk, nq, ...)

        tables = _coeff_tables(plan, Jinv, dt)
        cells_t = _idx(batch.cells, dev)
        gathers = [None if p[1] == "qp" else _idx(f.function_space.unrolled_dofmap[batch.cells], dev)
                   for f, p in zip(self.functions, plan)]
        # qp-coefficient row indices: same-mesh -> cell ids; submesh
        # coefficient -> positions within the entity list (codim paths)
        qp_rows = [None if p[1] != "qp" else
                   (cells_t if f.function_space.mesh is self.mesh else _idx(subset_positions, dev))
                   for f, p in zip(self.functions, plan)]
        test_dofs = None if test_space is None else _idx(test_space.unrolled_dofmap[batch.cells], dev)
        trial_dofs = None if trial_space is None else _idx(trial_space.unrolled_dofmap[batch.cells], dev)
        wts = _t(qwts, dt, dev).reshape(1, 1, 1, nq)
        scale = scale.reshape(nc, 1, 1, nq)
        x_b = None if xq is None else xq.reshape(nc, 1, 1, nq, -1)
        n_b = None if normal is None else normal.reshape(nc, 1, 1, nq, -1)
        kinds = [p[1] for p in plan]
        bss = [f.function_space.bs for f in self.functions]
        nt = 1 if test_dofs is None else test_dofs.shape[1]
        nu = 1 if trial_dofs is None else trial_dofs.shape[1]
        statics = {}
        constants = self.constants

        def batch_fn(coeff_datas, const_vals):
            cell_data = []
            for kind, bs, gather, rows, full in zip(kinds, bss, gathers, qp_rows, coeff_datas):
                if kind == "qp":
                    cell_data.append(full.reshape(-1, nq * bs)[rows])
                else:
                    cell_data.append(full[gather])
            cvals = _coeff_values_at_qps(plan, cell_data, tables)
            ctx = Ctx(coeff_val={f: v[0] for f, v in cvals.items()},
                      coeff_grad={f: v[1] for f, v in cvals.items() if v[1] is not None},
                      arg=args, x=x_b, normal=n_b,
                      const={c: v for c, v in zip(constants, const_vals)},
                      dtype=dt, device=dev, statics=statics)
            val = eval_expr(integrand, ctx).expand(nc, nt, nu, nq)
            elem = (val * wts * scale).sum(3)  # (nc, nt, nu)
            if valid is not None:  # padded rows add nothing
                elem = elem * valid
            if rank == 0:
                elem = elem[:, 0, 0]
            elif rank == 1:
                elem = elem[:, :, 0]
            return elem, test_dofs, trial_dofs

        return batch_fn, {"test_dofs": test_dofs, "trial_dofs": trial_dofs, "nc": nc,
                          "nc_all": nc_all, "test_dofs_all": all_dofs["test"],
                          "trial_dofs_all": all_dofs["trial"]}


# ----------------------------------------------------------------------
# Compiled forms
# ----------------------------------------------------------------------

class CompiledForm:
    """A form compiled to batched element kernels on one device.

    Equivalent of ``fem.form(...)`` (FFCx JIT) in the reference.  Its device
    is that of the form's coefficients (``expr_device``).  Compiled under
    an installed device mesh (``parallel.set_default_device_mesh``), it
    holds this rank's rows of each batch (``device_mesh``) and gathers
    the ranks' contributions before it sums them (module docstring)."""

    def __init__(self, form: sym.Form, device=None):
        from .parallel import get_default_device_mesh

        self.device_mesh = get_default_device_mesh()
        self.form = form
        args = form.arguments()
        self.rank = len(args)
        self.test_space = args[0].function_space if self.rank >= 1 else None
        self.trial_space = args[1].function_space if self.rank >= 2 else None
        mesh = _form_mesh(form)
        self.mesh = mesh
        self.device = expr_device([itg.integrand for itg in form.integrals], device)
        self.dtype = _F
        self.kernels = [_IntegralKernel(itg, self.rank, mesh, self.device, self.dtype,
                                        self.device_mesh)
                        for itg in form.integrals]
        # stable global ordering of runtime inputs
        self.functions = []
        self.constants = []
        for k in self.kernels:
            for f in k.functions:
                if f not in self.functions:
                    self.functions.append(f)
            for c in k.constants:
                if c not in self.constants:
                    self.constants.append(c)
        self._plans = [(k, [self.functions.index(f) for f in k.functions],
                        [self.constants.index(c) for c in k.constants]) for k in self.kernels]
        self._row_table = None
        self._matrix_plan = None

    def _whole(self, parts):
        """Per-cell contributions ``parts`` (one per batch, a leading axis
        of this rank's rows) as every batch's contributions over all its
        cells, flat, in the unsharded order: sharded, one
        ``dist.all_gather`` of the rank's concatenated rows, the padded rows
        sliced off (``parts`` flattened without a mesh)."""
        if self.device_mesh is None:
            return [p.reshape(-1) for p in parts]
        from .parallel import dist

        size = self.device_mesh.size
        whole = dist.all_gather(torch.cat([p.reshape(-1) for p in parts]), None,
                                self.device_mesh.group).view(size, -1)
        out, off = [], 0
        for p, s in zip(parts, self._statics()):
            k, w = p.shape[0], p[0].numel()
            out.append(whole[:, off:off + k * w].reshape(size * k, w)[:s["nc_all"]].reshape(-1))
            off += k * w
        return out

    # runtime inputs
    def _inputs(self):
        for f in self.functions:
            if f.data.device != self.device:
                raise ValueError(f"coefficient {f.name} lies on {f.data.device}, the form on {self.device}")
        return ([f.data.to(self.dtype) for f in self.functions],
                [torch.as_tensor(c.value, dtype=self.dtype, device=self.device).reshape((1,) * NB + c.shape)
                 for c in self.constants])

    def _elements(self):
        """[(elem, tdofs, udofs)] over every batch of every integral."""
        coeffs, consts = self._inputs()
        out = []
        for k, fidx, cidx in self._plans:
            for b, _ in k.batches:
                out.append(b([coeffs[i] for i in fidx], [consts[i] for i in cidx]))
        return out

    def _statics(self):
        return [s for k in self.kernels for (_, s) in k.batches]

    def _rows(self):
        """Gather table of the test dofs of every batch (all its cells), in
        batch order."""
        if self._row_table is None:
            tdofs = np.concatenate([s["test_dofs_all"].ravel() for s in self._statics()])
            self._row_table = torch.as_tensor(segment_table(tdofs, self.test_space.num_dofs),
                                              device=self.device)
        return self._row_table

    def _scatter_rows(self, parts):
        """Sum per-(cell, test dof) contributions ``parts`` (one per batch)
        into the test space's dof vector, over every rank's cells."""
        return segment_sum(torch.cat(self._whole(parts)), self._rows())

    def element_tensors(self):
        """Per-batch element tensors + their dof maps, without forming the
        global matrix: ``[(elem (nc, nt, nu), tdofs (nc, nt), udofs (nc, nu))]``.
        Sharded, these are this rank's rows (padded rows zero): an
        operator built on them sums over every rank's cells in its own
        scatter (``_scatter_rows``)."""
        return self._elements()

    def action(self, x):
        """Matrix-free operator action ``A @ x`` of a rank-2 form."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return self._scatter_rows([torch.einsum("cij,cj->ci", e, x[ud])
                                   for e, _, ud in self._elements()])

    def diagonal(self):
        """Global matrix diagonal (for Jacobi preconditioning) without
        forming the matrix."""
        return self._scatter_rows([(e * (td[:, :, None] == ud[:, None, :]).to(e.dtype)).sum(2)
                                   for e, td, ud in self._elements()])

    def scalar(self):
        total = torch.zeros((), dtype=self.dtype, device=self.device)
        for elem in self._whole([e for e, _, _ in self._elements()]):
            total = total + elem.sum()
        return total

    def vector(self):
        return self._scatter_rows([e for e, _, _ in self._elements()])

    def _slot_plan(self):
        """The deduplicated table over the flat slots ``row * m + col`` of
        every batch's element entries (all its cells;
        ``scatter.dedup_table``), built on the first call: ``(table, slots,
        size)``, ``slots`` the form's sorted unique slots."""
        n, m = self.test_space.num_dofs, self.trial_space.num_dofs
        if self._matrix_plan is None:
            slots = np.concatenate([
                (s["test_dofs_all"][:, :, None] * m + s["trial_dofs_all"][:, None, :]).ravel()
                for s in self._statics()])
            self._matrix_plan = dedup_table(slots, n * m, self.device)
        return self._matrix_plan

    def _slot_values(self):
        """The summed value of each unique slot (``_slot_plan``)."""
        return segment_sum(torch.cat(self._whole([e for e, _, _ in self._elements()])),
                           self._slot_plan()[0])

    def matrix(self):
        """The dense (n, m) matrix, summed through the deduplicated slot
        table."""
        n, m = self.test_space.num_dofs, self.trial_space.num_dofs
        _, slots, size = self._slot_plan()
        out = torch.zeros(size, dtype=self.dtype, device=self.device)
        out[slots] = self._slot_values()
        return out.reshape(n, m)

    def matrix_bcoo(self):
        """The assembled sparse (n, m) matrix with its duplicates summed,
        the analog of the reference's PETSc AIJ matrices: a coalesced
        ``torch.sparse_coo_tensor`` on the form's device.  Duplicates are
        summed through the deduplicated slot table (no ``coalesce()`` on
        the device); its unique slots are sorted, so the indices are in
        row-major order."""
        n, m = self.test_space.num_dofs, self.trial_space.num_dofs
        slots = self._slot_plan()[1]
        vals = self._slot_values()
        return torch.sparse_coo_tensor(torch.stack([slots // m, slots % m]), vals, (n, m),
                                       is_coalesced=True, check_invariants=False)


def _form_mesh(form: sym.Form) -> Mesh:
    for itg in form.integrals:
        if itg.measure.domain is not None:
            return itg.measure.domain
        for t in sym._terminals(itg.integrand):
            fs = getattr(t, "function_space", None)
            if fs is not None:
                return fs.mesh
            if hasattr(t, "mesh"):
                return t.mesh
    raise ValueError("cannot determine mesh of form")


def create_form(f: sym.Form, device=None) -> CompiledForm:
    """Compile (once: the result is kept on the form) on the device of the
    form's coefficients, or on ``device`` when it has none."""
    if isinstance(f, CompiledForm):
        return f
    compiled = getattr(f, "_compiled", None)
    if compiled is None:
        compiled = CompiledForm(f, device)
        f._compiled = compiled
    return compiled


# dolfinx-parity alias: fem.form(...)
form = create_form


def assemble_scalar(f, device=None) -> torch.Tensor:
    return create_form(f, device).scalar()


def assemble_vector(f, device=None) -> torch.Tensor:
    return create_form(f, device).vector()


def assemble_matrix(f, bcs=(), device=None) -> torch.Tensor:
    A = create_form(f, device).matrix()
    if bcs:
        A = _apply_bc_matrix(A, bcs)
    return A


# ----------------------------------------------------------------------
# Dirichlet boundary conditions
# ----------------------------------------------------------------------

class DirichletBC:
    """dofs: unrolled global dof indices; values: per-dof prescribed values."""

    def __init__(self, dofs: np.ndarray, values: np.ndarray):
        self.dofs = np.asarray(dofs, dtype=np.int64)
        self.values = np.broadcast_to(np.asarray(values, dtype=np.float64), self.dofs.shape).copy()

    def set(self, values):
        self.values = np.broadcast_to(np.asarray(values, dtype=np.float64), self.dofs.shape).copy()


def dirichletbc(value, dofs, V=None) -> DirichletBC:
    """Mirror of ``fem.dirichletbc`` usage in the demos
    (``demo_plasticity_von_mises.py:219-220``,
    ``demo_plasticity_mohr_coulomb.py:142-145``)."""
    from .functionspace import ComponentSubspace

    dofs = np.asarray(dofs)
    value = np.asarray(getattr(value, "value", value), dtype=np.float64)
    if isinstance(V, ComponentSubspace) or value.ndim == 0:
        return DirichletBC(dofs, value.reshape(-1)[0] if value.ndim else value)
    # blocked space with vector value: expand per component
    bs = value.shape[0]
    unrolled = (dofs[:, None] * bs + np.arange(bs)[None, :]).ravel()
    vals = np.tile(value, dofs.shape[0])
    return DirichletBC(unrolled, vals)


def locate_dofs_topological(V, dim, entities) -> np.ndarray:
    """Scalar-block (full space) or unrolled (component subspace) dofs on
    the given facets.  Mirrors ``fem.locate_dofs_topological``
    (``demo_plasticity_von_mises.py:216-217``)."""
    from .functionspace import ComponentSubspace

    comp = None
    if isinstance(V, ComponentSubspace):
        comp = V.component
        V = V.parent
    mesh = V.mesh
    entities = np.asarray(entities, dtype=np.int32)
    counts = V.element.entity_counts
    offs = getattr(V, "_entity_offsets", {"vertex": 0, "edge": mesh.num_vertices})
    sdofs = set()
    fverts = mesh.facets[entities]
    if counts["vertex"]:
        sdofs.update(np.unique(fverts).tolist())
    ne = counts["edge"]
    if ne:
        edge_lookup = {tuple(e): i for i, e in enumerate(np.sort(mesh.edges, axis=1).tolist())}
        base = offs["edge"]
        for fv in fverts:
            vs = sorted(fv.tolist())
            for a in range(len(vs)):
                for b in range(a + 1, len(vs)):
                    e = edge_lookup.get((vs[a], vs[b]))
                    if e is not None:
                        sdofs.update(range(base + e * ne, base + (e + 1) * ne))
    nf = counts.get("face", 0)
    if nf:
        base = offs["face"]
        for f in entities.astype(np.int64).tolist():
            sdofs.update(range(base + f * nf, base + (f + 1) * nf))
    sdofs = np.array(sorted(sdofs), dtype=np.int64)
    if comp is None:
        return sdofs
    return sdofs * V.bs + comp


def locate_dofs_geometrical(V, marker) -> np.ndarray:
    """Scalar-block dofs whose coordinates satisfy ``marker`` (dolfinx
    parity: ``demo_plasticity_mohr_coulomb.py:139-140``)."""
    from .functionspace import ComponentSubspace

    comp = None
    if isinstance(V, ComponentSubspace):
        comp = V.component
        V = V.parent
    coords = _dof_coordinates(V)
    x = np.zeros((3, coords.shape[0]))
    x[: coords.shape[1]] = coords.T
    mask = np.asarray(marker(x), dtype=bool)
    sdofs = np.where(mask)[0].astype(np.int64)
    if comp is None:
        return sdofs
    return sdofs * V.bs + comp


def _dof_coordinates(V) -> np.ndarray:
    mesh = V.mesh
    ip = V.element.interpolation_points
    geo = Element("Lagrange", mesh.cell_type, 1)
    phi, _ = geo.tabulate(ip)
    pts = np.einsum("pv,cvg->cpg", phi, mesh.points[mesh.cells])
    coords = np.zeros((V.num_scalar_dofs, mesh.gdim))
    coords[V.dofmap.ravel()] = pts.reshape(-1, mesh.gdim)
    return coords


def _facet_orientation_signs(mesh: Mesh, facets: np.ndarray) -> np.ndarray:
    """+1 if the batch's normal formula points outward, else -1 (host)."""
    cells = mesh.facet_cells[facets, 0]
    lfs = mesh.facet_local_index[facets, 0]
    signs = np.ones(facets.shape[0])
    cell_mid = mesh.points[mesh.cells[cells]].mean(axis=1)
    facet_mid = mesh.facet_midpoints(facets)
    ref_verts = REFERENCE_VERTICES[mesh.cell_type]
    geo = Element("Lagrange", mesh.cell_type, 1)
    for i, (c, lf) in enumerate(zip(cells, lfs)):
        fverts_local = np.asarray(CELL_FACETS[mesh.cell_type][lf])
        V = ref_verts[fverts_local]
        center = V.mean(axis=0, keepdims=True)
        _, dphi = geo.tabulate(center)
        coords = mesh.points[mesh.cells[c]]
        J = np.einsum("vd,vg->gd", dphi[0], coords)
        if mesh.tdim == 1:
            n_cand = np.array([1.0])
        elif mesh.tdim == 2:
            Df = V.T @ Element("Lagrange", "interval", 1).tabulate(np.array([[0.5]]))[1][0]
            tau = J @ Df[:, 0]
            n_cand = np.array([tau[1], -tau[0]])
        else:
            fcell = FACET_CELL[mesh.cell_type]
            fgeo = Element("Lagrange", fcell, 1)
            fc = np.mean(REFERENCE_VERTICES[fcell], axis=0, keepdims=True)
            Dref = V.T @ fgeo.tabulate(fc)[1][0]
            T = J @ Dref
            n_cand = np.cross(T[:, 0], T[:, 1])
        out_dir = facet_mid[i] - cell_mid[i]
        signs[i] = 1.0 if float(n_cand @ out_dir) >= 0 else -1.0
    return signs


# ----------------------------------------------------------------------
# BC application (lifting / set_bc semantics, cf. petsc/petsc.py:55-68)
# ----------------------------------------------------------------------

def bc_arrays(bcs, n: int, device=None, dtype=torch.float64):
    """Merge BCs into (mask (n,), values (n,)) tensors on ``device``."""
    mask = np.zeros(n, dtype=bool)
    vals = np.zeros(n, dtype=np.float64)
    for bc in bcs:
        mask[bc.dofs] = True
        vals[bc.dofs] = bc.values
    dev = resolve_device(device)
    return torch.as_tensor(mask, device=dev), torch.as_tensor(vals, dtype=dtype, device=dev)


def _apply_bc_matrix(A, bcs):
    n = A.shape[0]
    mask, _ = bc_arrays(bcs, n, A.device, A.dtype)
    keep = (~mask).to(A.dtype)
    A = A * keep[:, None] * keep[None, :]
    return A + torch.diag(mask.to(A.dtype))


def apply_lifting(b, J_form, bcs, x0, scale=-1.0):
    """b -= scale * A @ (g - x0) on free rows -- DOLFINx ``apply_lifting``
    semantics (reference call in ``petsc/petsc.py:66``): with the usual
    ``scale=-1.0`` this ADDS ``A @ (g - x0)`` so that solving
    ``J delta = -b`` yields the correctly lifted Newton update."""
    A = create_form(J_form, b.device).matrix()
    n = b.shape[0]
    mask, g = bc_arrays(bcs, n, b.device, b.dtype)
    dx = torch.where(mask, g - x0, torch.zeros((), dtype=b.dtype, device=b.device))
    return b - scale * (A @ dx)


def set_bc(b, bcs, x0=None, scale=-1.0):
    """b[bc] = scale * (g - x0[bc]) (reference ``set_bc`` in
    ``petsc/petsc.py:68``)."""
    n = b.shape[0]
    mask, g = bc_arrays(bcs, n, b.device, b.dtype)
    tgt = scale * (g - (0.0 if x0 is None else x0))
    return torch.where(mask, tgt, b)

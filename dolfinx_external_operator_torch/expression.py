"""Expression evaluation at reference points on cells.

The port of ``dolfinx_external_operator_tpu/expression.py:33-166``, the
operand -> quadrature-point interpolation engine of the reference
(``external_operator.py:393-402``): a gather of cell dofs against basis
tabulations made once on the device, with per-cell inverse Jacobians for
gradients, and the expression walked once per call over all cells and
points with explicit batch axes (``compile.py``).

Compiled under an installed device mesh (``parallel.
set_default_device_mesh``), an evaluation takes this rank's rows of the
cell list (``parallel.rank_rows``, as JAX ``expression.py:78-100`` pads
and shards them): ``eval`` returns the whole array on every rank, as the
JAX package's global array is, through one ``dist.all_gather`` with the
padding sliced off, and ``eval_local`` the rank's rows (padded rows
repeat row 0), which ``evaluate_operands`` hands to the external
function.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sym
from .compile import NB, CellBatch, Ctx, analyze, coefficient_inputs, eval_expr, geometry_factors
from .mesh import Mesh

__all__ = ["Expression"]

_F = torch.float64


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class Expression:
    """Evaluate a symbolic expression at fixed reference points on cells.

    ``eval(mesh, cells)`` returns a tensor of shape (n_cells, n_points) for
    scalar expressions or (n_cells, n_points, value_size) otherwise --
    matching the layout the reference demos unpack
    (``C_tang_impl``: ``deps.shape == (num_cells, num_q, 4)``,
    ``demo_plasticity_von_mises.py:343-348``).  It runs on the device of
    the expression's coefficients (``assembly.expr_device``)."""

    def __init__(self, expr: sym.Expr, points: np.ndarray, dtype=None, device=None):
        from .assembly import expr_device

        self.expr = sym.as_expr(expr)
        self.points = np.asarray(points, dtype=np.float64)
        self.dtype = dtype or _F
        self.device = expr_device([self.expr], device)
        self.info = analyze(self.expr)
        assert not self.info["arguments"], "Expression cannot contain test/trial functions"
        self.functions = list(self.info["coeff_vals"])
        self.constants = list(self.info["constants"])
        self._cache = {}

    def _compile(self, mesh: Mesh, cells, device_mesh=None):
        from .assembly import _coeff_tables, _coeff_values_at_qps, _idx, _t

        batch = CellBatch(mesh, self.points, cells)
        if device_mesh is not None:
            from .parallel import rank_rows

            batch = CellBatch(mesh, self.points,
                              batch.cells[rank_rows(batch.cells.shape[0], device_mesh)[0]])
        plan = coefficient_inputs(self.info, batch)
        expr = self.expr
        nq = batch.nq
        nc = batch.cells.shape[0]
        dt, dev = self.dtype, self.device
        coords = _t(batch.coords, dt, dev)
        _, Jinv, _ = geometry_factors(coords, _t(batch.dphi_g, dt, dev))
        xq = (torch.einsum("qv,cvg->cqg", _t(batch.phi_g, dt, dev), coords).reshape(nc, 1, 1, nq, -1)
              if self.info["needs_x"] else None)
        tables = _coeff_tables(plan, Jinv, dt)
        cells_t = _idx(batch.cells, dev)
        gathers = [None if p[1] == "qp" else _idx(f.function_space.unrolled_dofmap[batch.cells], dev)
                   for f, p in zip(self.functions, plan)]
        kinds = [p[1] for p in plan]
        bss = [f.function_space.bs for f in self.functions]
        vshape = expr.shape
        constants = self.constants
        statics = {}

        def run(coeff_datas, const_vals):
            cell_data = []
            for kind, bs, gather, full in zip(kinds, bss, gathers, coeff_datas):
                if kind == "qp":
                    cell_data.append(full.reshape(-1, nq * bs)[cells_t])
                else:
                    cell_data.append(full[gather])
            cvals = _coeff_values_at_qps(plan, cell_data, tables)
            ctx = Ctx(coeff_val={f: v[0] for f, v in cvals.items()},
                      coeff_grad={f: v[1] for f, v in cvals.items() if v[1] is not None},
                      x=xq, const={c: v for c, v in zip(constants, const_vals)},
                      dtype=dt, device=dev, statics=statics)
            vals = eval_expr(expr, ctx).expand((nc, 1, 1, nq) + vshape)
            vals = vals.reshape((nc, nq) + vshape)
            if vshape == ():
                return vals
            return vals.reshape(nc, nq, _prod(vshape))

        return run

    def eval(self, mesh: Mesh, cells: np.ndarray | None = None):
        """Evaluate on cells (``cells`` = indices or None for all), or on
        facets when ``cells`` is an (n, 2) array of (parent_cell,
        local_facet) pairs -- the codim-1 operand path (reference
        ``test_codim_external_operator.py:75-124``; dolfinx
        ``Expression.eval`` entity convention).  The whole array on every
        rank."""
        if cells is not None and np.asarray(cells).ndim == 2:
            return self._eval_facets(mesh, np.asarray(cells, dtype=np.int32))
        vals, n, device_mesh = self._eval_rows(mesh, cells)
        if device_mesh is None:
            return vals
        from .parallel import dist

        return dist.all_gather(vals, n, device_mesh.group)

    def eval_local(self, mesh: Mesh, cells: np.ndarray | None = None):
        """``eval``'s rows of this rank (``parallel.rank_rows`` of the cell
        or facet list; padded rows repeat row 0): the whole array without
        a device mesh."""
        from .parallel import get_default_device_mesh, rank_rows

        if cells is not None and np.asarray(cells).ndim == 2:
            vals = self._eval_facets(mesh, np.asarray(cells, dtype=np.int32))
            device_mesh = get_default_device_mesh()
            if device_mesh is None:
                return vals
            rows = rank_rows(vals.shape[0], device_mesh)[0]
            return vals[torch.as_tensor(rows, device=vals.device)]
        return self._eval_rows(mesh, cells)[0]

    def _eval_rows(self, mesh, cells):
        """(this rank's rows of the evaluation, the cell count, the mesh
        they were compiled under)."""
        from .parallel import get_default_device_mesh

        device_mesh = get_default_device_mesh()
        # content-hash the cell subset and key on the layout: two subsets,
        # or two layouts, must never share compiled statics (they bake in
        # the gathered cells)
        layout = None if device_mesh is None else (device_mesh.rank, device_mesh.size)
        key = (layout, None if cells is None else np.asarray(cells, dtype=np.int64).tobytes())
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = self._compile(mesh, cells, device_mesh)
        coeffs = [f.data.to(self.dtype) for f in self.functions]
        consts = [torch.as_tensor(c.value, dtype=self.dtype, device=self.device).reshape((1,) * NB + c.shape)
                  for c in self.constants]
        n = mesh.num_cells if cells is None else len(cells)
        return fn(coeffs, consts), n, device_mesh

    def _eval_facets(self, mesh: Mesh, entities: np.ndarray):
        """Facet-point evaluation: self.points live on the FACET reference
        cell; map them into each parent cell via the local-facet geometry."""
        from .elements import Element
        from .mesh import CELL_FACETS, FACET_CELL, REFERENCE_VERTICES

        key = ("facets", entities.tobytes())
        plans = self._cache.get(key)
        if plans is None:
            fcell = FACET_CELL[mesh.cell_type]
            ref_verts = REFERENCE_VERTICES[mesh.cell_type]
            fgeo = Element("Lagrange", fcell, 1)
            phi_f, _ = fgeo.tabulate(self.points)
            plans = []
            for lf in range(len(CELL_FACETS[mesh.cell_type])):
                sel = np.where(entities[:, 1] == lf)[0]
                if sel.size == 0:
                    continue
                V = ref_verts[np.asarray(CELL_FACETS[mesh.cell_type][lf])]
                pts = phi_f @ V  # facet qps in parent ref coords
                sub_expr = Expression(self.expr, pts, dtype=self.dtype, device=self.device)
                plans.append((torch.as_tensor(sel, dtype=torch.int64, device=self.device),
                              sub_expr, entities[sel, 0]))
            self._cache[key] = plans
        nq = self.points.shape[0]
        vsize = _prod(self.expr.shape)
        n = entities.shape[0]
        shape = (n, nq) if self.expr.shape == () else (n, nq, vsize)
        out = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for sel, sub_expr, cells in plans:
            out[sel] = sub_expr.eval(mesh, cells)
        return out

"""The external-operator core: symbolic node + evaluation pipeline.

The port of ``dolfinx_external_operator_tpu/external_operator.py:52-447``,
with the reference package's four-function user contract
(``src/dolfinx_external_operator/external_operator.py``):

1. ``FEMExternalOperator(*operands, function_space=Q, external_function=f)``
   -- symbolic node owning a global quadrature-space coefficient;
2. ``replace_external_operators(form) -> (form', ops)``;
3. ``evaluate_operands(ops) -> {operand: tensor}``;
4. ``evaluate_external_operators(ops, operands)`` with derivative
   multi-index dispatch and the tuple-aux-output protocol.

Form differentiation is eager (``sym.derivative``), and derivative nodes
are cached on the parent operator, as in the JAX package.  The callback
receives device tensors (the operands at the points, then the hidden
operands' dof tensors) and returns device tensors; its result is written
into the operator's coefficient on the coefficient's device.

Under an installed device mesh (``parallel.set_default_device_mesh``)
each rank evaluates the operands at its own points (``Expression.
eval_local``) and the external function runs on those points only, with
the rank's rows of every hidden quadrature-space operand; each result is
gathered whole (``dist.all_gather``) before it is written back, so the
coefficients stay whole and identical on every rank and the write-back
plans are the unsharded ones.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sym
from .elements import Element, element as make_element, mixed_element, quadrature_element
from .expression import Expression
from .function import Function, _owned
from .functionspace import FunctionSpace, functionspace

__all__ = [
    "FEMExternalOperator",
    "evaluate_operands",
    "evaluate_external_operators",
    "replace_external_operators",
    "unique_external_operators",
]


def _new_element_from_new_shape(element: Element, diff_shape, mesh) -> Element:
    """Element with value shape extended by the derivative multi-index shape
    (reference ``new_element_from_new_shape``, ``external_operator.py:29-46``)."""
    new_shape = tuple(element.value_shape) + tuple(diff_shape)
    if element.family == "quadrature":
        return quadrature_element(mesh.cell_name(), degree=element.degree, value_shape=new_shape)
    return make_element(
        element.family, mesh.cell_name(), element.degree, shape=new_shape,
        discontinuous=element.discontinuous,
    )


def _last_writer(dst):
    """(unique destinations, position of the last write to each): an
    assignment ``data[dst] = vals`` whose repeated destinations keep the
    last value, in the same order on every device."""
    dst = np.asarray(dst, dtype=np.int64).ravel()
    rev_uniq, rev_first = np.unique(dst[::-1], return_index=True)
    return rev_uniq, dst.size - 1 - rev_first


class FEMExternalOperator(sym.Expr):
    """Finite element external operator (symbolic node + owned coefficient).

    Its coefficient lives on the device of its operands' coefficients, or
    on ``device`` (``None`` with no coefficient operand: the card)."""

    def __init__(
        self,
        *operands,
        function_space: FunctionSpace,
        external_function=None,
        derivatives: tuple | None = None,
        name: str | None = None,
        coefficient: Function | None = None,
        argument_slots=(),
        dtype=None,
        hidden_operands=None,
        device=None,
    ):
        from .assembly import expr_device

        self.ufl_operands = tuple(sym.as_expr(o) for o in operands)
        for operand in self.ufl_operands:
            fs = getattr(operand, "function_space", None)
            if fs is not None and getattr(fs.element, "is_mixed", False):
                raise TypeError(
                    "Mixed element coefficients are not supported as external-operator operands: "
                    f"operand {operand} is a mixed-space coefficient."
                )
        if coefficient is not None and coefficient.function_space != function_space:
            raise TypeError("The provided coefficient must be defined on the same function space as the operator.")

        self.function_space = function_space  # the *undifferentiated* space
        self.derivatives = tuple(derivatives) if derivatives is not None else (0,) * len(self.ufl_operands)
        assert len(self.derivatives) == len(self.ufl_operands)
        self.argument_slots = tuple(argument_slots)
        self.name = name
        # extra state arrays passed positionally to the kernel after the
        # operands (the reference reads module globals instead, e.g.
        # sigma_n in demo_plasticity_von_mises.py:347)
        self.hidden_operands = tuple(hidden_operands or ())

        # derivative shape law: shape(dN) = shape(N) + sum_i shape(o_i) * e_i
        diff_shape = ()
        for i, e in enumerate(self.derivatives):
            diff_shape += tuple(self.ufl_operands[i].shape) * e

        if diff_shape != ():
            mesh = function_space.mesh
            original = function_space.element
            if getattr(original, "is_mixed", False):
                subs = [_new_element_from_new_shape(se, diff_shape, mesh) for se in original.sub_elements]
                new_element = mixed_element(subs)
            else:
                new_element = _new_element_from_new_shape(original, diff_shape, mesh)
            self.ref_function_space = functionspace(mesh, new_element)
        else:
            self.ref_function_space = function_space

        self.shape = tuple(self.ref_function_space.value_shape)
        self.operands = ()  # treated as a terminal by the generic DAG walkers

        # evaluation points & write-back plan
        el = self.ref_function_space.element
        self._is_mixed = getattr(el, "is_mixed", False)
        if self._is_mixed:
            self._setup_mixed_plan()
        else:
            self.eval_points = el.interpolation_points
            is_contiguous = el.family in ("quadrature", "DG")
            if is_contiguous:
                self.unrolled_dofmap = None
                self._assign_func = self._assign_non_mixed_contiguous
            else:
                self.unrolled_dofmap = self.ref_function_space.unrolled_dofmap
                self._assign_func = self._assign_non_mixed

        if coefficient is not None:
            self.ref_coefficient = coefficient
        else:
            hidden = [h for h in self.hidden_operands if isinstance(h, Function)]
            dev = expr_device(list(self.ufl_operands) + hidden, device)
            self.ref_coefficient = Function(self.ref_function_space, name=name, dtype=dtype, device=dev)
        self.external_function = external_function
        self._derivative_cache = {}
        self._compiled_operands = {}

    # -- mixed-space layout (reference external_operator.py:137-198) -----
    def _setup_mixed_plan(self):
        points = []
        val_sizes = []
        V = self.ref_function_space
        for i in range(V.num_sub_spaces):
            Vi = V.sub(i)
            points.append(Vi.element.interpolation_points)
            vs = Vi.value_shape
            val_sizes.append(int(np.prod(vs)) if vs else 1)
        self.eval_points = np.concatenate(points)
        self._comp_size = max(val_sizes) if val_sizes else 1
        self._mixed_subspace_info = []
        offset = 0
        for i in range(V.num_sub_spaces):
            Vi = V.sub(i)
            n_pts = Vi.element.interpolation_points.shape[0]
            val_size = val_sizes[i]
            if self._comp_size < val_size:
                raise ValueError(f"Unsupported mixed element layout for subspace {i}")
            flat_dofs = (Vi.unrolled_dofmap + Vi.sub_offset).ravel()
            self._mixed_subspace_info.append(
                {
                    "n_pts": n_pts,
                    "val_size": val_size,
                    "dofs_per_cell": Vi.unrolled_dofmap.shape[1],
                    "flat_dofs": flat_dofs,
                    "offset": offset,
                }
            )
            offset += n_pts
        self._n_points_total = offset
        self._assign_func = self._assign_mixed_2d if self._comp_size == 1 else self._assign_mixed_3d

    # -- symbolic identity ------------------------------------------------
    def _key(self):
        return ("FEMExternalOperator", id(self))

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __str__(self):
        d = "\N{PARTIAL DIFFERENTIAL}"
        nm = self.name if self.name is not None else "e"
        d_ops = "".join(d + "o" + str(i + 1) for i, di in enumerate(self.derivatives) for _ in range(di))
        s = f"{nm}({', '.join(str(o) for o in self.ufl_operands)})"
        return s + "/" + d_ops if sum(self.derivatives) > 0 else s

    def filtering_hash(self):
        return (tuple(id(o) for o in self.ufl_operands), self.derivatives, id(self.function_space))

    # -- differentiation ---------------------------------------------------
    def _derivative_node(self, i: int) -> "FEMExternalOperator":
        """dN/do_i: a new operator with the multi-index incremented at i
        (reference ``_ufl_expr_reconstruct_``, ``external_operator.py:221-254``).
        Cached so repeated ``derivative()`` calls reuse one coefficient."""
        hit = self._derivative_cache.get(i)
        if hit is not None:
            return hit
        new_derivs = tuple(e + (1 if j == i else 0) for j, e in enumerate(self.derivatives))
        d = "\N{PARTIAL DIFFERENTIAL}"
        d_ops = "/" + "".join(d + "o" + str(j + 1) for j, dj in enumerate(new_derivs) for _ in range(dj))
        node = type(self)(
            *self.ufl_operands,
            function_space=self.function_space,
            external_function=self.external_function,
            derivatives=new_derivs,
            name=d + (self.ref_coefficient.name or "e") + d_ops,
            dtype=self.ref_coefficient.dtype,
            hidden_operands=self.hidden_operands,
            device=self.ref_coefficient.device,
        )
        self._derivative_cache[i] = node
        return node

    def _contract_with_direction(self, direction, n: int):
        """Contract this (derivative) operator's trailing ``n`` axes with a
        direction expression (the chain-rule action).

        Non-mixed: plain trailing-axis tensordot
        (reference ``_apply_derivative_tensor``, ``external_operator.py:463-486``).
        Mixed: the flattened mixed value interleaves per-sub blocks of shape
        ``sub_shape + diff_shape`` -- split per component, contract each, then
        re-flatten (reference ``_replace_action``, ``:528-534``)."""
        if not self._is_mixed:
            return sym.tensordot(self, direction, n)
        orig = self.function_space
        entries = []
        offset = 0

        def _prod(shape):
            p = 1
            for s in shape:
                p *= s
            return p

        for i in range(self.ref_function_space.num_sub_spaces):
            sub_shape_full = tuple(self.ref_function_space.sub(i).value_shape)
            orig_shape = tuple(orig.sub(i).value_shape)
            size_full = _prod(sub_shape_full)
            comp = sym.as_tensor(
                [sym.indexed(self, (offset + k,)) for k in range(size_full)], sub_shape_full
            )
            applied = sym.tensordot(comp, direction, n) if n > 0 else sym.mul(comp, direction)
            # flatten applied (shape == orig_shape) to scalar entries
            if orig_shape == ():
                entries.append(applied)
            else:
                for idx in np.ndindex(orig_shape):
                    entries.append(sym.indexed(applied, idx))
            offset += size_full
        return sym.as_tensor(entries, (len(entries),))

    def _reconstruct_with_operands(self, new_operands):
        if all(n is o for n, o in zip(new_operands, self.ufl_operands)):
            return self
        return type(self)(
            *new_operands,
            function_space=self.function_space,
            external_function=self.external_function,
            derivatives=self.derivatives,
            name=self.name,
            coefficient=self.ref_coefficient,
            hidden_operands=self.hidden_operands,
        )

    # -- write-back plans (reference external_operator.py:286-335) ---------
    #
    # Index plans are made once (lazily) on the coefficient's device; each
    # assignment is then one gather and one indexed write into a fresh
    # tensor.  Where a dof is written by several cells, the last cell's
    # value is kept (``_last_writer``), on every device alike.

    def _assign_non_mixed_contiguous(self, values):
        f = self.ref_coefficient
        f._data = _owned(values, f._data).reshape(f._data.shape)

    def _assign_non_mixed(self, values):
        f = self.ref_coefficient
        plan = getattr(self, "_assign_plan", None)
        if plan is None:
            dst, src = _last_writer(self.unrolled_dofmap.ravel())
            plan = self._assign_plan = (torch.as_tensor(dst, device=f.device),
                                        torch.as_tensor(src, device=f.device))
        self._write(plan, values)

    def _write(self, plan, values):
        f = self.ref_coefficient
        dst, src = plan
        vals = torch.as_tensor(values, dtype=f.dtype, device=f.device).reshape(-1)
        data = f._data.clone()
        data[dst] = vals[src]
        f._data = data

    def _mixed_scatter_plan(self):
        """(dst, src): data[dst] = values.ravel()[src], covering every
        subspace block in one scatter."""
        plan = getattr(self, "_mixed_plan", None)
        if plan is not None:
            return plan
        npt = self._n_points_total
        comp = self._comp_size
        dst_l, src_l = [], []
        for info in self._mixed_subspace_info:
            fd = np.asarray(info["flat_dofs"]).ravel()
            n_cells = fd.size // info["dofs_per_cell"]
            off, n_pts, vs = info["offset"], info["n_pts"], info["val_size"]
            c = np.repeat(np.arange(n_cells), info["dofs_per_cell"])
            if comp == 1:
                p = np.tile(np.arange(off, off + n_pts), n_cells)
                src = c * npt + p
            else:
                p = np.tile(np.repeat(np.arange(off, off + n_pts), vs), n_cells)
                v = np.tile(np.arange(vs), n_cells * n_pts)
                src = (c * npt + p) * comp + v
            dst_l.append(fd)
            src_l.append(src)
        dst, last = _last_writer(np.concatenate(dst_l))
        dev = self.ref_coefficient.device
        plan = (torch.as_tensor(dst, device=dev), torch.as_tensor(np.concatenate(src_l)[last], device=dev))
        self._mixed_plan = plan
        return plan

    def _assign_mixed_2d(self, values):
        self._write(self._mixed_scatter_plan(), values)

    _assign_mixed_3d = _assign_mixed_2d


# ----------------------------------------------------------------------
# Evaluation pipeline
# ----------------------------------------------------------------------

def evaluate_operands(external_operators, entities=None):
    """Evaluate each unique operand at the operators' quadrature points.

    Per-operand ``Expression`` objects are cached on the operator; nested
    external-operator operands recurse.  ``entities`` restricts the cell
    set (codim-0 submesh case), or gives (parent_cell, local_facet) pairs
    for an operator on a facet ``mesh.Submesh`` quadrature space.

    Returns a dict mapping operand -> tensor of shape (n_cells, n_pts) or
    (n_cells, n_pts, value_size) on the operator's device.  Under a device
    mesh the leading axis holds this rank's rows of the cells or entities
    (``Expression.eval_local``), and the dict carries that layout
    (``layout``: the entities and the mesh) to
    ``evaluate_external_operators``.
    """
    from .parallel import get_default_device_mesh

    if len(external_operators) == 0:
        return {}
    evaluated = _Operands()
    evaluated.layout = (entities, get_default_device_mesh())
    for ex_op in external_operators:
        mesh = _operand_mesh(ex_op)
        for operand in ex_op.ufl_operands:
            if operand in evaluated:
                continue
            if isinstance(operand, FEMExternalOperator):
                evaluated[operand] = evaluate_operands([operand], entities)
                continue
            expr = ex_op._compiled_operands.get(operand)
            if expr is None:
                coef = ex_op.ref_coefficient
                expr = Expression(operand, ex_op.eval_points, dtype=coef.dtype, device=coef.device)
                ex_op._compiled_operands[operand] = expr
            evaluated[operand] = expr.eval_local(mesh, entities)
    return evaluated


class _Operands(dict):
    """``evaluate_operands``' result: operand -> values, with the layout
    they were evaluated in (``layout``: entities, device mesh)."""

    layout = (None, None)


def _operand_mesh(ex_op):
    """The mesh over which ``ex_op``'s operands are evaluated: a codim
    operator's operands live on the parent mesh, at the caller's
    entities."""
    from .mesh import Submesh

    mesh = ex_op.ref_function_space.mesh
    return mesh.parent if isinstance(mesh, Submesh) else mesh


def _op_rows(ex_op, layout):
    """The ``_Rows`` of ``ex_op`` in ``layout`` (None unsharded), made
    once per layout."""
    entities, device_mesh = layout
    if device_mesh is None:
        return None
    key = (None if entities is None else np.asarray(entities).tobytes(), device_mesh.rank,
           device_mesh.size)
    cache = ex_op.__dict__.setdefault("_rows_cache", {})
    if key not in cache:
        cache[key] = _Rows(_operand_mesh(ex_op), entities, device_mesh,
                           ex_op.ref_coefficient.device)
    return cache[key]


class _Rows:
    """An operator's sharded evaluation layout: this rank's rows of the
    ``n`` cells or entities (``parallel.rank_rows``), its mesh, and
    whether the rows are the mesh's cells (``entities`` None), where the
    hidden quadrature-space operands are cut to the same rows."""

    def __init__(self, mesh, entities, device_mesh, device):
        from .parallel import rank_rows

        self.mesh, self.device_mesh = mesh, device_mesh
        self.n = mesh.num_cells if entities is None else len(entities)
        self.all_cells = entities is None
        self.rows = torch.as_tensor(rank_rows(self.n, device_mesh)[0], device=device)

    def hidden(self, h):
        """The external function's argument for hidden operand ``h``: a
        Function on a cell-contiguous space of the mesh (quadrature, DG)
        gives this rank's rows, any other its whole data or itself."""
        if not isinstance(h, Function):
            return h
        V = h.function_space
        if (self.all_cells and V.mesh is self.mesh
                and V.element.family in ("quadrature", "DG")):
            return h.data.reshape(self.n, -1)[self.rows].reshape(-1)
        return h.data

    def whole(self, t, like):
        """A per-point result of this rank's rows gathered whole: ``t`` with
        a leading axis of the rank's rows keeps it (now ``n``), a flat one
        stays flat.  ``like``: the coefficient whose device a numpy result
        moves to."""
        k = self.rows.shape[0]
        t = torch.as_tensor(t, device=like.device)
        from .parallel import dist

        whole = dist.all_gather(t.reshape(k, -1), self.n, self.device_mesh.group)
        return whole.reshape((self.n,) + tuple(t.shape[1:])) if t.shape[0] == k else whole.reshape(-1)

    def gathered(self, out, like):
        """``out`` of the external function with its results gathered whole:
        the values (the first entry of a tuple, or ``out``) always, an aux
        tensor when it holds a whole number of values per row."""
        if type(out) is not tuple:
            return self.whole(out, like)
        k = self.rows.shape[0]
        return (self.whole(out[0], like),) + tuple(
            self.whole(t, like) if isinstance(t, torch.Tensor) and t.ndim >= 1
            and t.numel() % k == 0 else t for t in out[1:])


def evaluate_external_operators(external_operators, evaluated_operands):
    """Call each operator's kernel and write the result into its coefficient.

    Includes the derivative multi-index dispatch via
    ``external_function(derivatives)``, the tuple-aux-output protocol (the
    first entry is written back, the rest are returned to the caller, cf.
    ``demo_plasticity_von_mises.py:343-352``), and nested-operator
    recursion.  Under a device mesh (the layout ``evaluate_operands``
    recorded) the external function gets this rank's points and each
    per-point result is gathered whole (``_Rows.gathered``): what is
    written back and returned is the unsharded result.
    """
    return [whole for _, whole in _evaluate(external_operators, evaluated_operands)]


def _evaluate(external_operators, evaluated_operands):
    """[(the external function's output on this rank's points, the output
    gathered whole)] per operator; a nested operator's output enters its
    parent's call as it came out (the rank's points)."""
    results = []
    # a dict built by the caller holds whole arrays
    layout = getattr(evaluated_operands, "layout", (None, None))
    for ex_op in external_operators:
        rows = _op_rows(ex_op, layout)
        args = []
        for operand in ex_op.ufl_operands:
            if isinstance(operand, FEMExternalOperator):
                args.extend(out for out, _ in _evaluate([operand], evaluated_operands[operand]))
            else:
                args.append(evaluated_operands[operand])
        for h in ex_op.hidden_operands:
            if rows is None:
                args.append(h.data if isinstance(h, Function) else h)
            else:
                args.append(rows.hidden(h))

        out = ex_op.external_function(ex_op.derivatives)(*args)
        whole = out if rows is None else rows.gathered(out, ex_op.ref_coefficient)
        ex_op._assign_func(whole[0] if type(whole) is tuple else whole)
        ex_op.ref_coefficient.x.scatter_forward()  # no-op (owner computes)
        results.append((out, whole))
    return results


def unique_external_operators(external_operators):
    seen = set()
    out = []
    for op in external_operators:
        h = op.filtering_hash()
        if h not in seen:
            seen.add(h)
            out.append(op)
    return out


def replace_external_operators(form):
    """Replace operator nodes by their coefficients; collect them in
    dependency order (operands before parents -- reference
    ``ExternalOperatorReplacer``, ``external_operator.py:651-659``)."""
    ops = []

    def collect(op):
        for operand in op.ufl_operands:
            for nested in sym.extract_external_operators(operand):
                collect(nested)
        if op not in ops:
            ops.append(op)

    def rep(e, memo):
        hit = memo.get(id(e))
        if hit is not None:
            return hit
        if isinstance(e, FEMExternalOperator):
            collect(e)
            out = e.ref_coefficient
        elif e.operands:
            new = tuple(rep(o, memo) for o in e.operands)
            out = sym._reconstruct(e, new) if any(n is not o for n, o in zip(new, e.operands)) else e
        else:
            out = e
        memo[id(e)] = out
        return out

    if isinstance(form, sym.Form):
        memo = {}
        new_form = sym.Form([sym.Integral(rep(itg.integrand, memo), itg.measure) for itg in form.integrals])
        return new_form, ops
    # bare expression
    return rep(form, {}), ops

"""Lowering of symbolic expressions to torch: geometry, tabulation, evaluation.

The port of ``dolfinx_external_operator_tpu/compile.py:32-433``.  The JAX
package evaluates an expression at ONE quadrature point and lets
``jax.vmap`` batch it over cells, test and trial basis functions, then
traces the whole walk once into a jitted program.  torch has no trace, so
the walk runs on every call; to keep it cheap it runs ONCE per call on
tensors that carry the batch axes explicitly: every value is a tensor of
shape ``(cells, test, trial, points) + value_shape``, where an axis a
value does not vary along has length 1 and broadcasts.  A coefficient's
value is ``(C, 1, 1, Q) + shape``, a test basis ``(C, T, 1, Q) + shape``, a
trial basis ``(C, 1, U, Q) + shape``, a constant ``(1, 1, 1, 1) + shape``;
so a term that holds no argument is computed once per cell and point, not
once per basis pair.  The walk is memoised per call (a shared
sub-expression is evaluated once), reads nothing to the host, and makes
literal tensors once (``Ctx.statics``).  Every ``sym`` conditional becomes
``torch.where``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sym
from .elements import Element
from .function import Constant, Function
from .mesh import Mesh

__all__ = ["eval_expr", "geometry_factors", "CellBatch", "analyze", "NB"]

_F = torch.float64

# batch axes in front of every value: cells, test basis, trial basis, points
NB = 4


# ----------------------------------------------------------------------
# Geometry
# ----------------------------------------------------------------------

def geometry_element(mesh: Mesh) -> Element:
    return Element("Lagrange", mesh.cell_type, 1)


def geometry_factors(coords, dphi_g):
    """Per-cell geometry at quadrature points, batched over cells.

    coords: (nc, nv, gdim) vertex coords of the cells.
    dphi_g: (nq, nv, tdim) reference gradients of the geometry basis.
    Returns J (nc, nq, gdim, tdim), Jinv (nc, nq, tdim, gdim), detJ (nc, nq)."""
    J = torch.einsum("qvd,cvg->cqgd", dphi_g, coords)
    gdim, tdim = J.shape[-2], J.shape[-1]
    assert gdim == tdim, "cell integrals need gdim == tdim"
    return J, _inv_small(J), _det_small(J)


def _det_small(m):
    """Determinant of 1x1/2x2/3x3 by the closed forms ``jnp.linalg.det``
    uses at these sizes."""
    n = m.shape[-1]
    if n == 1:
        return m[..., 0, 0]
    if n == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if n == 3:
        return (m[..., 0, 0] * m[..., 1, 1] * m[..., 2, 2]
                + m[..., 0, 1] * m[..., 1, 2] * m[..., 2, 0]
                + m[..., 0, 2] * m[..., 1, 0] * m[..., 2, 1]
                - m[..., 0, 2] * m[..., 1, 1] * m[..., 2, 0]
                - m[..., 0, 0] * m[..., 1, 2] * m[..., 2, 1]
                - m[..., 0, 1] * m[..., 1, 0] * m[..., 2, 2])
    raise NotImplementedError(n)


def _inv_small(J):
    """Batched inverse of 1x1/2x2/3x3 without LU."""
    n = J.shape[-1]
    if n == 1:
        return 1.0 / J
    if n == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, d = J[..., 1, 0], J[..., 1, 1]
        det = a * d - b * c
        return torch.stack(
            [torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2
        ) / det[..., None, None]
    if n == 3:
        # adjugate / det
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c10 + m[..., 0, 2] * c20
        adj = torch.stack(
            [
                torch.stack([c00, c01, c02], -1),
                torch.stack([c10, c11, c12], -1),
                torch.stack([c20, c21, c22], -1),
            ],
            -2,
        )
        return adj / det[..., None, None]
    raise NotImplementedError(n)


# ----------------------------------------------------------------------
# Expression analysis
# ----------------------------------------------------------------------

def analyze(expr):
    """Collect terminals and their required derivative data.

    Returns dict with: coefficients (vals needed), coeff_grads, constants,
    arguments {number: space}, needs_x, needs_normal."""
    info = {
        "coeff_vals": [],
        "coeff_grads": [],
        "constants": [],
        "arguments": {},
        "needs_x": False,
        "needs_normal": False,
    }

    def visit(e, under_grad=0):
        if isinstance(e, Function):
            tgt = info["coeff_grads"] if under_grad else info["coeff_vals"]
            if e not in tgt:
                tgt.append(e)
            return
        if isinstance(e, Constant):
            if e not in info["constants"]:
                info["constants"].append(e)
            return
        if isinstance(e, sym.Argument):
            prev = info["arguments"].get(e.number)
            assert prev is None or prev is e.function_space, "conflicting argument spaces"
            info["arguments"][e.number] = e.function_space
            return
        if isinstance(e, sym.SpatialCoordinate):
            info["needs_x"] = True
            return
        if isinstance(e, sym.FacetNormal):
            info["needs_normal"] = True
            return
        if isinstance(e, (sym.Grad, sym.DivOp)):
            visit(e.operands[0], under_grad + 1)
            return
        for o in e.operands:
            visit(o, under_grad)

    visit(expr, 0)
    # a coefficient whose grad is needed also gets its values (cheap)
    for f in info["coeff_grads"]:
        if f not in info["coeff_vals"]:
            info["coeff_vals"].append(f)
    return info


# ----------------------------------------------------------------------
# Batched evaluation of an expression
# ----------------------------------------------------------------------

class Ctx:
    """Values of terminals, batch axes first (module docstring).

    ``statics`` outlives the call: literal tensors are made there once."""

    __slots__ = ("coeff_val", "coeff_grad", "arg", "x", "normal", "const", "dtype", "device",
                 "statics")

    def __init__(self, coeff_val=None, coeff_grad=None, arg=None, x=None, normal=None, const=None,
                 dtype=None, device=None, statics=None):
        self.coeff_val = coeff_val or {}
        self.coeff_grad = coeff_grad or {}
        self.arg = arg or {}
        self.x = x
        self.normal = normal
        self.const = const or {}
        self.dtype = dtype or _F
        self.device = device
        self.statics = {} if statics is None else statics


_UNARY = {
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "ln": torch.log,
    "sin": torch.sin,
    "cos": torch.cos,
    "abs": torch.abs,
    "sign": torch.sign,
    "arcsin": torch.arcsin,
    "tan": torch.tan,
}

_UNARY_D = {
    "sqrt": lambda x: 0.5 / torch.sqrt(x),
    "exp": torch.exp,
    "ln": lambda x: 1.0 / x,
    "sin": torch.cos,
    "cos": lambda x: -torch.sin(x),
    "tan": lambda x: 1.0 / torch.cos(x) ** 2,
    "arcsin": lambda x: 1.0 / torch.sqrt(1.0 - x * x),
    "abs": torch.sign,
    "sign": torch.zeros_like,
}


def _nv(t):
    """Number of value axes of a batched value."""
    return t.dim() - NB


def _lift(t, n):
    """Append ``n`` unit axes (a scalar value against an ``n``-axis one)."""
    return t.reshape(tuple(t.shape) + (1,) * n)


def _tdot(a, b, n):
    """``tensordot(a, b, axes=n)`` over the value axes: the last ``n`` of
    a's with the first ``n`` of b's; batch axes broadcast."""
    va, vb = tuple(a.shape[NB:]), tuple(b.shape[NB:])
    keep_a, keep_b = va[:len(va) - n], vb[n:]
    k = int(np.prod(vb[:n], dtype=np.int64))
    A = a.reshape(tuple(a.shape[:NB]) + (int(np.prod(keep_a, dtype=np.int64)), k))
    B = b.reshape(tuple(b.shape[:NB]) + (k, int(np.prod(keep_b, dtype=np.int64))))
    out = (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)
    return out.reshape(tuple(out.shape[:NB]) + keep_a + keep_b)


def _stack(ts, dim):
    """Stack batched values after broadcasting their batch axes."""
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return torch.stack([t.expand(shape) for t in ts], dim=dim)


def _static(ctx, key, make):
    hit = ctx.statics.get(key)
    if hit is None:
        hit = ctx.statics[key] = make()
    return hit


def _zeros(ctx, shape):
    return _static(ctx, ("zeros", tuple(shape)),
                   lambda: torch.zeros((1,) * NB + tuple(shape), dtype=ctx.dtype, device=ctx.device))


def eval_expr(expr, ctx: Ctx, memo=None):
    """Evaluate a symbolic expression to a tensor of shape
    ``batch + expr.shape`` (module docstring)."""
    if memo is None:
        memo = {}
    key = id(expr)
    if key in memo:
        return memo[key]
    out = _eval(expr, ctx, memo)
    memo[key] = out
    return out


def _eval_grad_of(e, ctx, memo, gdim):
    """Value of the spatial gradient of ``e`` (terminal-level grads)."""
    if isinstance(e, Function):
        g = ctx.coeff_grad.get(e)
        if g is None:
            raise ValueError(f"gradient of coefficient {e.name} unavailable (quadrature-space data is pointwise)")
        return g
    if isinstance(e, sym.Argument):
        return ctx.arg[e.number][1]
    if isinstance(e, sym.SpatialCoordinate):
        return _static(ctx, ("eye", gdim), lambda: torch.eye(gdim, dtype=ctx.dtype, device=ctx.device)
                       .reshape((1,) * NB + (gdim, gdim)))
    if isinstance(e, (Constant, sym.Literal, sym.Zero)):
        return _zeros(ctx, e.shape + (gdim,))
    # linear push-down through shape-manipulating / linear nodes
    if isinstance(e, sym.Sum):
        return _eval_grad_of(e.operands[0], ctx, memo, gdim) + _eval_grad_of(e.operands[1], ctx, memo, gdim)
    if isinstance(e, sym.Variable):
        return _eval_grad_of(e.operands[0], ctx, memo, gdim)
    if isinstance(e, sym.Indexed):
        return _eval_grad_of(e.operands[0], ctx, memo, gdim)[(slice(None),) * NB + e.idx]
    if isinstance(e, sym.AsTensor):
        grads = _stack([_eval_grad_of(o, ctx, memo, gdim) for o in e.operands], NB)
        return grads.reshape(tuple(grads.shape[:NB]) + e.shape + (gdim,))
    if isinstance(e, sym.Product) and isinstance(e.operands[0], (sym.Literal, Constant)):
        s = eval_expr(e.operands[0], ctx, memo)
        gb = _eval_grad_of(e.operands[1], ctx, memo, gdim)
        return _lift(s, _nv(gb)) * gb
    if isinstance(e, sym.Transpose):
        return _eval_grad_of(e.operands[0], ctx, memo, gdim).transpose(NB, NB + 1)
    # ---- product/chain rules for composite expressions --------------------
    if isinstance(e, sym.Product):  # scalar * anything
        a, b = e.operands
        va, vb = eval_expr(a, ctx, memo), eval_expr(b, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        gb = _eval_grad_of(b, ctx, memo, gdim)
        nb = len(b.shape)
        return _lift(vb, 1) * ga.reshape(tuple(ga.shape[:NB]) + (1,) * nb + (gdim,)) + _lift(va, nb + 1) * gb
    if isinstance(e, sym.Division):  # anything / scalar
        a, b = e.operands
        va, vb = eval_expr(a, ctx, memo), eval_expr(b, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        gb = _eval_grad_of(b, ctx, memo, gdim)
        na = len(a.shape)
        gb = gb.reshape(tuple(gb.shape[:NB]) + (1,) * na + (gdim,))
        return ga / _lift(vb, na + 1) - _lift(va, 1) * gb / _lift(vb * vb, na + 1)
    if isinstance(e, sym.Power):
        a, b = e.operands
        va = eval_expr(a, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        if isinstance(b, (sym.Literal, Constant)):
            p = eval_expr(b, ctx, memo)
            return _lift(p * va ** (p - 1.0), 1) * ga
        vb = eval_expr(b, ctx, memo)
        gb = _eval_grad_of(b, ctx, memo, gdim)
        return _lift(va**vb, 1) * (gb * _lift(torch.log(va), 1) + _lift(vb, 1) * ga / _lift(va, 1))
    if isinstance(e, sym.Inner):
        a, b = e.operands
        va, vb = eval_expr(a, ctx, memo), eval_expr(b, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        gb = _eval_grad_of(b, ctx, memo, gdim)
        t1, t2 = ga * _lift(vb, 1), _lift(va, 1) * gb
        if a.shape:
            axes = tuple(range(NB, NB + len(a.shape)))
            t1, t2 = t1.sum(dim=axes), t2.sum(dim=axes)
        return t1 + t2
    if isinstance(e, sym.Dot):  # contract last axis of a with first of b
        a, b = e.operands
        va, vb = eval_expr(a, ctx, memo), eval_expr(b, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        gb = _eval_grad_of(b, ctx, memo, gdim)
        t2 = _tdot(va, gb, 1)  # a[:-1] + b[1:] + (g,)
        t1 = _tdot(ga.movedim(-1, NB), vb, 1).movedim(NB, -1)
        return t1 + t2
    if isinstance(e, sym.Outer):
        a, b = e.operands
        va, vb = eval_expr(a, ctx, memo), eval_expr(b, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        gb = _eval_grad_of(b, ctx, memo, gdim)
        t1 = _tdot(ga, vb, 0).movedim(NB + len(a.shape), -1)
        t2 = _tdot(va, gb, 0)
        return t1 + t2
    if isinstance(e, sym.Trace):
        g = _eval_grad_of(e.operands[0], ctx, memo, gdim)
        return g.diagonal(dim1=NB, dim2=NB + 1).sum(-1)
    if isinstance(e, sym.Unary):
        (a,) = e.operands
        va = eval_expr(a, ctx, memo)
        ga = _eval_grad_of(a, ctx, memo, gdim)
        return _lift(_UNARY_D[e.op](va), 1) * ga
    if isinstance(e, sym.Conditional):
        cond = eval_expr(e.operands[0], ctx, memo)
        gt = _eval_grad_of(e.operands[1], ctx, memo, gdim)
        gf = _eval_grad_of(e.operands[2], ctx, memo, gdim)
        return torch.where(_lift(cond, _nv(gt)), gt, gf)
    raise NotImplementedError(
        f"grad() of composite expression {type(e).__name__}; restructure the form so grad applies to terminals"
    )


def _eval(expr, ctx, memo):
    t = type(expr)
    if isinstance(expr, sym.Zero):
        return _zeros(ctx, expr.shape)
    if isinstance(expr, sym.Literal):
        return _static(ctx, ("literal", id(expr)),
                       lambda: torch.as_tensor(expr.array, dtype=ctx.dtype, device=ctx.device)
                       .reshape((1,) * NB + expr.shape))
    if isinstance(expr, Function):
        v = ctx.coeff_val.get(expr)
        if v is None:
            raise KeyError(f"no value bound for coefficient {expr.name}")
        return v
    if isinstance(expr, Constant):
        return ctx.const[expr]
    if isinstance(expr, sym.Argument):
        return ctx.arg[expr.number][0]
    if isinstance(expr, sym.SpatialCoordinate):
        return ctx.x
    if isinstance(expr, sym.FacetNormal):
        return ctx.normal
    if t is sym.Grad:
        return _eval_grad_of(expr.operands[0], ctx, memo, expr.gdim)
    if t is sym.DivOp:
        g = _eval_grad_of(expr.operands[0], ctx, memo, expr.gdim)
        return g.diagonal(dim1=-2, dim2=-1).sum(-1)

    if t is sym.Variable:
        return eval_expr(expr.operands[0], ctx, memo)

    ops = [eval_expr(o, ctx, memo) for o in expr.operands]
    if t is sym.Sum:
        return ops[0] + ops[1]
    if t is sym.Product:
        return _lift(ops[0], _nv(ops[1])) * ops[1]
    if t is sym.Division:
        return ops[0] / _lift(ops[1], _nv(ops[0]))
    if t is sym.Power:
        return torch.pow(ops[0], ops[1])
    if t is sym.Unary:
        return _UNARY[expr.op](ops[0])
    if t is sym.Comparison:
        a, b = ops
        return {"le": a <= b, "ge": a >= b, "lt": a < b, "gt": a > b}[expr.op]
    if t is sym.Conditional:
        return torch.where(_lift(ops[0], _nv(ops[1])), ops[1], ops[2])
    if t is sym.Inner:
        prod = ops[0] * ops[1]
        return prod.flatten(NB).sum(-1) if expr.operands[0].shape else prod
    if t is sym.Dot:
        return _tdot(ops[0], ops[1], 1)
    if t is sym.Outer:
        return _tdot(ops[0], ops[1], 0)
    if t is sym.Transpose:
        return ops[0].transpose(-1, -2)
    if t is sym.Trace:
        return ops[0].diagonal(dim1=-2, dim2=-1).sum(-1)
    if t is sym.Indexed:
        return ops[0][(slice(None),) * NB + expr.idx]
    if t is sym.AsTensor:
        v = _stack(ops, -1)
        return v.reshape(tuple(v.shape[:NB]) + expr.shape)
    if t is sym.TensorDot:
        return _tdot(ops[0], ops[1], expr.n)
    raise NotImplementedError(f"eval of {t}")


# ----------------------------------------------------------------------
# Batched per-cell data preparation
# ----------------------------------------------------------------------

class CellBatch:
    """Static (host-prepared) data to evaluate an integrand on a batch of
    cells at fixed reference points.

    For facet integrals, ``cells`` are the parent cells of the facets and
    the reference points are the facet quadrature points mapped into the
    parent reference cell."""

    def __init__(self, mesh: Mesh, points: np.ndarray, cells: np.ndarray | None = None):
        self.mesh = mesh
        self.points = np.asarray(points, dtype=np.float64)
        self.cells = np.arange(mesh.num_cells, dtype=np.int32) if cells is None else np.asarray(cells, np.int32)
        geo = geometry_element(mesh)
        self.phi_g, self.dphi_g = geo.tabulate(self.points)
        self.coords = mesh.points[mesh.cells[self.cells]]  # (nc, nv, g)

    @property
    def nq(self):
        return self.points.shape[0]


def coefficient_inputs(info, batch: CellBatch, quadrature_degree=None):
    """Build the static tabulation plan for each coefficient.

    Returns list of (function, kind, static data) where kind is:
    - "qp": quadrature-space coefficient read directly at the points
    - "tab": standard element, gathered dofs x tabulated basis
    - "tab_mixed": a mixed space, one tabulation per sub-space
    """
    plan = []
    for f in info["coeff_vals"]:
        V = f.function_space
        if V.is_quadrature:
            el = V.element
            same_mesh = V.mesh is batch.mesh
            if same_mesh:
                if quadrature_degree is not None and el.degree != quadrature_degree:
                    raise ValueError(
                        f"quadrature element degree {el.degree} != measure quadrature_degree "
                        f"{quadrature_degree}: the reference requires these to match "
                        "(demo_nonlinear_heat_equation_part1.py:198-204)"
                    )
                if not np.allclose(el.interpolation_points, batch.points, atol=1e-12):
                    raise ValueError("quadrature-space coefficient evaluated at foreign points")
            else:
                # submesh (codim-0/1) coefficient: the batch points live on
                # the parent reference cell; only the point COUNT must agree
                if el.interpolation_points.shape[0] != batch.nq:
                    raise ValueError(
                        "submesh quadrature coefficient point count "
                        f"{el.interpolation_points.shape[0]} != integration rule {batch.nq}"
                    )
            if f in info["coeff_grads"]:
                raise ValueError("cannot take grad() of a quadrature-space coefficient")
            plan.append((f, "qp", None))
        elif V.num_sub_spaces > 0:
            needs_grad = f in info["coeff_grads"]
            tabs = [V.sub(i).tabulate(batch.points) for i in range(V.num_sub_spaces)]
            subs = [(V.sub(i).element.num_scalar_dofs, V.sub(i).bs) for i in range(V.num_sub_spaces)]
            plan.append((f, "tab_mixed", (tabs, subs, needs_grad)))
        else:
            phi, dphi = V.tabulate(batch.points)
            needs_grad = f in info["coeff_grads"]
            plan.append((f, "tab", (phi, dphi, needs_grad)))
    return plan


def gather_coefficient(f, plan_entry, batch: CellBatch):
    """Per-cell dof data for one coefficient: an (nc, ...) tensor."""
    _, kind, _ = plan_entry
    V = f.function_space
    cells = torch.as_tensor(batch.cells, dtype=torch.int64, device=f.device)
    if kind == "qp":
        nq, bs = batch.nq, V.bs
        return f.data.reshape(-1, nq * bs)[cells]
    dm = torch.as_tensor(V.unrolled_dofmap[batch.cells], dtype=torch.int64, device=f.device)
    return f.data[dm]

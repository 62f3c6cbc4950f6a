# Copy of dolfinx_external_operator_tpu/sym.py (numpy only).  The port keeps its own:
# importing the JAX package's module would import JAX.  Keep the two in step.
"""A lean symbolic form language (UFL-lite) with Gateaux differentiation.

TPU-native replacement for the UFL layer consumed by the reference package:
symbolic expressions over coefficients/arguments, measures and forms, and a
form-level automatic-differentiation transform (``derivative`` +
``expand_derivatives``) that understands external operators via the chain
rule (reference semantics: ``ufl.derivative`` / ``expand_derivatives`` and
the Action-rewrite of ``external_operator.py:463-539``).

Design difference vs UFL: differentiation is *eager* — ``derivative()``
returns the fully expanded form directly, with each external-operator
derivative emitted as a trailing-axis tensor contraction
``tensordot(dN/do_i, D[o_i]{du})`` (exactly the semantics of the reference's
``_apply_derivative_tensor``, ``external_operator.py:463-486``), so there is
no separate Action/Adjoint graph to rewrite.  ``expand_derivatives`` is kept
as a (zero-folding) no-op for user-code parity.

All shapes are static; expressions lower to pure JAX in ``compile.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Expr", "Zero", "Literal", "Argument", "TestFunction", "TrialFunction",
    "SpatialCoordinate", "FacetNormal", "Identity",
    "grad", "div", "inner", "dot", "outer", "tr", "sym", "dev", "transpose",
    "sqrt", "exp", "ln", "sin", "cos", "abs_", "sign", "conditional", "le", "ge", "lt", "gt",
    "as_vector", "as_matrix", "as_tensor", "tensordot",
    "variable", "diff", "det", "Variable",
    "Measure", "Integral", "Form", "derivative", "expand_derivatives",
    "extract_coefficients", "extract_external_operators", "map_expr",
    "replace", "action", "adjoint", "split",
]


def _prod(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class Expr:
    """Base symbolic node.  ``shape`` is the tensor value shape."""

    shape: tuple = ()
    operands: tuple = ()

    # -- python operators ------------------------------------------------
    def __add__(self, other):
        return add(self, as_expr(other))

    def __radd__(self, other):
        return add(as_expr(other), self)

    def __sub__(self, other):
        return add(self, neg(as_expr(other)))

    def __rsub__(self, other):
        return add(as_expr(other), neg(self))

    def __mul__(self, other):
        if isinstance(other, Measure):
            return Form([Integral(self, other)])
        return mul(self, as_expr(other))

    def __rmul__(self, other):
        return mul(as_expr(other), self)

    def __truediv__(self, other):
        return divide(self, as_expr(other))

    def __rtruediv__(self, other):
        return divide(as_expr(other), self)

    def __pow__(self, p):
        return power(self, as_expr(p))

    def __neg__(self):
        return neg(self)

    def __matmul__(self, other):
        return dot(self, as_expr(other))

    def __rmatmul__(self, other):
        return dot(as_expr(other), self)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return indexed(self, idx)

    @property
    def T(self):
        return transpose(self)

    # structural equality for non-terminals; terminals override with identity
    def _key(self):
        return (type(self).__name__, self.shape, self.operands)

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Expr) or type(self) is not type(other):
            return False
        return self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


def as_expr(v):
    if isinstance(v, Expr):
        return v
    arr = np.asarray(v, dtype=np.float64)
    if arr.ndim == 0 and float(arr) == 0.0:
        return Zero(())
    return Literal(arr)


# ----------------------------------------------------------------------
# Terminals
# ----------------------------------------------------------------------

class Zero(Expr):
    def __init__(self, shape=()):
        self.shape = tuple(shape)
        self.operands = ()

    def _key(self):
        return ("Zero", self.shape)


def is_zero(e):
    return isinstance(e, Zero)


class Literal(Expr):
    """A constant numpy scalar/tensor baked into the form."""

    def __init__(self, array):
        self.array = np.asarray(array, dtype=np.float64)
        self.shape = self.array.shape
        self.operands = ()

    def _key(self):
        return ("Literal", self.array.tobytes(), self.shape)


def Identity(n: int) -> Literal:
    return Literal(np.eye(n))


class Argument(Expr):
    """Test (number=0) / trial (number=1) function of a space."""

    def __init__(self, space, number: int):
        self.function_space = space
        self.number = number
        self.shape = tuple(space.value_shape)
        self.operands = ()

    def _key(self):
        return ("Argument", id(self.function_space), self.number)

    def __repr__(self):
        return f"Argument({'test' if self.number == 0 else 'trial'}, shape={self.shape})"


def TestFunction(space) -> Argument:
    return Argument(space, 0)


def TrialFunction(space) -> Argument:
    return Argument(space, 1)


class SpatialCoordinate(Expr):
    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = (mesh.gdim,)
        self.operands = ()

    def _key(self):
        return ("SpatialCoordinate", id(self.mesh))


class FacetNormal(Expr):
    def __init__(self, mesh):
        self.mesh = mesh
        self.shape = (mesh.gdim,)
        self.operands = ()

    def _key(self):
        return ("FacetNormal", id(self.mesh))


# ----------------------------------------------------------------------
# Operations (dumb nodes; smart constructors below)
# ----------------------------------------------------------------------

class Sum(Expr):
    def __init__(self, a, b):
        assert a.shape == b.shape, (a.shape, b.shape)
        self.operands = (a, b)
        self.shape = a.shape


class Product(Expr):
    """scalar * anything."""

    def __init__(self, a, b):
        assert a.shape == (), f"Product left operand must be scalar, got {a.shape}"
        self.operands = (a, b)
        self.shape = b.shape


class Division(Expr):
    def __init__(self, a, b):
        assert b.shape == (), "can only divide by scalar"
        self.operands = (a, b)
        self.shape = a.shape


class Power(Expr):
    def __init__(self, a, b):
        assert a.shape == () and b.shape == ()
        self.operands = (a, b)
        self.shape = ()


_UNARY_FNS = {"sqrt", "exp", "ln", "sin", "cos", "abs", "sign", "arcsin", "tan"}


class Unary(Expr):
    def __init__(self, op: str, a):
        assert op in _UNARY_FNS
        assert a.shape == (), f"{op} needs scalar operand"
        self.op = op
        self.operands = (a,)
        self.shape = ()

    def _key(self):
        return ("Unary", self.op, self.operands)


class Conditional(Expr):
    """conditional(cond, true_val, false_val); cond is a Comparison."""

    def __init__(self, cond, t, f):
        assert t.shape == f.shape
        self.operands = (cond, t, f)
        self.shape = t.shape


class Comparison(Expr):
    def __init__(self, op: str, a, b):
        assert op in ("le", "ge", "lt", "gt")
        self.op = op
        self.operands = (a, b)
        self.shape = ()

    def _key(self):
        return ("Comparison", self.op, self.operands)


class Inner(Expr):
    """Full contraction of two equal-shape tensors -> scalar."""

    def __init__(self, a, b):
        assert a.shape == b.shape, (a.shape, b.shape)
        self.operands = (a, b)
        self.shape = ()


class Dot(Expr):
    """Contract last axis of a with first axis of b."""

    def __init__(self, a, b):
        if a.shape == () or b.shape == ():
            raise ValueError("use * for scalars")
        assert a.shape[-1] == b.shape[0], (a.shape, b.shape)
        self.operands = (a, b)
        self.shape = a.shape[:-1] + b.shape[1:]


class Outer(Expr):
    def __init__(self, a, b):
        self.operands = (a, b)
        self.shape = a.shape + b.shape


class Transpose(Expr):
    def __init__(self, a):
        assert len(a.shape) == 2
        self.operands = (a,)
        self.shape = (a.shape[1], a.shape[0])


class Trace(Expr):
    def __init__(self, a):
        assert len(a.shape) == 2 and a.shape[0] == a.shape[1]
        self.operands = (a,)
        self.shape = ()


class Grad(Expr):
    """Spatial gradient: shape + (gdim,)."""

    def __init__(self, a, gdim: int):
        self.operands = (a,)
        self.gdim = gdim
        self.shape = a.shape + (gdim,)

    def _key(self):
        return ("Grad", self.gdim, self.operands)


class DivOp(Expr):
    """Divergence: contract last ("derivative") axis with the preceding one.

    div(v)_[] = v_i,i ; div(T)_i = T_ij,j  (UFL convention)."""

    def __init__(self, a, gdim: int):
        assert len(a.shape) >= 1
        self.operands = (a,)
        self.gdim = gdim
        self.shape = a.shape[:-1]

    def _key(self):
        return ("DivOp", self.gdim, self.operands)


class Indexed(Expr):
    def __init__(self, a, idx: tuple):
        assert len(idx) <= len(a.shape), (idx, a.shape)
        for i, n in zip(idx, a.shape):
            assert isinstance(i, (int, np.integer)) and 0 <= i < n, (idx, a.shape)
        self.operands = (a,)
        self.idx = tuple(int(i) for i in idx)
        self.shape = a.shape[len(idx):]

    def _key(self):
        return ("Indexed", self.idx, self.operands)


class AsTensor(Expr):
    """Stack scalar entries (row-major) into a tensor."""

    def __init__(self, entries, shape):
        entries = tuple(entries)
        assert len(entries) == _prod(shape)
        for e in entries:
            assert e.shape == (), "AsTensor entries must be scalar"
        self.operands = entries
        self.shape = tuple(shape)

    def _key(self):
        return ("AsTensor", self.shape, self.operands)


class Variable(Expr):
    """Tag a sub-expression so forms can be differentiated w.r.t. it.

    Mirror of ``ufl.variable`` + ``ufl.diff`` (used by the hyperelasticity
    demo, reference ``demo_hyperelasticity.py:479,700``): transparent for
    evaluation and for Gateaux differentiation w.r.t. coefficients, but acts
    as the differentiation target for ``diff(expr, var)``."""

    _counter = [0]

    def __init__(self, expr):
        self.operands = (expr,)
        self.shape = expr.shape
        Variable._counter[0] += 1
        self._id = Variable._counter[0]

    def _key(self):
        return ("Variable", self._id)

    def __eq__(self, other):
        return self is other or (isinstance(other, Variable) and other._id == self._id)

    def __hash__(self):
        return hash(("Variable", self._id))


class TensorDot(Expr):
    """Contract the trailing ``n`` axes of ``a`` with ALL axes of ``b``.

    This is the derivative-action contraction of the reference
    (``_apply_derivative_tensor``, ``external_operator.py:463-486``):
    coefficient shape = out_shape + arg_shape, contracted against the
    direction over arg_shape."""

    def __init__(self, a, b, n: int):
        assert n == len(b.shape) and (n == 0 or a.shape[len(a.shape) - n:] == b.shape), (a.shape, b.shape, n)
        self.operands = (a, b)
        self.n = n
        self.shape = a.shape[: len(a.shape) - n]

    def _key(self):
        return ("TensorDot", self.n, self.operands)


# ----------------------------------------------------------------------
# Smart constructors
# ----------------------------------------------------------------------

def add(a, b):
    if is_zero(a):
        return b
    if is_zero(b):
        return a
    if isinstance(a, Literal) and isinstance(b, Literal):
        return Literal(a.array + b.array)
    return Sum(a, b)


def neg(a):
    if is_zero(a):
        return a
    return mul(Literal(np.float64(-1.0)), a)


def mul(a, b):
    # orient so the scalar is on the left
    if a.shape != () and b.shape == ():
        a, b = b, a
    if a.shape != ():
        raise ValueError(f"cannot multiply shapes {a.shape} and {b.shape}; use dot/inner/outer")
    if is_zero(a) or is_zero(b):
        return Zero(b.shape)
    if isinstance(a, Literal) and isinstance(b, Literal):
        return Literal(a.array * b.array)
    if isinstance(a, Literal) and a.array.shape == () and float(a.array) == 1.0:
        return b
    return Product(a, b)


def divide(a, b):
    if is_zero(a):
        return a
    if isinstance(a, Literal) and isinstance(b, Literal):
        return Literal(a.array / b.array)
    return Division(a, b)


def power(a, b):
    return Power(a, b)


def _unary(op):
    def f(a):
        a = as_expr(a)
        if isinstance(a, Literal):
            fn = {"sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "sin": np.sin,
                  "cos": np.cos, "abs": np.abs, "sign": np.sign, "arcsin": np.arcsin,
                  "tan": np.tan}[op]
            return Literal(fn(a.array))
        return Unary(op, a)

    return f


sqrt = _unary("sqrt")
exp = _unary("exp")
ln = _unary("ln")
sin = _unary("sin")
cos = _unary("cos")
abs_ = _unary("abs")
sign = _unary("sign")
arcsin = _unary("arcsin")
tan = _unary("tan")


def le(a, b):
    return Comparison("le", as_expr(a), as_expr(b))


def ge(a, b):
    return Comparison("ge", as_expr(a), as_expr(b))


def lt(a, b):
    return Comparison("lt", as_expr(a), as_expr(b))


def gt(a, b):
    return Comparison("gt", as_expr(a), as_expr(b))


def conditional(cond, t, f):
    return Conditional(cond, as_expr(t), as_expr(f))


def inner(a, b):
    a, b = as_expr(a), as_expr(b)
    if a.shape == () and b.shape == ():
        return mul(a, b)
    if is_zero(a) or is_zero(b):
        return Zero(())
    return Inner(a, b)


def dot(a, b):
    a, b = as_expr(a), as_expr(b)
    if a.shape == () or b.shape == ():
        return mul(a, b)
    if is_zero(a) or is_zero(b):
        return Zero(a.shape[:-1] + b.shape[1:])
    return Dot(a, b)


def outer(a, b):
    a, b = as_expr(a), as_expr(b)
    if is_zero(a) or is_zero(b):
        return Zero(a.shape + b.shape)
    return Outer(a, b)


def transpose(a):
    if is_zero(a):
        return Zero((a.shape[1], a.shape[0]))
    if isinstance(a, Literal):
        return Literal(a.array.T)
    return Transpose(a)


def tr(a):
    if is_zero(a):
        return Zero(())
    return Trace(a)


def sym(a):
    return mul(Literal(np.float64(0.5)), add(a, transpose(a)))


def dev(a):
    n = a.shape[0]
    return add(a, neg(mul(divide(tr(a), Literal(np.float64(n))), Identity(n))))


def _expr_gdim(a):
    """Geometric dimension inferred from terminals under ``a``."""
    for t in _terminals(a):
        m = getattr(t, "mesh", None)
        if m is None:
            fs = getattr(t, "function_space", None)
            m = getattr(fs, "mesh", None)
        if m is not None:
            return m.gdim
    raise ValueError("cannot infer gdim for grad(); expression has no mesh-attached terminal")


def grad(a):
    a = as_expr(a)
    gdim = _expr_gdim(a)
    if is_zero(a):
        return Zero(a.shape + (gdim,))
    return Grad(a, gdim)


def nabla_grad(a):
    return transpose(grad(a))


def div(a):
    a = as_expr(a)
    gdim = _expr_gdim(a)
    if is_zero(a):
        return Zero(a.shape[:-1])
    return DivOp(a, gdim)


def indexed(a, idx):
    if is_zero(a):
        return Zero(a.shape[len(idx):])
    if isinstance(a, Literal):
        return Literal(a.array[idx])
    if isinstance(a, AsTensor) and len(idx) == len(a.shape):
        flat = int(np.ravel_multi_index(idx, a.shape))
        return a.operands[flat]
    return Indexed(a, idx)


def as_tensor(entries, shape=None):
    """Build a tensor from (possibly nested) lists of scalar expressions.

    If ``shape`` is given, ``entries`` may also be a flat row-major list."""
    if shape is not None and isinstance(entries, (list, tuple)) and all(isinstance(e, Expr) for e in entries) \
            and len(entries) == _prod(shape):
        flat = [as_expr(e) for e in entries]
        if all(is_zero(e) for e in flat):
            return Zero(tuple(shape))
        if all(isinstance(e, Literal) for e in flat):
            return Literal(np.array([e.array for e in flat]).reshape(shape))
        return AsTensor(flat, tuple(shape))

    def _flatten(x, shp):
        if isinstance(x, (list, tuple)):
            n = len(x)
            sub = None
            out = []
            for item in x:
                f, s = _flatten(item, shp)
                if sub is None:
                    sub = s
                assert s == sub, "ragged as_tensor"
                out.extend(f)
            return out, (n,) + sub
        return [as_expr(x)], ()

    flat, inferred = _flatten(entries, None)
    shape = tuple(shape) if shape is not None else inferred
    if all(is_zero(e) for e in flat):
        return Zero(shape)
    if all(isinstance(e, Literal) for e in flat):
        return Literal(np.array([e.array for e in flat]).reshape(shape))
    return AsTensor(flat, shape)


def as_vector(entries):
    return as_tensor(list(entries))


def as_matrix(entries):
    return as_tensor([list(r) for r in entries])


def variable(expr):
    return Variable(as_expr(expr))


def det(a):
    """Determinant of a 2x2 or 3x3 tensor expression (composed symbolically)."""
    a = as_expr(a)
    n = a.shape[0]
    assert a.shape == (n, n)
    if n == 1:
        return a[0, 0]
    if n == 2:
        return a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    if n == 3:
        return (
            a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
            - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
        )
    raise NotImplementedError(n)


def diff(expr, var):
    """Tensor derivative d expr / d var (ufl.diff semantics).

    ``var`` may be a ``Variable`` or a coefficient Function (the reference's
    multiaction twin differentiates w.r.t. a DG0 coefficient,
    ``test_multiaction.py:117``).  For scalar ``expr`` returns shape
    var.shape with entries d expr / d var_i..., computed by Gateaux
    differentiation in unit tensor directions."""
    assert expr.shape == (), "diff currently implemented for scalar expressions"
    entries = []
    for idx in np.ndindex(var.shape) if var.shape else [()]:
        direction = np.zeros(var.shape) if var.shape else np.float64(1.0)
        if var.shape:
            direction[idx] = 1.0
        memo = {}
        entries.append(_gateaux(expr, var, Literal(direction), memo))
    if not var.shape:
        return entries[0]
    return as_tensor(entries, var.shape)


def tensordot(a, b, n):
    if n == 0:
        return mul(b, a) if b.shape == () else mul(a, b)
    if is_zero(a) or is_zero(b):
        return Zero(a.shape[: len(a.shape) - n])
    return TensorDot(a, b, n)


# ----------------------------------------------------------------------
# Measures, integrals, forms
# ----------------------------------------------------------------------

class Measure:
    """Integration measure.

    kind: "dx" (cells) or "ds" (exterior facets).  ``metadata`` must carry
    ``quadrature_degree`` (the degree-consistency invariant with quadrature
    elements is enforced at compile time — cf. reference
    ``demo_nonlinear_heat_equation_part1.py:198-204``).  ``subdomain_data``
    for "ds" is a dict mapping tags to facet-index arrays (the TPU-native
    replacement for gmsh facet MeshTags)."""

    def __init__(self, kind: str, domain=None, metadata=None, subdomain_data=None, subdomain_id=None):
        assert kind in ("dx", "ds")
        self.kind = kind
        self.domain = domain
        self.metadata = dict(metadata or {})
        self.subdomain_data = subdomain_data
        self.subdomain_id = subdomain_id

    def __call__(self, subdomain_id):
        return Measure(self.kind, self.domain, self.metadata, self.subdomain_data, subdomain_id)

    @property
    def quadrature_degree(self):
        return self.metadata.get("quadrature_degree")

    def _key(self):
        return (self.kind, id(self.domain), tuple(sorted(self.metadata.items())),
                id(self.subdomain_data), self.subdomain_id if not isinstance(self.subdomain_id, np.ndarray) else id(self.subdomain_id))

    def __eq__(self, other):
        return isinstance(other, Measure) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())


class Integral:
    def __init__(self, integrand: Expr, measure: Measure):
        assert integrand.shape == (), "integrand must be scalar"
        self.integrand = integrand
        self.measure = measure


class Form:
    def __init__(self, integrals):
        self.integrals = [itg for itg in integrals if not is_zero(itg.integrand)]

    def __add__(self, other):
        assert isinstance(other, Form)
        # merge integrals over identical measures
        merged = {}
        order = []
        for itg in self.integrals + other.integrals:
            k = itg.measure
            if k in merged:
                merged[k] = Integral(add(merged[k].integrand, itg.integrand), k)
            else:
                merged[k] = itg
                order.append(k)
        return Form([merged[k] for k in order])

    def __sub__(self, other):
        return self + (-other)

    def __neg__(self):
        return Form([Integral(neg(itg.integrand), itg.measure) for itg in self.integrals])

    def __rmul__(self, s):
        s = as_expr(s)
        return Form([Integral(mul(s, itg.integrand), itg.measure) for itg in self.integrals])

    def arguments(self):
        args = {}
        for itg in self.integrals:
            for t in _terminals(itg.integrand):
                if isinstance(t, Argument):
                    args[t.number] = t
        return [args[k] for k in sorted(args)]

    def coefficients(self):
        out = []
        for itg in self.integrals:
            for c in extract_coefficients(itg.integrand):
                if c not in out:
                    out.append(c)
        return out


# ----------------------------------------------------------------------
# Traversal utilities
# ----------------------------------------------------------------------

def _terminals(expr):
    seen = set()
    stack = [expr]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if e.operands:
            stack.extend(e.operands)
        else:
            yield e


def extract_coefficients(expr):
    """All Function coefficients in the expression (incl. inside ext-ops)."""
    from .function import Function

    out = []
    for t in _terminals(expr):
        if isinstance(t, Function) and t not in out:
            out.append(t)
    return out


def extract_external_operators(expr):
    from .external_operator import FEMExternalOperator

    out = []

    def visit(e):
        if isinstance(e, FEMExternalOperator):
            for op in e.ufl_operands:
                visit(op)
            if e not in out:
                out.append(e)
        for o in e.operands:
            visit(o)

    visit(expr)
    return out


def map_expr(fn, expr, memo=None):
    """Bottom-up reconstruction: ``fn`` maps each (reconstructed) node."""
    if memo is None:
        memo = {}
    key = id(expr)
    if key in memo:
        return memo[key]
    if expr.operands:
        new_ops = tuple(map_expr(fn, o, memo) for o in expr.operands)
        if any(n is not o for n, o in zip(new_ops, expr.operands)):
            expr = _reconstruct(expr, new_ops)
    out = fn(expr)
    memo[key] = out
    return out


def _reconstruct(expr, new_operands):
    t = type(expr)
    if t is Sum:
        return add(*new_operands)
    if t is Product:
        return mul(*new_operands)
    if t is Division:
        return divide(*new_operands)
    if t is Power:
        return power(*new_operands)
    if t is Unary:
        return _unary(expr.op)(new_operands[0])
    if t is Comparison:
        return Comparison(expr.op, *new_operands)
    if t is Conditional:
        return conditional(*new_operands)
    if t is Inner:
        return inner(*new_operands)
    if t is Dot:
        return dot(*new_operands)
    if t is Outer:
        return outer(*new_operands)
    if t is Transpose:
        return transpose(new_operands[0])
    if t is Trace:
        return tr(new_operands[0])
    if t is Grad:
        return Grad(new_operands[0], expr.gdim) if not is_zero(new_operands[0]) else Zero(expr.shape)
    if t is DivOp:
        return DivOp(new_operands[0], expr.gdim) if not is_zero(new_operands[0]) else Zero(expr.shape)
    if t is Indexed:
        return indexed(new_operands[0], expr.idx)
    if t is AsTensor:
        return as_tensor(list(new_operands), expr.shape)
    if t is TensorDot:
        return tensordot(new_operands[0], new_operands[1], expr.n)
    if t is Variable:
        return Variable(new_operands[0])
    from .external_operator import FEMExternalOperator

    if isinstance(expr, FEMExternalOperator):
        return expr._reconstruct_with_operands(new_operands)
    raise NotImplementedError(f"reconstruct {t}")


def replace(expr, mapping: dict):
    """Replace subexpressions (by structural equality)."""

    def fn(e):
        return mapping.get(e, e)

    return map_expr(fn, expr)


# ----------------------------------------------------------------------
# Gateaux differentiation
# ----------------------------------------------------------------------

_UNARY_DERIV = {
    "sqrt": lambda a: divide(Literal(np.float64(0.5)), Unary("sqrt", a)),
    "exp": lambda a: Unary("exp", a),
    "ln": lambda a: divide(Literal(np.float64(1.0)), a),
    "sin": lambda a: Unary("cos", a),
    "cos": lambda a: neg(Unary("sin", a)),
    "abs": lambda a: Unary("sign", a),
    "sign": lambda a: Zero(()),
    "arcsin": lambda a: divide(Literal(np.float64(1.0)), sqrt(add(Literal(np.float64(1.0)), neg(mul(a, a))))),
    "tan": lambda a: add(Literal(np.float64(1.0)), mul(Unary("tan", a), Unary("tan", a))),
}


def _gateaux(expr, u, du, memo):
    """d expr / d u in direction du."""
    key = id(expr)
    if key in memo:
        return memo[key]
    out = _gateaux_impl(expr, u, du, memo)
    assert out.shape == expr.shape, (type(expr).__name__, out.shape, expr.shape)
    memo[key] = out
    return out


def _gateaux_impl(expr, u, du, memo):
    from .external_operator import FEMExternalOperator
    from .function import Constant, Function

    if expr is u:
        return du
    if isinstance(expr, FEMExternalOperator):
        # chain rule through the user kernel: sum_i tensordot(dN/do_i, d o_i);
        # mixed output spaces contract per-component (reference
        # _replace_action mixed branch, external_operator.py:528-534)
        total = Zero(expr.shape)
        for i, op in enumerate(expr.ufl_operands):
            dop = _gateaux(op, u, du, memo)
            if is_zero(dop):
                continue
            dN = expr._derivative_node(i)
            total = add(total, dN._contract_with_direction(dop, len(op.shape)))
        return total
    if isinstance(expr, Variable):
        # transparent unless it IS the differentiation target (handled above)
        return _gateaux(expr.operands[0], u, du, memo)
    if isinstance(expr, (Zero, Literal, Constant, Argument, SpatialCoordinate, FacetNormal)) or (
        isinstance(expr, Function) and expr is not u
    ):
        return Zero(expr.shape)

    t = type(expr)
    ops = expr.operands
    if t is Sum:
        return add(_gateaux(ops[0], u, du, memo), _gateaux(ops[1], u, du, memo))
    if t is Product:
        return add(mul(_gateaux(ops[0], u, du, memo), ops[1]), mul(ops[0], _gateaux(ops[1], u, du, memo)))
    if t is Division:
        a, b = ops
        da, db = _gateaux(a, u, du, memo), _gateaux(b, u, du, memo)
        res = divide(da, b)
        if not is_zero(db):
            res = add(res, neg(divide(mul(db, a), mul(b, b))))
        return res
    if t is Power:
        a, p = ops
        da = _gateaux(a, u, du, memo)
        if is_zero(da):
            return Zero(())
        if not is_zero(_gateaux(p, u, du, memo)):
            raise NotImplementedError("d/du of exponent")
        return mul(mul(p, power(a, add(p, Literal(np.float64(-1.0))))), da)
    if t is Unary:
        da = _gateaux(ops[0], u, du, memo)
        if is_zero(da):
            return Zero(())
        return mul(_UNARY_DERIV[expr.op](ops[0]), da)
    if t is Conditional:
        cond, a, b = ops
        return conditional(cond, _gateaux(a, u, du, memo), _gateaux(b, u, du, memo))
    if t is Comparison:
        return Zero(())
    if t is Inner:
        return add(inner(_gateaux(ops[0], u, du, memo), ops[1]), inner(ops[0], _gateaux(ops[1], u, du, memo)))
    if t is Dot:
        return add(dot(_gateaux(ops[0], u, du, memo), ops[1]), dot(ops[0], _gateaux(ops[1], u, du, memo)))
    if t is Outer:
        return add(outer(_gateaux(ops[0], u, du, memo), ops[1]), outer(ops[0], _gateaux(ops[1], u, du, memo)))
    if t is TensorDot:
        return add(
            tensordot(_gateaux(ops[0], u, du, memo), ops[1], expr.n),
            tensordot(ops[0], _gateaux(ops[1], u, du, memo), expr.n),
        )
    if t is Transpose:
        return transpose(_gateaux(ops[0], u, du, memo))
    if t is Trace:
        return tr(_gateaux(ops[0], u, du, memo))
    if t is Grad:
        da = _gateaux(ops[0], u, du, memo)
        if is_zero(da):
            return Zero(expr.shape)
        return Grad(da, expr.gdim)
    if t is DivOp:
        da = _gateaux(ops[0], u, du, memo)
        if is_zero(da):
            return Zero(expr.shape)
        return DivOp(da, expr.gdim)
    if t is Indexed:
        return indexed(_gateaux(ops[0], u, du, memo), expr.idx)
    if t is AsTensor:
        return as_tensor([_gateaux(e, u, du, memo) for e in ops], expr.shape)
    raise NotImplementedError(f"gateaux of {t}")


def derivative(form: Form, u, du=None) -> Form:
    """Gateaux derivative of ``form`` w.r.t. coefficient ``u`` in direction
    ``du`` (default: a TrialFunction on u's space).

    Eager equivalent of ``ufl.derivative`` + ``expand_derivatives`` with the
    external-operator chain rule applied (reference:
    ``demo_plasticity_von_mises.py:390-391``)."""
    if du is None:
        du = TrialFunction(u.function_space)
    memo = {}
    return Form([Integral(_gateaux(itg.integrand, u, du, memo), itg.measure) for itg in form.integrals])


def expand_derivatives(form):
    """No-op for API parity: our ``derivative`` already expands eagerly."""
    return form


# ----------------------------------------------------------------------
# action / adjoint (for the multiaction/adjoint test path)
# ----------------------------------------------------------------------

def action(form: Form, coefficient) -> Form:
    """Replace the highest-numbered Argument by ``coefficient``."""
    args = form.arguments()
    assert args, "action on a form with no arguments"
    target = args[-1]
    return Form([Integral(replace(itg.integrand, {target: coefficient}), itg.measure) for itg in form.integrals])


def adjoint(form: Form) -> Form:
    """Swap test and trial arguments of a 2-form."""
    args = form.arguments()
    assert len(args) == 2, "adjoint needs a 2-form"
    test, trial = args[0], args[1]
    new_test = Argument(trial.function_space, 0)
    new_trial = Argument(test.function_space, 1)
    mapping = {test: new_trial, trial: new_test}
    return Form([Integral(replace(itg.integrand, mapping), itg.measure) for itg in form.integrals])


def split(f):
    """Split a mixed-space Function/coefficient into components (flattened
    per-subspace views, cf. ``ufl.split`` used at ``external_operator.py:529``)."""
    space = f.function_space
    assert getattr(space, "num_sub_spaces", 0) > 0, "split() needs a mixed space"
    out = []
    offset = 0
    for i in range(space.num_sub_spaces):
        sub = space.sub(i)
        bs = _prod(sub.value_shape)
        if sub.value_shape == ():
            out.append(indexed(f, (offset,)))
        else:
            entries = [indexed(f, (offset + k,)) for k in range(bs)]
            out.append(as_tensor(entries, sub.value_shape) if len(sub.value_shape) == 1 else
                       as_tensor(entries, sub.value_shape))
        offset += bs
    return tuple(out)

"""Functions (coefficients) and constants.

The port of ``dolfinx_external_operator_tpu/function.py:28-290``.  A
Function's dof vector is a torch tensor on an explicit device (``None``
means the card, through ``resolve_device``).  As in the JAX package, the
vector is a value: every write rebinds ``_data`` to a tensor the Function
owns, and nothing writes into a tensor in place, so a tensor read from
``f.data`` never changes under its reader.  ``f.x.array[:] = value``
accepts numpy arrays and tensors; a tensor on the Function's device is
copied there, with no host round trip.  Reads to the host are explicit:
``np.asarray(f.x.array)``, ``__array__`` and ``eval``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device, sym
from .elements import Element
from .functionspace import FunctionSpace

__all__ = ["Function", "Constant"]

_DTYPE = torch.float64


def _owned(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (numpy, tensor or number) as a tensor of ``like``'s dtype
    and device that shares no storage with a tensor the caller holds."""
    if isinstance(value, torch.Tensor):
        t = value.to(dtype=like.dtype, device=like.device)
        return t.clone() if t.data_ptr() == value.data_ptr() else t
    return torch.tensor(np.asarray(value), dtype=like.dtype, device=like.device)


class _ArrayProxy:
    """Mutable-looking view over a Function's dof tensor."""

    def __init__(self, owner):
        object.__setattr__(self, "_owner", owner)

    def __setitem__(self, idx, value):
        o = self._owner
        value = _owned(value, o._data)
        if idx == slice(None):
            o._data = (value.reshape(o._data.shape) if value.numel() == o._data.numel()
                       else value.reshape(-1)[:1].expand(o._data.shape).clone())
        else:
            data = o._data.clone()
            data[idx] = value
            o._data = data

    def __getitem__(self, idx):
        return self._owner._data[idx]

    def __array__(self, dtype=None, copy=None):
        arr = self._owner._data.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self):
        return self._owner._data.shape[0]

    @property
    def shape(self):
        return tuple(self._owner._data.shape)

    @property
    def dtype(self):
        return self._owner._data.dtype

    @property
    def size(self):
        return self._owner._data.numel()

    def reshape(self, *s):
        return self._owner._data.reshape(*s)

    def copy(self):
        return self._owner._data.clone()

    def __add__(self, other):
        return self._owner._data + other

    def __sub__(self, other):
        return self._owner._data - other

    def __mul__(self, other):
        return self._owner._data * other

    def max(self, *a, **k):
        return self._owner._data.max(*a, **k)

    def min(self, *a, **k):
        return self._owner._data.min(*a, **k)

    def __repr__(self):
        return f"array_proxy({self._owner._data!r})"


class _XVector:
    """Stands in for ``Function.x`` (dolfinx ``la.Vector``)."""

    def __init__(self, owner):
        self._owner = owner
        self._proxy = _ArrayProxy(owner)

    @property
    def array(self):
        return self._proxy

    @array.setter
    def array(self, value):
        self._owner._data = _owned(value, self._owner._data).reshape(self._owner._data.shape)

    def scatter_forward(self):
        """No ghosts in the owner-computes layout: nothing to do."""

    def scatter_reverse(self, *a, **k):
        pass

    def axpy(self, alpha, other):
        """x <- x + alpha * y (PETSc ``Vec.axpy`` parity)."""
        o = self._owner
        data = other._owner._data if isinstance(other, _XVector) else _owned(other, o._data)
        o._data = o._data + alpha * data

    @property
    def petsc_vec(self):
        return self


class Function(sym.Expr):
    """A finite element function: symbolic terminal + device dof vector."""

    def __init__(self, V: FunctionSpace, name: str | None = None, dtype=None, device=None):
        self.function_space = V
        self.shape = tuple(V.value_shape)
        self.operands = ()
        self.name = name or "f"
        self.dtype = dtype or _DTYPE
        self._data = torch.zeros((V.num_dofs,), dtype=self.dtype, device=resolve_device(device))
        self.device = self._data.device  # with its index: "cuda:0", not "cuda"
        self.x = _XVector(self)

    # terminal identity semantics
    def _key(self):
        return ("Function", id(self))

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    @property
    def data(self) -> torch.Tensor:
        """The dof tensor (read; never written in place)."""
        return self._data

    def __array__(self, dtype=None, copy=None):
        arr = self._data.detach().cpu().numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def copy_from(self, other: "Function"):
        self._data = other._data.to(self.device).clone()

    def interpolate(self, fn):
        """Interpolate a callable ``fn(x)`` (x shape (3, n_points), dolfinx
        convention), another Function, or a symbolic expression.  Runs on
        the host: a setup step, not a Newton step."""
        V = self.function_space
        if isinstance(fn, Function):
            fn = sym.as_expr(fn)
        if isinstance(fn, sym.Expr):
            from .expression import Expression

            expr = Expression(fn, V.element.interpolation_points, device=self.device)
            vals = expr.eval(V.mesh)  # (n_cells, n_ip) or (n_cells, n_ip, vs)
            vals = vals.detach().cpu().numpy().reshape(V.mesh.num_cells, -1)
            arr = np.zeros(V.num_dofs)
            arr[V.unrolled_dofmap.ravel()] = vals.ravel()
            self._data = torch.as_tensor(arr, dtype=self.dtype, device=self.device)
            return
        # callable of physical coordinates
        mesh = V.mesh
        ip = V.element.interpolation_points  # (n_ip, tdim)
        geo = Element("Lagrange", mesh.cell_type, 1)
        phi, _ = geo.tabulate(ip)  # (n_ip, n_verts)
        cell_coords = mesh.points[mesh.cells]  # (n_cells, n_verts, gdim)
        pts = np.einsum("pv,cvg->cpg", phi, cell_coords)  # (n_cells, n_ip, gdim)
        flat = pts.reshape(-1, mesh.gdim)
        x = np.zeros((3, flat.shape[0]))
        x[: mesh.gdim] = flat.T
        vals = np.asarray(fn(x))  # (n_pts,) or (bs, n_pts)
        bs = V.bs
        if bs == 1:
            vals = vals.reshape(mesh.num_cells, -1)
        else:
            assert vals.shape[0] == bs, f"expected ({bs}, n_points) from interpolation callable"
            vals = np.moveaxis(vals, 0, -1).reshape(mesh.num_cells, -1)  # (.., n_ip*bs) comp-fastest
        arr = np.zeros(V.num_dofs)
        arr[V.unrolled_dofmap.ravel()] = vals.ravel()
        self._data = torch.as_tensor(arr, dtype=self.dtype, device=self.device)

    def sub(self, i: int) -> "_SubFunction":
        """View of the i-th sub-function of a mixed-space Function."""
        assert self.function_space.num_sub_spaces > 0, "sub() on a non-mixed Function"
        return _SubFunction(self, i)

    def eval(self, points, cells):
        """Evaluate at physical points located in the given cells (probe
        path; reads the dof vector to the host)."""
        V = self.function_space
        mesh = V.mesh
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))[:, : mesh.gdim]
        cells = np.atleast_1d(np.asarray(cells, dtype=np.int32))
        geo = Element("Lagrange", mesh.cell_type, 1)
        out = np.zeros((points.shape[0], max(V.bs, 1)))
        data = self._data.detach().cpu().numpy()
        for i, (pt, c) in enumerate(zip(points, cells)):
            ref = _pull_back(mesh, geo, int(c), pt)
            phi, _ = V.element.tabulate(ref[None, :])  # (1, nb)
            dofs = V.dofmap[c]
            for comp in range(V.bs):
                out[i, comp] = phi[0] @ data[dofs * V.bs + comp]
        return out if V.bs > 1 else out[:, 0]

    def __repr__(self):
        return f"Function({self.name}, shape={self.shape})"


def _pull_back(mesh, geo_element, cell: int, x: np.ndarray) -> np.ndarray:
    """Physical -> reference coordinates in one cell (Newton for non-affine)."""
    verts = mesh.points[mesh.cells[cell]]  # (nv, gdim)
    tdim = geo_element.tdim
    xi = np.full(tdim, 1.0 / 3.0 if mesh.cell_type == "triangle" else 0.5)
    for _ in range(25):
        phi, dphi = geo_element.tabulate(xi[None, :])
        xx = phi[0] @ verts
        J = np.einsum("vd,vg->gd", dphi[0], verts)
        r = x - xx
        if np.linalg.norm(r) < 1e-13:
            break
        xi = xi + np.linalg.solve(J, r) if J.shape[0] == J.shape[1] else xi + np.linalg.lstsq(J, r, rcond=None)[0]
    return xi


class _SubFunction:
    """Writable view of one sub-space slice of a mixed-space Function."""

    def __init__(self, parent: Function, index: int):
        self.parent = parent
        self.index = index
        self.sub_space = parent.function_space.sub(index)

    def interpolate(self, fn):
        tmp = Function(self.sub_space, dtype=self.parent.dtype, device=self.parent.device)
        tmp.interpolate(fn)
        off = self.sub_space.sub_offset
        n = self.sub_space.num_dofs
        data = self.parent._data.clone()
        data[off: off + n] = tmp._data
        self.parent._data = data


class Constant(sym.Expr):
    """A mutable scalar/vector constant (updated without recompilation);
    its value lives on the host and goes to the device at each use."""

    def __init__(self, domain_or_value, value=None):
        if value is None:
            value = domain_or_value
        v = np.asarray(value, dtype=np.float64)
        self._value = v
        self.shape = v.shape
        self.operands = ()
        self.name = "c"

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        v = np.asarray(v, dtype=np.float64)
        assert v.shape == self._value.shape, "constant shape cannot change"
        self._value = v

    def _key(self):
        return ("Constant", id(self))

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

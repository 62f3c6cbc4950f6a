"""Mohr-Coulomb plasticity with Abbo-Sloan apex smoothing: the batched
return map and consistent tangent.

The port of the kernel side of ``dolfinx_external_operator_tpu/models/
mohr_coulomb.py``: ``solve_small`` (``:59-102``), ``MohrCoulombMaterial``
(constants ``:112-137``, ``:148-149``, ``:220-222``; return map
``:224-342``; tangent ``:344-361``; sorted chunks ``:384-486``; flat-array
entry points ``:488-513``).  The JAX package writes a per-point map and
vmaps it; here every map is written on the batch directly, with the
Gauss-point axis LAST (SoA).  This is the plain f64 version: the tests
hold it against the JAX package, and on the card it is the yardstick of
the hand-written kernel ``ops.mohr_coulomb`` (``csrc/mohr_coulomb.cu``),
which ``batched_kernel("cuda")`` puts on the main path.

Per point: the trial stress and the plastic test f(sigma_tr) > 0; an f32
damped Newton on r(sigma, dlambda) with the closed-form Jacobian, a
6-candidate line search and a stagnation exit; an f64 polish with a
3-candidate line search to ``tol``; then the implicit-function tangent
dy*/deps = J(y*)^-1 [C; 0].  Each Newton loop runs while any lane is
active, and a lane freezes once its own condition fails, as
``vmap(while_loop)`` freezes it: each lane's result and iteration count are
those of the point alone.

The slope-stability problem through the general pipeline (``epsilon``,
``build_slope_problem``, ``solve_slope_stability``; JAX module
``:516-626``): the form with the stress as a ``FEMExternalOperator`` whose
callback runs this material, and the Newton solver of ``solvers.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.abbo_sloan import grad_and_hess, make_surface, surface_constants

__all__ = ["MohrCoulombMaterial", "build_slope_problem", "epsilon", "solve_slope_stability",
           "solve_small"]

STRESS_DIM = 4

_F32, _F64 = torch.float32, torch.float64
_ALPHAS32 = (1.0, 0.5, 0.25, 0.0625, 2.0**-6, 2.0**-10)
_ALPHAS64 = (1.0, 0.25, 2.0**-10)
_STALL = 1.0 - 1e-3

# layout of the packed f64 constants handed to the kernel
# (csrc/mohr_coulomb.cuh, ``make_params``)
_SURFACE_KEYS = ("sin_a", "c_cos_a", "asa2", "Ap", "Bp", "Cp", "Am", "Bm", "Cm")
_SHARED_KEYS = ("inv_sqrt3", "c0", "sinT", "sin3T")
_KERNEL_PARAMS = 16 + 2 * len(_SURFACE_KEYS) + len(_SHARED_KEYS) + 5


def solve_small(A, b):
    """Unrolled Gaussian elimination with pairwise max-bubbling partial
    pivoting, batched over the trailing axes.

    ``A`` is ``(n, n, *batch)``; ``b`` is ``(n, *batch)`` (one right-hand
    side) or ``(n, m, *batch)`` (a block).  The same pivot choices and the
    same operations in the same order as the JAX package's per-point
    ``solve_small``: row k is swapped with each row below it whose entry in
    column k is larger in magnitude, then the rows below are eliminated.
    Columns left of the pivot are swapped too; no later step reads them."""
    n = A.shape[0]
    vec = b.dim() == A.dim() - 1
    B = b.unsqueeze(1) if vec else b
    m = B.shape[1]
    R = torch.cat([A, B.to(A.dtype)], dim=1).clone()
    for k in range(n):
        for i in range(k + 1, n):
            swap = torch.abs(R[i, k]) > torch.abs(R[k, k])
            rk, ri = R[k, k:].clone(), R[i, k:].clone()
            R[k, k:] = torch.where(swap, ri, rk)
            R[i, k:] = torch.where(swap, rk, ri)
        inv_piv = 1.0 / R[k, k]
        if k + 1 < n:
            f = R[k + 1:, k] * inv_piv
            R[k + 1:, k + 1:] = R[k + 1:, k + 1:] - f.unsqueeze(1) * R[k, k + 1:].unsqueeze(0)
    x = torch.empty((n, m) + tuple(A.shape[2:]), dtype=A.dtype, device=A.device)
    for i in range(n - 1, -1, -1):
        inv_d = 1.0 / R[i, i]
        acc = R[i, n:]
        for kk in range(i + 1, n):
            acc = acc - R[i, kk] * x[kk]
        x[i] = acc * inv_d
    return x[:, 0] if vec else x


def _mv(Cl, v):
    """``C @ v`` over the leading axis for a 4x4 matrix of Python floats
    (rounded to v's dtype), summed in column order."""
    return torch.stack([Cl[i][0] * v[0] + Cl[i][1] * v[1] + Cl[i][2] * v[2] + Cl[i][3] * v[3]
                        for i in range(STRESS_DIM)])


def _norm(r):
    return torch.sqrt((r * r).sum(0))


class MohrCoulombMaterial:
    """Mohr-Coulomb return mapping with consistent tangent.

    Parameters and defaults follow the JAX package (reference demo
    ``:110-116``): E [MPa], nu, cohesion c [MPa], friction angle phi [rad],
    dilatancy angle psi [rad], transition angle theta_T [rad], apex
    parameter a [MPa] (default 0.26 c / tan(phi)), the f64 tolerance and
    cap ``tol``/``max_iter``, ``n_polish``, and the f32 phase's cap and
    tolerance ``max_iter32``/``tol32``."""

    def __init__(self, E=6778.0, nu=0.25, c=3.45, phi=30 * np.pi / 180,
                 psi=30 * np.pi / 180, theta_T=26 * np.pi / 180, a=None,
                 tol=1e-8, max_iter=200, n_polish=2, max_iter32=40, tol32=1e-5):
        self.E, self.nu, self.c = E, nu, c
        self.phi, self.psi, self.theta_T = phi, psi, theta_T
        self.a = 0.26 * c / np.tan(phi) if a is None else a
        self.tol, self.max_iter = tol, max_iter
        self.n_polish = n_polish
        self.max_iter32 = max_iter32
        self.tol32 = tol32

        lmbda = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        mu = E / (2.0 * (1.0 + nu))
        self.C_elas = np.array(
            [
                [lmbda + 2 * mu, lmbda, lmbda, 0.0],
                [lmbda, lmbda + 2 * mu, lmbda, 0.0],
                [lmbda, lmbda, lmbda + 2 * mu, 0.0],
                [0.0, 0.0, 0.0, 2 * mu],
            ]
        )
        # derived constants of _build (:148-149, :220-222)
        self.a_f = float(self.a)
        self.a_g = float(self.a * np.tan(phi) / np.tan(psi))
        self.n_polish_max = max(self.n_polish, 60)
        self.tol32_eff = max(tol, self.tol32)
        self.max_iter32_eff = min(max_iter, self.max_iter32)
        self._C = self.C_elas.tolist()
        self._surf = {}
        for dt in (_F32, _F64):
            self._surf[dt, "f"] = make_surface(c, phi, self.a_f, theta_T, dt)
            self._surf[dt, "g"] = make_surface(c, psi, self.a_g, theta_T, dt)

    # -- surfaces -----------------------------------------------------------
    def f_yield(self, sig):
        """Yield function (f64) of stresses ``(4, *batch)``."""
        return self._surf[_F64, "f"][0](sig)[0]

    def g_pot(self, sig):
        """Plastic potential (f64) of stresses ``(4, *batch)``."""
        return self._surf[_F64, "g"][0](sig)[0]

    # -- residual and Jacobian (:166-216) -------------------------------------
    def _residual(self, y, d, sn, plastic):
        """r(y) with y = (sigma, dlambda) ``(5, *batch)``: the plastic
        branch rg = sigma - sigma_n - C (deps - dl grad_g), rf = f(sigma);
        the elastic branch rg = sigma - sigma_n - C deps, rf = dl."""
        dt = y.dtype
        sig, dl = y[:STRESS_DIM], y[STRESS_DIM]
        _, dg = self._surf[dt, "g"][0](sig)
        ff, _ = self._surf[dt, "f"][0](sig)
        zero = torch.zeros((), dtype=dt, device=y.device)
        dlp = torch.where(plastic, dl, zero)
        rg = sig - sn - _mv(self._C, d - dlp * dg)
        rf = torch.where(plastic, ff, dl)
        return torch.cat([rg, rf.unsqueeze(0)])

    def _jacobian(self, y, plastic):
        """J = [[I + dl C Hg, C grad_g], [grad_f^T, 0]] (plastic) or I_5
        (elastic), ``(5, 5, *batch)``; Hg is the forward-mode derivative of
        the potential's closed-form gradient in the four basis directions."""
        dt = y.dtype
        sig, dl = y[:STRESS_DIM], y[STRESS_DIM]
        dg, Hg = grad_and_hess(self._surf[dt, "g"][0], sig)
        _, df = self._surf[dt, "f"][0](sig)
        zero = torch.zeros((), dtype=dt, device=y.device)
        one = torch.ones((), dtype=dt, device=y.device)
        dlp = torch.where(plastic, dl, zero)
        eye = torch.eye(STRESS_DIM, dtype=dt, device=y.device).reshape(
            (STRESS_DIM, STRESS_DIM) + (1,) * (y.dim() - 1))
        Jgg = eye + dlp * _mv(self._C, Hg)
        Jgl = torch.where(plastic, _mv(self._C, dg), zero)
        Jfg = torch.where(plastic, df, zero)
        Jfl = torch.where(plastic, zero, one).expand_as(dl)
        top = torch.cat([Jgg, Jgl.unsqueeze(1)], dim=1)
        bot = torch.cat([Jfg, Jfl.unsqueeze(0)]).unsqueeze(0)
        return torch.cat([top, bot], dim=0)

    # -- the damped Newton loops (:255-295, :305-338) --------------------------
    def _newton(self, y, res, norm, scale, tol, max_it, alphas, d, sn, plastic):
        """Damped Newton on every lane until its own exit: residual below
        ``tol * scale``, ``max_it`` iterations, or a stalled step.  Each
        pass works on the lanes still active only, so a lane's arithmetic
        is that of the point alone.  Returns (y, res, norm, niter)."""
        dt, dev = y.dtype, y.device
        n = y.shape[-1]
        alph = torch.tensor(alphas, dtype=dt, device=dev).reshape(1, -1, 1)
        na = len(alphas)
        y, res, norm = y.clone(), res.clone(), norm.clone()
        niter = torch.zeros(n, dtype=torch.int32, device=dev)
        active = (norm / scale > tol) & (niter < max_it)
        while bool(active.any()):
            idx = torch.nonzero(active).squeeze(1)
            y_a, res_a, norm_a = y[:, idx], res[:, idx], norm[idx]
            d_a, sn_a, p_a = d[:, idx], sn[:, idx], plastic[idx]
            dy = solve_small(self._jacobian(y_a, p_a), -res_a)
            # all candidate steps in one sweep; the first that reduces |r|,
            # else the shortest, picked with a one-hot sum as the JAX
            # package picks it (so a non-finite candidate taints the lane)
            ys = y_a.unsqueeze(1) + alph * dy.unsqueeze(1)  # (5, na, m)
            rc = self._residual(ys, d_a.unsqueeze(1), sn_a.unsqueeze(1), p_a.unsqueeze(0))
            norms = _norm(rc)  # (na, m)
            improving = norms < norm_a
            first = torch.argmax(improving.to(torch.int32), dim=0)
            pick = torch.where(improving.any(0), first, torch.full_like(first, na - 1))
            onehot = (torch.arange(na, device=dev).unsqueeze(1) == pick).to(dt)
            y_new = (onehot * ys).sum(1)
            res_new = (onehot * rc).sum(1)
            rn = (onehot * norms).sum(0)
            stalled = rn >= norm_a * _STALL
            it_new = niter[idx] + 1
            y[:, idx], res[:, idx], norm[idx], niter[idx] = y_new, res_new, rn, it_new
            active[idx] = ~stalled & (rn / scale[idx] > tol) & (it_new < max_it)
        return y, res, norm, niter

    def return_map(self, deps, sn):
        """Mixed-precision Newton return map on SoA f64 inputs ``(4, n)``.

        Returns ``(sig (4, n), niter (n,) int32, yielding, norm_res,
        dlambda)``, the last three f64 ``(n,)``: the trial yield value, the
        final f64 residual norm and the plastic multiplier."""
        _check_soa(deps, sn)
        C = self._C
        Cd = _mv(C, deps)
        sig_tr = sn + Cd
        yielding, _ = self._surf[_F64, "f"][0](sig_tr)
        plastic = yielding > 0.0
        zero = torch.zeros((), dtype=_F64, device=deps.device)
        scale0 = torch.maximum(
            torch.sqrt((Cd * Cd).sum(0) + torch.where(plastic, yielding, zero) ** 2),
            torch.tensor(1e-30, dtype=_F64, device=deps.device))

        # f32 phase from the trial state (elastic lanes: zero residual)
        d32, s32 = deps.to(_F32), sn.to(_F32)
        n = deps.shape[1]
        y0 = torch.cat([sig_tr.to(_F32), torch.zeros((1, n), dtype=_F32, device=deps.device)])
        res0 = self._residual(y0, d32, s32, plastic)
        y32, _, _, it32 = self._newton(y0, res0, _norm(res0), scale0.to(_F32), self.tol32_eff,
                                       self.max_iter32_eff, _ALPHAS32, d32, s32, plastic)

        # f64 polish; elastic lanes restart from the exact f64 trial state
        y_el = torch.cat([sig_tr, torch.zeros((1, n), dtype=_F64, device=deps.device)])
        y = torch.where(plastic, y32.to(_F64), y_el)
        res = self._residual(y, deps, sn, plastic)
        y, _, norm_res, it64 = self._newton(y, res, _norm(res), scale0, self.tol,
                                            self.n_polish_max, _ALPHAS64, deps, sn, plastic)
        return y[:STRESS_DIM], it32 + it64, yielding, norm_res, y[STRESS_DIM]

    def tangent_stress(self, deps, sn):
        """Consistent tangent by the implicit function theorem on SoA f64
        inputs: ``(C_tang (4, 4, n), (sig, niter, yielding, norm_res,
        dlambda))``.  dr/ddeps = [[-C], [0]] is constant, so dy*/deps =
        J(y*)^-1 [[C], [0]]; elastic lanes (J = I) give C_elas exactly."""
        aux = self.return_map(deps, sn)
        sig, _, yielding, _, dlambda = aux
        y = torch.cat([sig, dlambda.unsqueeze(0)])
        J = self._jacobian(y, yielding > 0.0)
        n = deps.shape[1]
        C = torch.tensor(self.C_elas, dtype=_F64, device=deps.device)
        rhs = torch.cat([C, torch.zeros((1, STRESS_DIM), dtype=_F64, device=deps.device)])
        X = solve_small(J, rhs.unsqueeze(-1).expand(-1, -1, n))
        return X[:STRESS_DIM], aux

    # -- batch entry points ---------------------------------------------------
    def _sorted_soa(self, deps, sn, chunk):
        """Difficulty-sorted chunks (:384-466): lanes sorted by trial yield,
        each chunk of ``chunk`` lanes takes the full map, or the exact
        elastic shortcut when no lane in it yields.  With a single chunk
        nothing is sorted.  Lanes are independent, so the outputs equal the
        unsorted map's but for the elastic chunks' ``norm_res`` (0)."""
        _check_soa(deps, sn)
        n = deps.shape[1]
        n_pad = -(-n // chunk) * chunk
        d = F.pad(deps, (0, n_pad - n))
        s = F.pad(sn, (0, n_pad - n))
        f_tr = self.f_yield(_mv(self._C, d) + s)

        def process_chunk(d_c, s_c, f_c):
            if bool(f_c.max() <= 0.0):
                sig_tr_c = _mv(self._C, d_c) + s_c
                zc = torch.zeros(chunk, dtype=_F64, device=d_c.device)
                C_t = torch.tensor(self.C_elas, dtype=_F64, device=d_c.device)
                return (C_t.unsqueeze(-1).expand(-1, -1, chunk).clone(),
                        (sig_tr_c, torch.zeros(chunk, dtype=torch.int32, device=d_c.device),
                         f_c, zc, zc.clone()))
            return self.tangent_stress(d_c, s_c)

        if n_pad == chunk:
            C_1, aux_1 = process_chunk(d, s, f_tr)
            return C_1[..., :n], tuple(a[..., :n] for a in aux_1)
        order = torch.argsort(f_tr, stable=True)
        inv = torch.argsort(order, stable=True)
        outs = [process_chunk(d[:, order[k:k + chunk]], s[:, order[k:k + chunk]],
                              f_tr[order[k:k + chunk]]) for k in range(0, n_pad, chunk)]

        def unchunk(parts):
            return torch.cat(parts, dim=-1)[..., inv][..., :n]

        C_t = unchunk([o[0] for o in outs])
        aux = tuple(unchunk([o[1][j] for o in outs]) for j in range(5))
        return C_t, aux

    def tangent_and_stress(self, deps_flat, sigma_n_flat, route="cuda"):
        """Batched consistent tangent and stress on flat point-major arrays
        (the external-function body): ``(C (n*16,), sig (n*4,), stats)``.
        ``route`` as in ``batched_kernel``: the general path and the fused
        step reach the kernel through the same wrapper and its count."""
        C_t, aux = self._soa_map(route)(*_to_soa(deps_flat, sigma_n_flat))
        return _to_flat(C_t, aux)

    def tangent_and_stress_sorted(self, deps_flat, sigma_n_flat, chunk=8192):
        """``tangent_and_stress`` through the difficulty-sorted chunks."""
        C_t, aux = self._sorted_soa(*_to_soa(deps_flat, sigma_n_flat), chunk)
        return _to_flat(C_t, aux)

    def stress_only(self, deps_flat, sigma_n_flat):
        sig = self.return_map(*_to_soa(deps_flat, sigma_n_flat))[0]
        return sig.T.reshape(-1)

    def batched_kernel_sorted(self, chunk=8192):
        """The sorted plain map in the fused step's SoA contract."""

        def batched(deps_soa, sn_soa):
            C_t, aux = self._sorted_soa(deps_soa, sn_soa, chunk)
            return C_t, aux[0]

        return batched

    def _soa_map(self, route):
        """``(deps (4, n), sigma_n (4, n)) -> (C_tang (4, 4, n), (sig, niter,
        yielding, norm_res, dlambda))`` on contiguous SoA inputs, by
        ``route``: ``"plain"``, this module's f64 PyTorch version;
        ``"cuda"``, ``ops.mohr_coulomb.mc_return_map``, which launches the
        hand-written kernel on CUDA tensors (its plain version on CPU
        tensors).  No route falls back to the other."""
        if route == "plain":
            def soa(deps_soa, sn_soa):
                return self.tangent_stress(deps_soa.contiguous(), sn_soa.contiguous())
        elif route == "cuda":
            from ..ops.mohr_coulomb import mc_return_map

            def soa(deps_soa, sn_soa):
                n = deps_soa.shape[1]
                C, *aux = mc_return_map(deps_soa.contiguous(), sn_soa.contiguous(), self)
                return C.view(STRESS_DIM, STRESS_DIM, n), tuple(aux)
        else:
            raise ValueError(f"route must be 'plain' or 'cuda', got {route!r}")
        return soa

    def batched_kernel(self, route="cuda"):
        """The constitutive map in the fused step's SoA contract
        ``(deps (4, n), sigma_n (4, n)) -> (C_tang (4, 4, n), sig (4, n))``,
        by ``route`` (``_soa_map``)."""
        soa = self._soa_map(route)

        def batched(deps_soa, sn_soa):
            C_t, aux = soa(deps_soa, sn_soa)
            return C_t, aux[0]

        return batched

    def kernel_params(self):
        """The packed f64 constants of the kernel (``csrc/mohr_coulomb.cuh``
        ``make_params``): C_elas row-major, the yield and potential
        surfaces' constants, the shared ones, then tol, the f32 phase's
        tolerance and cap, the polish cap, and 1.0 when the two surfaces
        are the same (associative flow)."""
        kf = surface_constants(self.c, self.phi, self.a_f, self.theta_T)
        kg = surface_constants(self.c, self.psi, self.a_g, self.theta_T)
        assoc = all(kf[key] == kg[key] for key in _SURFACE_KEYS)
        p = np.concatenate([
            self.C_elas.ravel(),
            [kf[key] for key in _SURFACE_KEYS],
            [kg[key] for key in _SURFACE_KEYS],
            [kf[key] for key in _SHARED_KEYS],
            [self.tol, self.tol32_eff, self.max_iter32_eff, self.n_polish_max, float(assoc)],
        ]).astype(np.float64)
        if p.size != _KERNEL_PARAMS:
            raise RuntimeError(f"packed {p.size} kernel constants, expected {_KERNEL_PARAMS}")
        return p


def _check_soa(deps, sn):
    n = deps.shape[-1]
    for name, t in (("deps", deps), ("sigma_n", sn)):
        if t.dtype != _F64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != (STRESS_DIM, n):
            raise ValueError(f"{name} must have shape (4, {n}), got {tuple(t.shape)}")
    if sn.device != deps.device:
        raise ValueError(f"sigma_n lies on {sn.device}, deps on {deps.device}")


def _to_soa(deps_flat, sigma_n_flat):
    return deps_flat.reshape(-1, STRESS_DIM).T, sigma_n_flat.reshape(-1, STRESS_DIM).T


def _to_flat(C_t, aux):
    sig, niter, yielding, norm_res, _ = aux
    stats = {"niter": niter, "max_f": yielding.max(), "max_res": norm_res.max()}
    return C_t.permute(2, 0, 1).reshape(-1), sig.T.reshape(-1), stats



# ----------------------------------------------------------------------
# The slope-stability problem through the general pipeline
# ----------------------------------------------------------------------

def epsilon(v):
    """The strain of a 2D displacement in the 4-vector (Mandel) layout."""
    from ..sym import as_vector, grad

    g = grad(v)
    return as_vector([g[0, 0], g[1, 1], 0.0, np.sqrt(2.0) * 0.5 * (g[0, 1] + g[1, 0])])


def build_slope_problem(Nx=25, Ny=25, L=1.2, H=1.0, gamma=1.0, material=None,
                        snes_opts=None, verbose_inner=False, device=None, route="cuda"):
    """Assemble the slope-stability problem (reference :119-700) on
    ``device`` (``None``: the card; raises without one).

    The stress is a ``FEMExternalOperator`` of ``epsilon(Du)`` with the
    previous stress as a hidden operand; its derivative's callback runs the
    material through ``route`` (``MohrCoulombMaterial._soa_map``): the
    hand-written kernel K1 on CUDA tensors with ``"cuda"``, the plain f64
    map with ``"plain"``.  Returns a dict of handles; ``problem.solve()``
    runs one load step after setting ``q.value``."""
    from .. import resolve_device, solvers
    from ..assembly import DirichletBC, locate_dofs_geometrical
    from ..elements import quadrature_element
    from ..external_operator import (
        FEMExternalOperator,
        evaluate_external_operators,
        evaluate_operands,
        replace_external_operators,
    )
    from ..function import Constant, Function
    from ..functionspace import functionspace
    from ..mesh import create_rectangle
    from ..sym import Measure, TestFunction, TrialFunction, derivative, dot, inner

    dev = resolve_device(device)
    material = material or MohrCoulombMaterial()
    material._soa_map(route)  # an unknown route raises here
    mesh = create_rectangle((0.0, 0.0), (L, H), (Nx, Ny), "triangle")
    k_u = 2
    V = functionspace(mesh, ("Lagrange", k_u, (2,)))

    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[0], L))
    bcs = []
    for sdofs in (bottom, right):
        unrolled = np.concatenate([sdofs * 2, sdofs * 2 + 1])
        bcs.append(DirichletBC(unrolled, np.zeros(unrolled.size)))

    k_stress = 2 * (k_u - 1)
    dx = Measure("dx", domain=mesh, metadata={"quadrature_degree": k_stress, "quadrature_scheme": "default"})
    S = functionspace(mesh, quadrature_element(mesh.cell_name(), degree=k_stress, value_shape=(STRESS_DIM,)))

    Du = Function(V, name="Du", device=dev)
    u = Function(V, name="total_displacement", device=dev)
    v = TestFunction(V)
    u_hat = TrialFunction(V)

    sigma_n = Function(S, name="sigma_n", device=dev)
    sigma = FEMExternalOperator(epsilon(Du), function_space=S,
                                hidden_operands=[sigma_n], name="sigma")
    stats_box = {}

    def C_tang_impl(deps, sigma_n_arr):
        C_tang, sig, stats = material.tangent_and_stress(deps, sigma_n_arr, route=route)
        stats_box.update(stats)
        if verbose_inner:
            uniq, counts = np.unique(stats["niter"].cpu().numpy(), return_counts=True)
            print(f"\tInner Newton: iters {uniq.tolist()} counts {counts.tolist()} "
                  f"max_f {float(stats['max_f']):.3e} max_res {float(stats['max_res']):.3e}")
        return C_tang, sig

    def sigma_external(derivatives):
        if derivatives == (1,):
            return C_tang_impl
        raise NotImplementedError(derivatives)

    sigma.external_function = sigma_external

    q = Constant(np.array([0.0, -gamma]))
    F = inner(epsilon(v), sigma) * dx - dot(q, v) * dx
    J = derivative(F, Du, u_hat)
    F_replaced, F_ops = replace_external_operators(F)
    J_replaced, J_ops = replace_external_operators(J)

    def constitutive_update():
        evaluated = evaluate_operands(F_ops)
        ((_, sigma_new),) = evaluate_external_operators(J_ops, evaluated)
        sigma.ref_coefficient.x.array[:] = sigma_new

    opts = {"snes_atol": 1e-8, "snes_rtol": 1e-8, "snes_max_it": 100}
    opts.update(snes_opts or {})
    problem = solvers.NonlinearProblem(F_replaced, Du, J_replaced, bcs=bcs,
                                       petsc_options=opts, external_callback=constitutive_update)
    return {
        "mesh": mesh, "V": V, "S": S, "Du": Du, "u": u, "sigma": sigma,
        "sigma_n": sigma_n, "q": q, "problem": problem, "material": material,
        "bcs": bcs, "F_replaced": F_replaced, "J_replaced": J_replaced,
        "F_ops": F_ops, "J_ops": J_ops, "stats": stats_box, "gamma": gamma,
        "H": H, "constitutive_update": constitutive_update,
    }


def solve_slope_stability(Nx=25, Ny=25, load_steps=None, verbose=False, capture=(), **kw):
    """Run the slope-stability load schedule (reference :708-733); ``kw``
    go to ``build_slope_problem`` (``device``, ``route``, ...).

    Default schedule: 50 steps gamma in [2, 22.9] plus [22.96, 22.99].
    Besides the JAX package's results: ``step_s``, the host seconds of each
    step, ``backtracks``, each step's count of divergence backtracking
    (``NewtonSolver.backtrack_count``), and ``states``, the starting
    ``(Du, sigma_n)`` tensors of the steps whose indices are in
    ``capture``."""
    import time

    from ..utils.probes import find_cell_by_point

    P = build_slope_problem(Nx=Nx, Ny=Ny, **kw)
    mesh, u, Du, sigma, sigma_n, q = P["mesh"], P["u"], P["Du"], P["sigma"], P["sigma_n"], P["q"]
    gamma, H = P["gamma"], P["H"]
    if load_steps is None:
        load_steps = np.concatenate([np.linspace(2, 22.9, 50), np.array([22.96, 22.99])])

    x_point = np.array([[0, H, 0]])
    cells, points = find_cell_by_point(mesh, x_point)
    num = len(load_steps)
    results = np.zeros((num + 1, 2))
    iterations, step_s, backtracks, states = [], [], [], {}

    # initialize the tangent with elastic moduli (reference :645-649)
    Du.x.array[:] = np.ones(P["V"].num_dofs)
    sigma_n.x.array[:] = np.zeros(P["S"].num_dofs)
    P["constitutive_update"]()

    for i, load in enumerate(load_steps):
        if i in capture:
            states[i] = (Du.data, sigma_n.data)
        t0 = time.perf_counter()
        q.value = load * np.array([0.0, -gamma])
        if verbose:
            print(f"Load increment #{i}, load: {load}")
        its, _ = P["problem"].solve()
        iterations.append(its)
        backtracks.append(P["problem"].solver.backtrack_count)
        u.x.axpy(1.0, Du.x)
        sigma_n.x.array[:] = sigma.ref_coefficient.data
        if points:
            results[i + 1, :] = (-float(u.eval(points, cells)[0, 0]), load)
        step_s.append(time.perf_counter() - t0)

    slope_factor = float(load_steps[-1]) * H / P["material"].c
    return {"results": results, "iterations": iterations, "slope_factor": slope_factor,
            "step_s": step_s, "backtracks": backtracks, "states": states, **P}

"""The port's counterparts of the JAX package's entry points
(``__graft_entry__.py``): ``entry()``, one Newton-solved load step of the
main path with AMG-CG, and ``dryrun_multichip(n)``, that program cell-sharded
over ``n`` ranks.

``slope_schedule`` is the function each rank runs; ``dist.spawn`` pickles
it by name, so it lives here, in a module that imports no JAX.
``general_slope_schedule`` is its counterpart for the general pipeline:
``solve_slope_stability`` with every form and expression sharded over
the ranks (``parallel.set_default_device_mesh``).
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as tdist

from .ops import mohr_coulomb as mc_ops
from .parallel import dist
from .problems import mohr_coulomb_slope_step

__all__ = ["DRYRUN_LOADS", "dryrun_multichip", "entry", "general_slope_schedule",
           "slope_schedule"]

# the two load steps of __graft_entry__.dryrun_multichip (:122)
DRYRUN_LOADS = (2.0, 2.43)


def entry(device=None):
    """``(fn, example_args)``: one full Newton-solved load step of the main
    path, the Mohr-Coulomb slope on the 25x25 mesh with AMG-CG
    (``__graft_entry__.py:61-82``).  ``fn(Du, sigma_n, load)`` is the
    step's ``run_step``; the arguments are the zero state and load 2.0."""
    fp = mohr_coulomb_slope_step(25, 25, device=device, linear_solver="mg")
    Du, sig = fp.zero_state()
    return fp.run_step, (Du, sig, 2.0)


def slope_schedule(mesh, N, loads, linear_solver="mg", **opts):
    """Rank function of ``dist.spawn``: the ``N x N`` slope step with K1
    sharded on ``mesh`` (``mohr_coulomb_slope_step(..., device_mesh=mesh)``)
    over ``loads`` from the zero state.

    Returns, as host values: the Newton list, inner counts, residual norms
    and host seconds per step, the final Du (whole), this rank's sigma and
    its shape, the rank's K1 launches, all-reduces and their bytes over the
    schedule, and its Newton passes (updates + steps: every step ends on a
    pass that makes no update)."""
    fp = mohr_coulomb_slope_step(N, N, linear_solver=linear_solver, device_mesh=mesh, **opts)
    Du, sig = fp.zero_state()
    cuda = mesh.device.type == "cuda"
    mc_ops.mc_return_map.launches = dist.psum.calls = dist.psum.bytes = 0
    its, inner, norms, walls = [], [], [], []
    for load in loads:
        t0 = time.perf_counter()
        Du, sig, norm, it, cg = fp.run_step(Du, sig, float(load))
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        its.append(int(it))
        inner.append(int(cg))
        norms.append(float(norm))
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "solver": fp.linear_solver, "newton": its,
            "inner": inner, "norms": norms, "wall_s": walls, "du": Du.cpu().numpy(),
            "sigma": sig.cpu().numpy(), "sigma_shape": tuple(sig.shape), "nc_pad": fp.nc_pad,
            "nq": fp.nq, "launches": mc_ops.mc_return_map.launches,
            "psum_calls": dist.psum.calls, "psum_bytes": dist.psum.bytes,
            "passes": sum(its) + len(its)}


def _collective_ms(mesh, calls, reps=20):
    """Host milliseconds per call of each collective of ``calls`` (one
    entry per (name, length, dtype): ``all_reduce`` through ``dist.psum``,
    ``all_gather`` through ``dist.all_gather``, of a tensor of this rank's
    length), over ``reps`` calls ending in a synchronise."""
    out = {}
    for name, n, dtype in sorted(set(calls)):
        x = torch.ones(n, dtype=getattr(torch, dtype), device=mesh.device)
        fn = dist.psum if name == "all_reduce" else dist.all_gather
        fn(x, group=mesh.group)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x, group=mesh.group)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize()
        out[f"{name} {n} {dtype}"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def general_slope_schedule(mesh, N, loads, route="cuda"):
    """Rank function of ``dist.spawn``: the ``N x N`` slope through the
    general pipeline (``models.mohr_coulomb.solve_slope_stability``) over
    ``loads``, with every form and expression sharded on ``mesh``, so each
    rank's return map (K1 with ``route="cuda"``) runs on its own Gauss
    points.

    Returns, as host values: the Newton list, backtracks and host seconds
    per step, the final u (whole), the rank's K1 launches, the point
    counts its return map saw, its ``dist.psum`` and ``dist.all_gather``
    calls with each call's (name, length, dtype) counted and timed after
    the run (``_collective_ms``), and the peak device memory."""
    from . import parallel
    from .models.mohr_coulomb import MohrCoulombMaterial, solve_slope_stability

    material = MohrCoulombMaterial()
    points, calls = [], []
    map_points = material.tangent_and_stress

    def counted(deps, sigma_n, route="cuda"):
        points.append(int(deps.numel() // 4))
        return map_points(deps, sigma_n, route=route)

    material.tangent_and_stress = counted
    saved = tdist.all_reduce, tdist.all_gather

    def recorder(name, fn, arg):
        def call(*args, **kwargs):
            x = args[arg]
            calls.append((name, int(x.numel()), str(x.dtype).split(".")[-1]))
            return fn(*args, **kwargs)
        return call

    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    parallel.set_default_device_mesh(mesh)
    tdist.all_reduce = recorder("all_reduce", saved[0], 0)
    tdist.all_gather = recorder("all_gather", saved[1], 1)
    mc_ops.mc_return_map.launches = dist.psum.calls = dist.all_gather.calls = 0
    try:
        t0 = time.perf_counter()
        run = solve_slope_stability(N, N, loads, device=mesh.device, route=route,
                                    material=material)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tdist.all_reduce, tdist.all_gather = saved
        parallel.set_default_device_mesh(None)
    its = run["iterations"]
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "newton": its, "backtracks": run["backtracks"],
            "step_s": run["step_s"], "wall_s": wall, "u": run["u"].data.cpu().numpy(),
            "launches": mc_ops.mc_return_map.launches, "points": sorted(set(points)),
            "map_calls": len(points), "psum_calls": dist.psum.calls,
            "gather_calls": dist.all_gather.calls,
            "collectives": {f"{name} {n} {dt}": calls.count((name, n, dt))
                            for name, n, dt in sorted(set(calls))},
            "collective_ms": _collective_ms(mesh, calls),
            "passes": sum(its) + len(its) + sum(run["backtracks"]),
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def dryrun_multichip(n_devices, backend=None, device=None):
    """One sharded run of the 16x16 slope with AMG-CG over loads 2.0 and
    2.43 on ``n_devices`` ranks (``__graft_entry__.py:85-131``), one process
    each.  ``backend``: ``None`` picks NCCL where every rank has a card of
    its own, else gloo (on the CPU, or several ranks sharing a card).
    ``device``: ``None`` (the card) or ``"cpu"``.  Asserts a finite residual
    and at least one Newton update per step, prints per step the Newton
    and inner counts, the residual and each rank's sigma shape, and returns
    the ranks' ``slope_schedule`` results."""
    if backend is None:
        on_card = device is None or torch.device(device).type == "cuda"
        backend = "nccl" if on_card and torch.cuda.device_count() >= n_devices else "gloo"
    ranks = dist.spawn(slope_schedule, n_devices, backend, device, 16, DRYRUN_LOADS, "mg")
    first = ranks[0]
    for step, load in enumerate(DRYRUN_LOADS):
        norm, its, cg = first["norms"][step], first["newton"][step], first["inner"][step]
        if not math.isfinite(norm):
            raise RuntimeError(f"dryrun step {step}: residual {norm}")
        if its < 1:
            raise RuntimeError(f"dryrun step {step}: no Newton update performed")
        print(f"dryrun_multichip({n_devices}, {backend}) step {step}: load={load} "
              f"newton_its={its} cg_its={cg} residual={norm:.3e} sigma per rank "
              f"{[r['sigma_shape'] for r in ranks]} of nc_pad={first['nc_pad']}", flush=True)
    return ranks

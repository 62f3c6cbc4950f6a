"""Rank functions of ``tests/test_torch_shard.py``.

``parallel.dist.spawn`` pickles a rank function by module name and each
rank imports that module anew, so these live apart from the test module,
which imports JAX (as ``tests/conftest.py`` does): this module imports
only the port.
"""
import time

import torch.distributed as tdist

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch.parallel import dist

# every collective of torch.distributed but all_reduce: the sharded step
# may call none of them
OTHER_COLLECTIVES = ("all_gather", "all_gather_into_tensor", "all_gather_object", "all_to_all",
                     "all_to_all_single", "barrier", "broadcast", "broadcast_object_list",
                     "gather", "irecv", "isend", "recv", "reduce", "reduce_scatter",
                     "reduce_scatter_tensor", "scatter", "send")


def _step(mesh, case):
    """The case's step: the port's slope helper (plain f64 return map) or,
    with ``"statics"``, ``FusedPlasticityStep.from_statics``."""
    opts = dict(case.get("opts", {}))
    if "statics" in case:
        kernel = pt.MohrCoulombMaterial().batched_kernel("plain")
        return pt.FusedPlasticityStep.from_statics(case["statics"], kernel, device="cpu",
                                                   device_mesh=mesh, linear_solver=case["solver"],
                                                   **opts)
    return pt.mohr_coulomb_slope_step(case["N"], case["N"], route="plain", device="cpu",
                                      device_mesh=mesh, linear_solver=case["solver"], **opts)


def _run(fp, case):
    """The case's loads from the zero state: Du after each step, the
    Newton list, inner counts, norms and the last sigma."""
    step = fp.run_step_host if case.get("host") else fp.run_step
    Du, sig = fp.zero_state()
    dus, its, inner, norms = [], [], [], []
    for load in case["loads"]:
        Du, sig, norm, it, cg = step(Du, sig, float(load))
        dus.append(Du.numpy().copy())
        its.append(int(it))
        inner.append(int(cg))
        norms.append(float(norm))
    return {"du": dus, "newton": its, "inner": inner, "norms": norms, "sigma": sig.numpy(),
            "solver": fp.linear_solver, "nc_pad": fp.nc_pad, "nq": fp.nq}


def suite(mesh, cases):
    """Rank function: every case on this rank, with every collective but
    ``all_reduce`` made to raise and ``all_reduce`` counted.  Per case:
    ``_run``'s results, the calls of ``dist.psum`` and of ``all_reduce``,
    and the Newton passes (updates + steps); ``"repeat"`` runs it a second
    time on a new step, and ``"unsharded"`` runs it with
    ``device_mesh=None`` too."""
    saved = {name: getattr(tdist, name) for name in OTHER_COLLECTIVES + ("all_reduce",)}

    def refuse(*args, **kwargs):
        raise AssertionError("the sharded step called a collective other than all_reduce")

    def counted(*args, **kwargs):
        counted.calls += 1
        return saved["all_reduce"](*args, **kwargs)

    counted.calls = 0
    for name in OTHER_COLLECTIVES:
        setattr(tdist, name, refuse)
    tdist.all_reduce = counted
    out = {}
    try:
        for name, case in cases.items():
            fp = _step(mesh, case)
            dist.psum.calls = counted.calls = 0
            t0 = time.perf_counter()
            res = _run(fp, case)
            res.update(seconds=time.perf_counter() - t0, psum_calls=dist.psum.calls,
                       all_reduce_calls=counted.calls,
                       passes=sum(res["newton"]) + len(res["newton"]))
            if case.get("repeat"):
                res["again"] = _run(_step(mesh, case), case)
            if case.get("unsharded"):
                res["unsharded"] = _run(_step(None, case), case)
            out[name] = res
    finally:
        for name, fn in saved.items():
            setattr(tdist, name, fn)
    return out


#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero without the ``ok`` line:

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``dolfinx_external_operator_torch/
   csrc`` (one ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, on the
   strain/stress mix of ``tests/test_pallas_ops.py`` at the main path's
   shape and at 65,536 points, then timed with CUDA events: per call as the
   main path calls it, and as device time inside a CUDA graph;
4. the main path at full size: the von Mises fused load step on the 25x25
   P2 block (5,202 dofs, 3,750 Gauss points), loads (200, 400, 600), dense
   solver; (a) with the f64 plain return map, which must give the Newton
   list [4, 5, 7], and (b) with the f32 CUDA kernel, which must converge on
   every step, agree with (a) to 1e-3 and launch the kernel once per
   constitutive evaluation; then the layers of one Newton pass timed one by
   one, and the last load step under ``torch.profiler`` (trace in
   ``chiprun_out/trace_f32_step.json``);
5. the CG solver at 8x8 with the f64 return map: Newton list [1, 5, 7].

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  A copy of all measurements goes to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result, when
no CUDA device is present.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch._native import cuda as native
from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.ops import vonmises as vm_ops

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations of the von Mises body per point (csrc/vonmises.cuh):
# predictor 16, deviator 6, sigma_eq 9, yield and dp 6, beta/scale/n 8,
# stress 8, coef 5, tangent 16 x 5
VM_FLOPS_PER_POINT = 138

MAIN_LOADS = (200.0, 400.0, 600.0)
F32_TOLS = {"newton_rtol": 1e-5, "newton_atol": 1e-3}
KERNEL_TOL = {"C": 1e-5, "sig": 1e-5, "dp_abs": 1e-7}
OUT_DIR = "chiprun_out"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(), f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def build_kernels():
    """Build every kernel source concurrently; returns the wall seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(native.KERNELS)) as ex:
        futures = {name: ex.submit(native.cuda_function, name) for name in native.KERNELS}
        for fut in futures.values():
            fut.result()
    return time.perf_counter() - t0


def vm_inputs(n, seed=3):
    """The strain/stress mix of tests/test_pallas_ops.py:25-30."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=2e-3, size=(n, 4))
    deps[: n // 2, 3] += 6e-3  # plastic half
    sig_n = rng.normal(scale=20.0, size=(n, 4))
    p = np.abs(rng.normal(scale=1e-3, size=n))
    dev = torch.device("cuda")
    return (torch.tensor(deps.T.copy(), dtype=torch.float32, device=dev),
            torch.tensor(sig_n.T.copy(), dtype=torch.float32, device=dev),
            torch.tensor(p, dtype=torch.float32, device=dev))


def cuda_time_ms(fn, reps):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, reps):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed between events, so that the host's per-call cost drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(n):
    """The CUDA kernel against the plain version on the same CUDA tensors."""
    args = vm_inputs(n) + (vm.PARAMS,)
    C_k, s_k, dp_k = vm_ops.vonmises_return_map(*args)
    C_r, s_r, dp_r = vm_ops.vonmises_return_map_reference(*args)
    torch.cuda.synchronize()
    for name, t in (("C", C_k), ("sig", s_k), ("dp", dp_k)):
        check(bool(torch.isfinite(t).all()), f"kernel {name} not finite at n={n}")
    err_C = float((C_k - C_r).abs().max() / C_r.abs().max())
    err_s = float((s_k - s_r).abs().max() / max(float(s_r.abs().max()), 1.0))
    err_dp = float((dp_k - dp_r).abs().max())
    abs_err = max(float((C_k - C_r).abs().max()), float((s_k - s_r).abs().max()), err_dp)
    check(err_C < KERNEL_TOL["C"], f"kernel C differs from plain by {err_C:.3e} (n={n})")
    check(err_s < KERNEL_TOL["sig"], f"kernel sigma differs from plain by {err_s:.3e} (n={n})")
    check(err_dp < KERNEL_TOL["dp_abs"], f"kernel dp differs from plain by {err_dp:.3e} (n={n})")
    call_ms = cuda_time_ms(lambda: vm_ops.vonmises_return_map(*args), 500)
    ms = graph_time_ms(lambda: vm_ops.vonmises_return_map(*args), 200)
    plain_ms = cuda_time_ms(lambda: vm_ops.vonmises_return_map_reference(*args), 100)
    bytes_moved = vm_ops.BYTES_PER_POINT * n
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = VM_FLOPS_PER_POINT * n / F32_FLOPS_PER_S * 1e3
    return {"n": n, "max_rel_err": max(err_C, err_s), "max_abs_err": abs_err,
            "rel_err_C": err_C, "rel_err_sig": err_s, "abs_err_dp": err_dp,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def warm_up(fp, load):
    """One step from the zero state: first-call allocations and library
    handles, kept out of the timed schedule."""
    Du, sig = fp.zero_state()
    fp.run_step(Du, sig, load)
    torch.cuda.synchronize()


def run_loads(fp, loads):
    """The schedule from the zero state, Du carried from step to step;
    wall time per step after a sync."""
    Du, sig = fp.zero_state()
    its, cgs, walls = [], [], []
    for load in loads:
        t0 = time.perf_counter()
        Du, sig, norm, it, cg = fp.run_step(Du, sig, load)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(np.isfinite(norm), f"non-finite residual at load {load}")
        its.append(it)
        cgs.append(cg)
    check(tuple(Du.shape) == (fp.n_dofs,) and bool(torch.isfinite(Du).all()), "bad Du")
    check(bool(torch.isfinite(sig).all()), "bad sigma")
    return Du, its, cgs, walls


def state_before(fp, loads):
    """The state after the load steps ``loads`` from the zero state."""
    Du, sig = fp.zero_state()
    for load in loads:
        Du, sig, *_ = fp.run_step(Du, sig, load)
    torch.cuda.synchronize()
    return Du, sig


def host_time_ms(fn, reps=5):
    """Host clock around ``reps`` calls that end in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def layer_phase(fp, Du, sig_n, load):
    """One Newton pass of the step, layer by layer, at the iterate
    ``(Du, sig_n)``: the milliseconds of each layer."""
    fvec = fp._assemble_f()
    C_tang, sigma = fp._constitutive(Du, sig_n)
    r = fp._residual(sigma, load, fvec)
    return {
        "constitutive_ms": host_time_ms(lambda: fp._constitutive(Du, sig_n)),
        "residual_ms": host_time_ms(lambda: fp._residual(sigma, load, fvec)),
        "tangent_matvec_ms": host_time_ms(lambda: fp._bc_matvec(C_tang, Du)),
        "dense_solve_ms": host_time_ms(lambda: fp._dense_solve(C_tang, -r)),
    }


def profile_step(fp, Du, sig_n, load, path):
    """One load step under torch.profiler: wall time, the card's busy time
    (kernels, copies and fills in the trace) and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fp.run_step(Du, sig_n, load)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in dev:
        by_name[e["name"][:100]] = by_name.get(e["name"][:100], 0.0) + e["dur"] * 1e-3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall * 1e3) if dev else None,
            "device_events": len(dev), "top_ms": top}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    report = {}
    card = card_line()
    print(card, flush=True)
    report["card"] = card

    build_s = build_kernels()
    print(f"kernel build: {build_s:.1f} s ({', '.join(native.KERNELS)})", flush=True)
    report["build_s"] = build_s

    n_main = 3750 + (-3750 % 512)  # the main path's 3,750 points padded to the tile
    shapes = [kernel_phase(n) for n in (3750, n_main, 65536)]
    for s in shapes:
        print(f"vonmises n={s['n']}: rel err {s['max_rel_err']:.2e}, dp err "
              f"{s['abs_err_dp']:.2e}, kernel {s['ms'] * 1e3:.2f} us in a graph, "
              f"{s['call_ms'] * 1e3:.2f} us a call, plain "
              f"{s['plain_ms'] * 1e3:.2f} us, bound {s['bound_ms'] * 1e3:.3f} us", flush=True)
    report["vonmises_shapes"] = shapes

    # phase 4: the main path; counts start at 0 here and are read after it
    fp64 = pt.von_mises_block_step(25, 25, "f64", linear_solver="dense")
    fp32 = pt.von_mises_block_step(25, 25, "f32", linear_solver="dense", **F32_TOLS)
    check((fp64.n_dofs, fp64.nc * fp64.nq) == (5202, 3750), "wrong block size")
    warm_up(fp64, MAIN_LOADS[0])
    warm_up(fp32, MAIN_LOADS[0])
    vm_ops.vonmises_return_map.launches = 0
    Du64, its64, _, wall64 = run_loads(fp64, MAIN_LOADS)
    check(vm_ops.vonmises_return_map.launches == 0, "f64 path launched the f32 kernel")
    Du32, its32, _, wall32 = run_loads(fp32, MAIN_LOADS)
    launches = vm_ops.vonmises_return_map.launches
    print(f"25x25 dense f64: newton {its64}, s/step {[round(w, 4) for w in wall64]}", flush=True)
    print(f"25x25 dense f32 kernel: newton {its32}, s/step {[round(w, 4) for w in wall32]}, "
          f"launches {launches}", flush=True)
    check(its64 == [4, 5, 7], f"f64 Newton list {its64} != [4, 5, 7]")
    check(all(i < fp32.newton_max_it for i in its32), f"f32 path hit newton_max_it: {its32}")
    du_err = float((Du32 - Du64).abs().max() / Du64.abs().max())
    check(du_err < 1e-3, f"f32 Du differs from f64 by {du_err:.3e}")
    # one constitutive evaluation per Newton pass, and each step ends on a
    # converged pass
    check(launches == sum(its32) + len(its32), f"{launches} launches for Newton {its32}")
    report["main"] = {"newton_f64": its64, "newton_f32": its32, "wall_f64_s": wall64,
                      "wall_f32_s": wall32, "du_rel_err_f32": du_err, "launches": launches}

    # where a step's time goes: the layers of one Newton pass at the first
    # iterate of the last load, and that load step under the profiler
    layers = {}
    for name, fp in (("f64", fp64), ("f32", fp32)):
        Du, sig = state_before(fp, MAIN_LOADS[:-1])
        layers[name] = layer_phase(fp, Du, sig, MAIN_LOADS[-1])
        print(f"25x25 layers {name} (ms): "
              + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in layers[name].items()), flush=True)
    report["layers"] = layers
    os.makedirs(OUT_DIR, exist_ok=True)
    prof = profile_step(fp32, Du, sig, MAIN_LOADS[-1],
                        os.path.join(OUT_DIR, "trace_f32_step.json"))
    print(f"25x25 f32 load {MAIN_LOADS[-1]:.0f} under the profiler: wall "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms, "
          f"{prof['device_events']} device events", flush=True)
    for name, t in prof["top_ms"][:6]:
        print(f"  {t:9.3f} ms  {name}", flush=True)
    report["profile_f32_step"] = prof

    # phase 5: CG at 8x8
    fpcg = pt.von_mises_block_step(8, 8, "f64", linear_solver="cg")
    warm_up(fpcg, MAIN_LOADS[0])
    _, itscg, cgs, wallcg = run_loads(fpcg, MAIN_LOADS)
    print(f"8x8 cg f64: newton {itscg}, cg {cgs}, s/step {[round(w, 4) for w in wallcg]}",
          flush=True)
    check(itscg == [1, 5, 7], f"cg Newton list {itscg} != [1, 5, 7]")
    report["cg_8x8"] = {"newton": itscg, "cg": cgs, "wall_s": wallcg}

    main_shape = shapes[1]
    kernels = [{
        "name": "vonmises_return_map",
        "route": "cuda",
        "source": "dolfinx_external_operator_torch/csrc/vonmises.cu",
        "replaces": "dolfinx_external_operator_tpu/ops/vonmises_pallas.py:97",
        "launches": launches,
        "max_abs_err": main_shape["max_abs_err"],
        "max_rel_err": max(s["max_rel_err"] for s in shapes),
        "ms": main_shape["ms"],
        "kernel_ms": main_shape["ms"],
        "call_ms": main_shape["call_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "n": main_shape["n"],
    }]
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        code = 1
    sys.exit(code)

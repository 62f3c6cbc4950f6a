#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero without the ``ok`` line:

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``dolfinx_external_operator_torch/
   csrc`` (one ``nvcc`` per source, all started together) and print each
   kernel function's registers and spills;
3. each kernel against its plain PyTorch version on the card, on the
   strain/stress mix of ``tests/test_pallas_ops.py`` at the main path's
   shape and at 65,536 points, then timed with CUDA events: per call as the
   main path calls it, and as device time inside a CUDA graph; beside it,
   an empty kernel's time in a CUDA graph, the floor under any launch;
4. the von Mises path at full size: the fused load step on the 25x25 P2
   block (5,202 dofs, 3,750 Gauss points), loads (200, 400, 600), dense
   solver; (a) with the f64 plain return map, which must give the Newton
   list [4, 5, 7], and (b) with the f32 CUDA kernel, which must converge on
   every step, agree with (a) to 1e-3 and launch the kernel once per
   constitutive evaluation; then the layers of one Newton pass timed one by
   one, and the last load step under ``torch.profiler`` (trace in
   ``trace_f32_step.json.gz``);
5. the CG solver at 8x8 with the f64 return map: Newton list [1, 5, 7];
6. the main path: the Mohr-Coulomb slope load step on the same 25x25 block
   over the 52-step schedule, dense solver, from the zero state, (a) with
   the hand-written return-map kernel and (b) with the plain f64 return
   map.  Both Newton lists must equal the record's
   (``docs/records/scaling_25x25_full_tpu_bcr_schedule.json``, 171
   updates), the two final Du must agree to 1e-8, and the kernel must be
   launched once per Newton pass (updates + 52);
7. the Mohr-Coulomb kernel against its plain version on the card, on the
   strain mix of ``bench.py:77-83`` at 65,536 points and on the real
   iterate of step 50's first Newton pass, then timed as in phase 3, and
   each of its two passes' device time from the profiler's trace of 20
   calls (``trace_mc_passes_*.json.gz``); the lanes that pass A
   listed, and how far the iteration counts of the 4 points that a warp of
   pass B takes at once spread;
8. where a main-path step's time goes: the layers of step 50's first
   Newton pass, and step 51 (7 updates) under ``torch.profiler`` (trace in
   ``trace_mc_step.json.gz``);
9. the same slope with the block-cyclic-reduction (BCR) solver and the
   kernel over the 52 steps: the record's Newton list (171 updates, 223
   kernel calls); its refinement rounds beside the record's 335, and one
   update's BCR solve beside the dense path's at step 50's first iterate
   (CUDA events, in turns);
10. the 100x100 slope (80,802 dofs, 60,000 Gauss points) with
   ``linear_solver="auto"``, which picks BCR, and the kernel over the first
   49 loads (the record stops before the collapse at load 22.9): the
   Newton list of ``docs/records/scaling_100x100_full_tpu_bcr.json`` (239
   updates, 288 kernel calls), rounds beside the record's 369, peak
   memory, the levels that fell back to the LU inverse; the layers of step
   48's first Newton pass (factor and apply beside their bounds), step 48
   under the profiler (``trace_bcr_100x100_step.json.gz``), and
   the kernel against its plain version at that iterate;
11. ``entry()``'s program: the 25x25 slope with ``linear_solver="mg"``
   (AMG-CG, the banded lattice layout) and the kernel over the 52 steps:
   the record's Newton list (171 updates, 223 kernel calls), inner
   iterations per update, the levels, peak memory; where step 50's update
   goes (``mg_setup``, one cycle, the f32 level-0 matvec beside its bound,
   the f64 refinement matvec; cycle and matvec also from a CUDA graph);
   one update's solve beside the dense path's (CUDA events, in turns); step
   51 under the profiler (``trace_mg_step.json.gz``); the first 10
   steps run again, Du bitwise equal;
12. the same slope with ``linear_solver="elastic"`` (the lagged f32
   inverse as the preconditioner): 171 updates, 223 kernel calls, inner
   iterations, s/step;
13. the 100x100 slope with AMG-CG through ``run_step_host(forcing=False)``,
   the protocol of ``docs/records/scaling_100x100_full_tpu.json``, over its
   first ``MG_100_STEPS`` loads: that record's Newton counts, the host
   build's time, inner iterations per update beside the record's, peak
   memory, one solve beside a BCR solve of the same system (in turns), and
   the layers of that update;
14. cell sharding, world size 1 over NCCL (``parallel.dist.spawn``, one
   process): the first 10 steps of phase 11's program through the sharded
   code, bitwise equal to phase 11 in Du, sigma, the Newton list and the
   inner counts (one rank's all-reduce is the identity);
15. two ranks on the one card over gloo with CUDA tensors (NCCL refuses two
   ranks on one GPU; gloo stages each all-reduce through the host, so these
   times check parity, not multi-GPU speed): phase 11's program over the
   52 steps, the record's Newton list and a K1 launch
   per Newton pass on each rank, every rank's residual norms bitwise equal,
   Du within 1e-9 of phase 11's, inner counts within max(10, 0.4 n1) per
   step; s/step, all-reduces per Newton pass, and the time of one
   all-reduce of a dof vector and of the level-0 band values;
16. ``dryrun_multichip(2)`` on the card over gloo: Newton counts 1 and 2
   (``MULTICHIP_r05.json``), inner counts beside that record's;
17. with two cards or more, phases 15 and 16 over NCCL, one rank per card
   (up to 4); with one card it says that multi-card NCCL was not run;
18. the general external-operator pipeline: the 25x25 slope through
   ``models.mohr_coulomb.solve_slope_stability`` (the stress a
   ``FEMExternalOperator`` whose callback launches K1; dense assembly, f32
   LU with 4 f64 refinement rounds, Newton) over the 52 steps: the
   record's Newton list, one K1 launch per residual plus the initial
   update (224 without backtracking), ``u`` within 1e-8 of phase 6's fused
   step; s/step beside phase 6's, peak memory, the layers of step 50's
   first pass (operands, the K1 callback, the vector and the dense matrix
   assembly, the LU factorization, 4 refinement rounds), step 51 under
   the profiler (``trace_general_step.json.gz``);
19. the von Mises cylinder through the general pipeline at the records'
   size (``models.von_mises.solve_von_mises``, lc=0.3, 20 increments, the
   f64 return map as the operator's callback): direct, with cg + mg, and
   the pure-form twin; the Newton lists beside
   ``docs/records/von_mises_20steps_general_mg.json``'s (equal on the
   linear steps, within one update on the plastic ones, where the first
   tangent is decided by rounding), the probe of mg and of the twin within
   1e-10 of direct, the wall time of each;
20. the cylinder at lc=0.02 (11,222 dofs, 8,100 Gauss points): 20
   increments direct (a 1.0 GB f64 matrix) and with cg + mg, 5 with
   gmres + mg; both lists side by side with mg's inner iterations, s/step,
   peak memory, one update's time split into the callback, the residual,
   the Jacobian and the linear solve, the dense solve's residual by
   refinement rounds; mg takes one update on each linear step and at most
   one more than direct on any step, the final probes within 1e-8, gmres +
   mg mg's list and within 1e-8 of direct;
21. ICNN hyperelasticity at the record's size (``models.hyperelasticity.
   run_comparison``, lc=0.05, 2,926 dofs, 100 steps to 0.5): Newton totals
   200 and 200 and ``rel_linf``/``l2`` within 1e-6 relative of
   ``hyperelasticity_lc005_100steps.json``, s/step of each model, the ICNN
   callback at 2,004 points as the path calls it (replayed from a CUDA
   graph), its graph's device time and the eager call; then the bounded
   Newton (``vinewtonrsls``): the 12x12 membrane on a floor (dense) and the
   elastic block on a floor (cg + mg), each with the JAX package's Newton
   count and the KKT conditions;
22. phase 18's program with the general pipeline cell-sharded
   (``entry.general_slope_schedule``: ``parallel.set_default_device_mesh``,
   every form and expression on the rank's cells, K1 on the rank's Gauss
   points) over one NCCL rank: phase 18's Newton list, K1 launches and u,
   bit for bit;
23. the same over two gloo ranks on the card: each rank's K1 on its 1,875
   points, phase 18's Newton list, u within 1e-10 relative of phase 18's
   and the same on both ranks; s/step, the all-gathers and psums per
   Newton pass with each one's time (host clock, after the run), peak
   memory; then K1 against its plain version and timed on a rank's half
   of step 50's iterate;
24. the port's five demos (``demos_torch/``, each in a process of its
   own, all started together, ``--no-plot``): the simple example, nonlinear heat, von Mises
   ``--small`` on one process and on ``--ranks 2`` (gloo; the final
   displacements within 1e-12 relative), Mohr-Coulomb ``--small`` and
   hyperelasticity ``--small``; each holds its own asserts.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
is ``{"ok": true, "device": {...}}``.  A copy of all measurements goes to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result, when
no CUDA device is present.  The profiler traces (``trace_*.json.gz``) go
beside the measurements.  Before it exits, it stops every process it
started that is still alive (``stop_children``).
"""

import gc
import gzip
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import dolfinx_external_operator_torch as pt
from dolfinx_external_operator_torch._native import cuda as native
from dolfinx_external_operator_torch.models import von_mises as vm
from dolfinx_external_operator_torch.ops import mohr_coulomb as mc_ops
from dolfinx_external_operator_torch.ops import vonmises as vm_ops
from dolfinx_external_operator_torch.entry import (
    dryrun_multichip,
    general_slope_schedule,
    slope_schedule,
)
from dolfinx_external_operator_torch.parallel import bcr, dist, mg

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, f32 and f64
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F64_FLOPS_PER_S = 34e12
# f32 operations of the von Mises body per point (csrc/vonmises.cuh):
# predictor 16, deviator 6, sigma_eq 9, yield and dp 6, beta/scale/n 8,
# stress 8, coef 5, tangent 16 x 5
VM_FLOPS_PER_POINT = 138
# Operations of the Mohr-Coulomb algorithm (csrc/mohr_coulomb.cuh), counted
# by hand on one point's work done once (what a tile of the kernel repeats
# on several threads, the 5x5 solve and the Dual values, is not counted),
# one per add, multiply, divide, square root or trig call: terms()
# 131 (value and gradient); on Dual numbers 5x that (a value and four
# tangents); residual = terms + 44; Jacobian = Dual terms + 170 (C Hg,
# C grad g); 5x5 solve 125 with one right-hand side, 260 with four.  A
# Newton iteration with 6 candidates: 825 + 125 + 5 + 6 x 195 = 2,125.  Per
# point, besides its iterations: 190 f32 (start of the f32 phase) and
# 1,590 f64 (trial yield 194, start of the polish 206, tangent 1,190).
# Every iteration is counted at the f32 cost and rate, so the bound is a
# lower bound (a polish iteration costs more, at half the rate).
MC_ITER_OPS = 2125
MC_FIXED_F32_OPS = 190
MC_FIXED_F64_OPS = 1590
# kernel vs plain on the card: the f64 polish stops once |r| <= 1e-8 of the
# lane's scale, so a lane whose last step lands on the other side of that
# threshold in the two versions (different f32 trig and FMA contraction)
# differs by up to about 1e-8 in sigma, more in the tangent; a few lanes
# in a thousand may then differ in their iteration count
MC_TOL = {"C": 1e-6, "sig": 1e-7}
RECORDS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "records")
RECORD = os.path.join(RECORDS, "scaling_25x25_full_tpu_bcr_schedule.json")
# the JAX package's general path (models/mohr_coulomb.py::
# solve_slope_stability) at 25x25 over SLOPE_LOADS on the CPU, the list
# tests/test_torch_general_slope.py pins: the record's but for step 51 (6
# updates, not 7), 170 in all
GENERAL_25X25 = [1, 2, 2, 3, 3, 2, 3, 3, 3, 3, 3, 3, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
                 4, 4, 3, 3, 3, 3, 3, 3, 4, 3, 3, 3, 3, 3, 4, 4, 3, 4, 4, 4, 4, 4, 4, 6, 6, 4]
RECORD_100 = os.path.join(RECORDS, "scaling_100x100_full_tpu_bcr.json")
RECORD_100_MG = os.path.join(RECORDS, "scaling_100x100_full_tpu.json")
# load steps of the 100x100 AMG-CG phase: all of the record's (the next
# load is the collapse, where Newton fails)
MG_100_STEPS = 49
# the 25x25 AMG-CG schedule's inner iterations: the JAX package's on the
# CPU; the port's (11,986 on the CPU, 10,815 on the card) are held
# within MG_INNER_TOL of it
MG_25_INNER_JAX = 11545
MG_INNER_TOL = 0.15
# the dryrun's inner counts in MULTICHIP_r05.json (the JAX package on 8
# virtual devices); the port's are held within max(10, 0.4 n) of them per
# step, the rule of tests/test_multichip_scaling.py:74 (on the CPU: [27,
# 49], [28, 48] and [26, 47] on 1, 2 and 3 ranks)
DRYRUN_RECORD_INNER = (25, 46)

MAIN_LOADS = (200.0, 400.0, 600.0)
F32_TOLS = {"newton_rtol": 1e-5, "newton_atol": 1e-3}
KERNEL_TOL = {"C": 1e-5, "sig": 1e-5, "dp_abs": 1e-7}
OUT_DIR = "chiprun_out"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def descendants(pid):
    """The ids of the live processes below ``pid`` (children, theirs, ...),
    read from ``/proc``."""
    parent = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the fields after the command name, which may hold spaces
        parent[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out += kids
        todo += kids
    return out


def command_line(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()[:200]
    except OSError:
        return "?"


def stop_children():
    """End every process this run started that is still alive, so that
    none outlives the script.  The ranks' ``spawn`` start method launched
    multiprocessing's resource tracker, which otherwise ends only after the
    script has exited; it is stopped and waited for.  Any other process
    left below this one is named on stderr, sent SIGTERM, and SIGKILL
    after 5 s."""
    from multiprocessing import resource_tracker

    gc.collect()
    tracker = resource_tracker._resource_tracker
    if hasattr(tracker, "_stop"):
        tracker._stop()
    left = descendants(os.getpid())
    for pid in left:
        print(f"chip_smoke: stopping process {pid} left running: {command_line(pid)}",
              file=sys.stderr, flush=True)
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 5.0
        while left and time.monotonic() < deadline:
            for pid in list(left):
                try:
                    done = os.waitpid(pid, os.WNOHANG)[0] == pid
                except ChildProcessError:
                    # not a child of this process: gone once /proc lacks it
                    done = not os.path.exists(f"/proc/{pid}")
                if done:
                    left.remove(pid)
            time.sleep(0.05)


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


def kernel_name(mangled):
    """The last name of an Itanium-mangled kernel symbol (``_ZN...E``)."""
    rest, names = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], []
    while (m := re.match(r"\d+", rest)):
        k = int(m.group())
        names.append(rest[m.end():m.end() + k])
        rest = rest[m.end() + k:]
    return names[-1] if names else mangled


def ptxas_usage(log):
    """Per kernel function of an ``nvcc -Xptxas -v`` log: registers,
    spill stores and loads and stack frame, in bytes."""
    usage, name = {}, None
    for line in log.splitlines():
        if (m := re.search(r"Compiling entry function '([^']+)'", line)):
            name = kernel_name(m.group(1))
            usage[name] = {}
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def empty_graph_ms(reps=200):
    """An empty kernel's time inside a CUDA graph: the launch floor."""
    fn = native.cuda_function("empty")

    def run():
        check(fn(torch.cuda.current_stream().cuda_stream) == 0, "empty kernel launch failed")

    return graph_time_ms(run, reps)


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


def cuda_time_ms(fn, reps, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_time_ms(fn, reps):
    """Host time per call, from the first call's start to the card's end
    of the last: for work that is mostly the host's (a graph's capture)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


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


def run_loads(fp, loads, capture=()):
    """The schedule from the zero state, Du carried from step to step;
    wall time per step after a sync.  ``capture``: indices of the steps
    whose starting state (Du, sigma_n) is returned in a dict, which also
    holds the total displacement (the sum of the steps' Du) under "u"."""
    Du, sig = fp.zero_state()
    its, cgs, walls, states = [], [], [], {}
    u = torch.zeros_like(Du)
    for k, load in enumerate(loads):
        if k in capture:
            states[k] = (Du.clone(), sig.clone())
        t0 = time.perf_counter()
        Du, sig, norm, it, cg = fp.run_step(Du, sig, load)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        u = u + Du
        check(np.isfinite(norm), f"non-finite residual at load {load}")
        its.append(it)
        cgs.append(cg)
    check(tuple(Du.shape) == (fp.n_dofs,) and bool(torch.isfinite(Du).all()), "bad Du")
    check(bool(torch.isfinite(sig).all()), "bad sigma")
    states["u"] = u
    return Du, its, cgs, walls, states


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


def traced(fn, path):
    """Run ``fn`` under torch.profiler and write its trace, gzipped, to
    ``path`` + ``.gz``: the wall seconds, the milliseconds of the card's
    events (kernels, copies and fills) by name, their count, and the count
    of the host's launch calls (kernels, graphs, copies and fills)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(path)
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host_launches = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and re.search("Launch|Memcpy|Memset", e.get("name", "")))
    by_name = {}
    for e in dev:
        by_name[e["name"][:100]] = by_name.get(e["name"][:100], 0.0) + e["dur"] * 1e-3
    return wall, by_name, len(dev), host_launches


def profile_step(fp, Du, sig_n, load, path):
    """One load step under torch.profiler: wall time, the card's busy time
    and the kernels that take it."""
    wall, by_name, events, launches = traced(lambda: fp.run_step(Du, sig_n, load), path)
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / (wall * 1e3) if events else None,
            "device_events": events, "host_launches": launches, "top_ms": top}


def pass_times_ms(fn, path, reps=20):
    """Device milliseconds per call of the Mohr-Coulomb kernel's two passes
    (by kernel name) in the profiler's trace of ``reps`` calls of ``fn``."""
    fn()
    _, by_name, _, _ = traced(lambda: [fn() for _ in range(reps)], path)
    times = [sum(ms for name, ms in by_name.items() if kernel in name) / reps
             for kernel in ("mc_trial_pass", "mc_plastic_pass")]
    check(all(t > 0.0 for t in times), f"no pass of the kernel in the trace: {sorted(by_name)}")
    return times


def mc_bound(niter):
    """(bound_ms, bound_by) of the Mohr-Coulomb kernel on inputs whose
    lanes take ``niter`` Newton iterations: bytes read and written once
    over HBM, or the operations these lanes need over the f32 and f64
    peaks, whichever is larger."""
    n = niter.numel()
    t_bytes = mc_ops.BYTES_PER_POINT * n / HBM_BYTES_PER_S * 1e3
    f32_ops = MC_FIXED_F32_OPS * n + MC_ITER_OPS * int(niter.sum())
    t_ops = (f32_ops / F32_FLOPS_PER_S + MC_FIXED_F64_OPS * n / F64_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tile_spread(it_k, work, listed):
    """How the listed lanes' iteration counts spread over the groups of 4
    list entries that one warp of pass B takes at once: the histogram of
    niter, and the share of the warps' lockstep iterations that do work."""
    lst = work[mc_ops.LIST_OFFSET:mc_ops.LIST_OFFSET + listed].long()
    it = it_k[lst].long()
    groups = torch.nn.functional.pad(it, (0, -listed % 4)).view(-1, 4)
    lockstep = int(groups.amax(1).sum()) * 4
    return {"niter_hist": torch.bincount(it).tolist() if listed else [],
            "warp_groups": groups.shape[0],
            "lockstep_share": int(it.sum()) / lockstep if lockstep else None}


def mc_kernel_phase(mat, deps, sn, label):
    """The Mohr-Coulomb kernel against the plain version on the same CUDA
    tensors (per-lane gaps relative to the largest entry), then timed,
    whole and pass by pass."""
    n = deps.shape[1]
    first = mc_ops.mc_return_map(deps, sn, mat)
    C_k, s_k, it_k, y_k, *_ = first
    C_p, (s_p, it_p, y_p, *_) = mat.tangent_stress(deps, sn)
    C_p = C_p.reshape(16, n)
    torch.cuda.synchronize()
    for name, t in (("C", C_k), ("sig", s_k)):
        check(bool(torch.isfinite(t).all()), f"mohr_coulomb kernel {name} not finite ({label})")
    gap_C = (C_k - C_p).abs().amax(0) / C_p.abs().max()
    gap_s = (s_k - s_p).abs().amax(0) / s_p.abs().max()
    niter_diff = int((it_k != it_p).sum())
    abs_err = max(float((C_k - C_p).abs().max()), float((s_k - s_p).abs().max()))
    err_C, err_s = float(gap_C.max()), float(gap_s.max())
    check(err_C < MC_TOL["C"], f"mohr_coulomb kernel C differs from plain by {err_C:.3e} ({label})")
    check(err_s < MC_TOL["sig"],
          f"mohr_coulomb kernel sigma differs from plain by {err_s:.3e} ({label})")
    check(niter_diff <= n // 1000, f"{niter_diff} lanes differ in niter ({label})")
    check(float((y_k - y_p).abs().max()) < 1e-12, f"mohr_coulomb yielding differs ({label})")
    # pass A's list: the plastic lanes and the elastic ones that take a
    # Newton step
    outs, work = mc_ops._outputs(n, deps.device), mc_ops._workspace(n, deps.device)
    mc_ops._launch(deps, sn, mat, outs, work)
    torch.cuda.synchronize()
    listed, plastic = int(work[0]), int((y_k > 0).sum())
    check(listed == int(((y_k > 0) | (it_k > 0)).sum()),
          f"pass A listed {listed} lanes, {plastic} plastic ({label})")
    check(all(torch.equal(a, b) for a, b in zip(outs, first)),
          f"mohr_coulomb kernel not bitwise repeatable ({label})")
    call_ms = cuda_time_ms(lambda: mc_ops.mc_return_map(deps, sn, mat), 50, warmup=3)
    ms = graph_time_ms(lambda: mc_ops.mc_return_map(deps, sn, mat), 20)
    pass_a_ms, pass_b_ms = pass_times_ms(
        lambda: mc_ops.mc_return_map(deps, sn, mat),
        os.path.join(OUT_DIR, f"trace_mc_passes_{label.replace(' ', '_')}.json"))
    plain_ms = cuda_time_ms(lambda: mat.tangent_stress(deps, sn), 2, warmup=1)
    bound_ms, bound_by = mc_bound(it_k)
    res = {"label": label, "n": n, "rel_err_C": err_C, "rel_err_sig": err_s,
           "lanes_C_above_1e-10": int((gap_C > 1e-10).sum()),
           "lanes_sig_above_1e-10": int((gap_s > 1e-10).sum()),
           "niter_diff_lanes": niter_diff, "niter_max": int(it_k.max()),
           "niter_sum": int(it_k.sum()), "iterating_lanes": int((it_k > 0).sum()),
           "plastic_lanes": plastic, "listed_lanes": listed,
           **tile_spread(it_k, work, listed),
           "max_abs_err": abs_err, "ms": ms, "call_ms": call_ms, "pass_a_ms": pass_a_ms,
           "pass_b_ms": pass_b_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    return res


def bench_mix(n, seed=0):
    """bench.py:77-83: compressive normal strains, half the points sheared
    past yield, zero initial stress; SoA f64 on the card."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=1e-3, size=(n, 4))
    deps[:, :3] -= 1.5e-3
    deps[: n // 2, 3] += 6e-3
    d = torch.tensor(deps.T.copy(), dtype=torch.float64, device="cuda")
    return d, torch.zeros_like(d)


def kernel_inputs(fp, Du, sig_n):
    """The (deps, sigma_n) that the step's constitutive map receives at the
    iterate (Du, sig_n), recorded from one call."""
    seen = []
    inner = fp._vkernel

    def record(deps, sn):
        seen.append((deps.contiguous(), sn.contiguous()))
        return inner(deps, sn)

    fp._vkernel = record
    try:
        fp._constitutive(Du, sig_n)
    finally:
        fp._vkernel = inner
    return seen[0]


def newton_rhs(fp, Du, sig_n, load):
    """C_tang and the Newton right-hand side -r at the iterate (Du, sig_n)."""
    C_tang, sigma = fp._constitutive(Du, sig_n)
    st = fp.statics
    r = torch.where(st["bc_mask"], Du - st["bc_vals"],
                    fp._residual(sigma, load, fp._assemble_f()))
    return C_tang, -r


def first_solve_residuals(fp, load, rounds=(0, 1, 2)):
    """Step 1 of the schedule is linear: the residual left by the dense
    path's first update, relative to the load vector, after each number of
    f64 refinement rounds."""
    C_tang, b = newton_rhs(fp, *fp.zero_state(), load)
    keep, out = fp._dense_refine, {}
    try:
        for k in rounds:
            fp._dense_refine = k
            x, _ = fp._dense_solve(C_tang, b)
            out[k] = float((b - fp._bc_matvec(C_tang, x)).norm() / b.norm())
    finally:
        fp._dense_refine = keep
    return {"load_norm": float(b.norm()), "rel_residual_by_rounds": out}


def mc_main_path(report):
    """Phase 6: the Mohr-Coulomb slope over the 52-step schedule with the
    kernel and with the plain map.  Returns the kernel step, its states
    before steps 50 and 51, and the kernel's launches on the main path."""
    with open(RECORD) as f:
        record = json.load(f)["newton_per_step"]
    loads = pt.SLOPE_LOADS
    fp_k = pt.mohr_coulomb_slope_step(25, 25, route="cuda")
    fp_p = pt.mohr_coulomb_slope_step(25, 25, route="plain")
    check((fp_k.n_dofs, fp_k.nc * fp_k.nq, fp_k.linear_solver) == (5202, 3750, "dense"),
          "wrong slope size or solver")
    first = first_solve_residuals(fp_k, float(loads[0]))
    print(f"25x25 slope step 1, dense solve: |b| {first['load_norm']:.4e}, residual / |b| by "
          f"refinement rounds {first['rel_residual_by_rounds']} (Newton atol 1e-8)", flush=True)
    report["mc_first_solve"] = first
    warm_up(fp_k, loads[0])
    warm_up(fp_p, loads[0])
    # the main path: the kernel's count starts at 0 here and is read after it
    mc_ops.mc_return_map.launches = 0
    Du_k, its_k, _, wall_k, states = run_loads(fp_k, loads, capture=(49, 50))
    launches = mc_ops.mc_return_map.launches
    print(f"25x25 slope, kernel: newton {its_k} ({sum(its_k)}), launches {launches}, "
          f"{sum(wall_k):.2f} s, s/step {[round(w, 4) for w in wall_k]}", flush=True)
    Du_p, its_p, _, wall_p, _ = run_loads(fp_p, loads)
    check(mc_ops.mc_return_map.launches == launches, "the plain path launched the kernel")
    print(f"25x25 slope, plain: newton {its_p} ({sum(its_p)}), {sum(wall_p):.2f} s, "
          f"s/step {[round(w, 4) for w in wall_p]}", flush=True)
    check(its_k == record, f"kernel Newton list {its_k} != record {record}")
    check(its_p == record, f"plain Newton list {its_p} != record {record}")
    check(launches == sum(its_k) + len(loads), f"{launches} launches for Newton {its_k}")
    du_err = float((Du_k - Du_p).abs().max() / Du_p.abs().max())
    check(du_err < 1e-8, f"kernel Du differs from plain by {du_err:.3e}")
    report["mc_main"] = {"newton_kernel": its_k, "newton_plain": its_p, "launches": launches,
                         "wall_kernel_s": wall_k, "wall_plain_s": wall_p,
                         "du_rel_err": du_err}
    return fp_k, states, launches


def bcr_counts(m, B):
    """Operations, bytes and blocks of one BCR factorization and one apply
    as the port runs them (parallel/bcr.py).  Per level of ``no`` odd and
    ``ne`` even blocks: each odd block a Cholesky (B^3/3), the inverse
    from it (2B^3/3), V L and V U (2B^3 each); each even block six (B, B)
    products (A, C, the two of the D update, the new L and U); the root's
    inversion.  The factorization reads the bands once (3mB^2) and writes
    A and C (ne each), V, VL and VU (no each) and the root once; the apply
    reads each of those once and does one (B, B) matvec with each."""
    bands, ops, blocks = 3 * m, 0, 0
    while m > 1:
        no, ne = m // 2, m - m // 2
        ops += (5 * no + 12 * ne) * B ** 3
        blocks += 2 * ne + 3 * no
        m = ne
    ops += B ** 3
    blocks += 1
    return {"factor_ops": ops, "factor_bytes": 4 * B * B * (bands + blocks),
            "apply_ops": 2 * B * B * blocks, "apply_bytes": 4 * B * B * blocks}


def bound(ops, nbytes, flops_per_s=F32_FLOPS_PER_S):
    t_ops, t_bytes = ops / flops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bcr_25x25_phase(report, fp_dense, state):
    """Phase 9: the 25x25 slope with BCR and the kernel over the 52 steps;
    one update's solve beside the dense path's at the iterate ``state``."""
    with open(RECORD) as f:
        rec = json.load(f)
    fp = pt.mohr_coulomb_slope_step(25, 25, route="cuda", linear_solver="bcr")
    check(fp.linear_solver == "bcr" and (fp._bcr["m"], fp._bcr["B"]) == (26, 204),
          "25x25 BCR plan")
    warm_up(fp, pt.SLOPE_LOADS[0])
    fp.bcr_stats.update(factorizations=0, inv_levels=0)
    mc_ops.mc_return_map.launches = 0
    _, its, rounds, walls, _ = run_loads(fp, pt.SLOPE_LOADS)
    launches = mc_ops.mc_return_map.launches
    stats = dict(fp.bcr_stats)
    check(its == rec["newton_per_step"], f"25x25 BCR Newton list {its} != record")
    check(launches == sum(its) + len(its), f"{launches} launches for Newton {its}")
    print(f"25x25 slope, BCR + kernel: newton {sum(its)}, launches {launches}, rounds "
          f"{sum(abs(r) for r in rounds)} (record {rec['cg_total']}; signed {rounds}), "
          f"levels on the LU inverse {stats['inv_levels']} of {stats['factorizations']} "
          f"factorizations, {sum(walls):.2f} s, s/step {[round(w, 4) for w in walls]}", flush=True)
    C_tang, b = newton_rhs(fp_dense, *state, pt.SLOPE_LOADS[49])
    _, k = fp._bcr_solve(C_tang, b, fp.cg_rtol)
    times = {"dense_ms": [], "bcr_ms": []}
    for name in ("dense_ms", "bcr_ms", "bcr_ms", "dense_ms"):
        fn = ((lambda: fp_dense._dense_solve(C_tang, b)) if name == "dense_ms"
              else (lambda: fp._bcr_solve(C_tang, b, fp.cg_rtol)))
        times[name].append(cuda_time_ms(fn, 10, warmup=2))
    print(f"25x25 step 50, one update's solve (CUDA events, in turns): dense "
          f"{times['dense_ms']} ms (2 refinement rounds), BCR {times['bcr_ms']} ms "
          f"({k} rounds)", flush=True)
    report["bcr_25x25"] = {"newton": its, "rounds": rounds, "launches": launches,
                           "wall_s": walls, "solve_ms": times, "solve_rounds": k,
                           "stats": stats}
    return launches


def bcr_layers(fp, Du, sig_n, load):
    """The layers of one BCR Newton pass at the iterate (Du, sig_n): CUDA
    events around the eager calls, as the path makes them."""
    plan, m, B = fp._bcr, fp._bcr["m"], fp._bcr["B"]
    C_tang, b = newton_rhs(fp, Du, sig_n, load)
    Tflat = fp._bcr_bands(C_tang)
    T, d = bcr.equilibrate(Tflat, plan["diag_slot"], m, B)
    fact = bcr.bcr_factor(T, m, B)
    return {
        "constitutive_ms": cuda_time_ms(lambda: fp._constitutive(Du, sig_n), 5, warmup=1),
        "band_assembly_ms": cuda_time_ms(lambda: fp._bcr_bands(C_tang), 5, warmup=1),
        "equilibrate_ms": cuda_time_ms(lambda: bcr.equilibrate(Tflat, plan["diag_slot"], m, B),
                                       5, warmup=1),
        "factor_ms": cuda_time_ms(lambda: bcr.bcr_factor(T, m, B), 5, warmup=1),
        "apply_ms": cuda_time_ms(lambda: fp._bcr_apply(fact, d, b), 20, warmup=2),
        "refine_matvec_ms": cuda_time_ms(lambda: fp._bc_matvec(C_tang, Du), 20, warmup=2),
        "solve_ms": cuda_time_ms(lambda: fp._bcr_solve(C_tang, b, fp.cg_rtol), 3, warmup=1),
    }


def bcr_100x100_phase(report, mat):
    """Phase 10: the 100x100 slope through ``auto`` (BCR) with the kernel
    over the record's 49 loads; then where step 48's time goes."""
    with open(RECORD_100) as f:
        rec = json.load(f)
    loads = pt.SLOPE_LOADS[:rec["steps"]]
    t0 = time.perf_counter()
    fp = pt.mohr_coulomb_slope_step(100, 100)
    setup_s = time.perf_counter() - t0
    check((fp.n_dofs, fp.nc * fp.nq, fp.linear_solver) == (80802, 60000, "bcr"),
          f"100x100: {fp.n_dofs} dofs, solver {fp.linear_solver}")
    m, B = fp._bcr["m"], fp._bcr["B"]
    check((m, B) == (101, 804), f"100x100 BCR plan m={m} B={B}")
    warm_up(fp, loads[0])
    torch.cuda.reset_peak_memory_stats()
    fp.bcr_stats.update(factorizations=0, inv_levels=0)
    mc_ops.mc_return_map.launches = 0
    _, its, rounds, walls, states = run_loads(fp, loads, capture=(47,))
    launches = mc_ops.mc_return_map.launches
    peak = torch.cuda.max_memory_allocated()
    stats = dict(fp.bcr_stats)
    print(f"100x100 slope, auto -> {fp.linear_solver} (m={m}, B={B}), setup {setup_s:.1f} s: "
          f"newton {its} ({sum(its)}), launches {launches}, rounds "
          f"{sum(abs(r) for r in rounds)} (record {rec['cg_total']}; signed {rounds}), "
          f"{sum(walls):.2f} s, {sum(walls) / len(walls):.3f} s/step, peak memory "
          f"{peak / 2**30:.2f} GiB, levels on the LU inverse {stats['inv_levels']} of "
          f"{stats['factorizations']} factorizations", flush=True)
    print(f"  s/step {[round(w, 3) for w in walls]}", flush=True)
    check(its == rec["newton_per_step"], f"100x100 Newton list {its} != record")
    check(launches == sum(its) + len(its), f"{launches} launches for Newton {its}")
    out = {"newton": its, "rounds": rounds, "launches": launches, "wall_s": walls,
           "setup_s": setup_s, "peak_bytes": peak, "stats": stats, "m": m, "B": B}
    report["bcr_100x100"] = out

    Du, sig = states[47]
    load = loads[47]
    counts = bcr_counts(m, B)
    layers = bcr_layers(fp, Du, sig, load)
    f_bound, f_by = bound(counts["factor_ops"], counts["factor_bytes"])
    a_bound, a_by = bound(counts["apply_ops"], counts["apply_bytes"])
    out.update(layers=layers, counts=counts, factor_bound_ms=f_bound, factor_bound_by=f_by,
               apply_bound_ms=a_bound, apply_bound_by=a_by)
    print("100x100 layers, step 48 (ms, CUDA events): "
          + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in layers.items()), flush=True)
    print(f"  factor {layers['factor_ms']:.2f} ms against {f_bound:.2f} ms ({f_by}: "
          f"{counts['factor_ops']:.3e} operations, {counts['factor_bytes'] / 1e9:.2f} GB); apply "
          f"{layers['apply_ms']:.3f} ms against {a_bound:.3f} ms ({a_by}: "
          f"{counts['apply_bytes'] / 1e9:.2f} GB)", flush=True)
    prof = profile_step(fp, Du, sig, load, os.path.join(OUT_DIR, "trace_bcr_100x100_step.json"))
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.1%}"
    print(f"100x100 step 48 under the profiler: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms (idle {idle}), {prof['device_events']} device events",
          flush=True)
    for name, t in prof["top_ms"][:10]:
        print(f"  {t:9.3f} ms  {name}", flush=True)
    out["profile"] = prof
    k1 = mc_kernel_phase(mat, *kernel_inputs(fp, Du, sig), "100x100 step 48 iterate")
    print(f"mohr_coulomb 100x100 step 48 iterate n={k1['n']}: {k1['plastic_lanes']} plastic, "
          f"{k1['listed_lanes']} listed for pass B; kernel {k1['ms'] * 1e3:.2f} us in a graph "
          f"(traced: pass A {k1['pass_a_ms'] * 1e3:.2f}, pass B {k1['pass_b_ms'] * 1e3:.2f}), "
          f"plain {k1['plain_ms']:.2f} ms, bound {k1['bound_ms'] * 1e3:.3f} us; rel err C "
          f"{k1['rel_err_C']:.2e}, sigma {k1['rel_err_sig']:.2e}, niter differs on "
          f"{k1['niter_diff_lanes']} lanes", flush=True)
    out["k1"] = k1
    return launches


def mg_counts(plan, gamma, nc, nk):
    """Bytes and operations of ``mg_setup`` and of one cycle as the port
    runs them (banded level 0).  Each level's operator has ``nnz`` values:
    bands x rows (banded), n^2 (dense), rows x ELL width.  A cycle applies
    the level-0 operator 6 times (2 pre-smoothing, the residual, 3
    post-smoothing), each level k below it 6 times per visit plus
    gamma_k - 1 residuals on level k + 1, and the coarse inverse once per
    visit of the coarsest level (visits multiply by gamma_k level by
    level); it reads each level's values and the coarse inverse once, r in
    and z out.  Setup reads the (nc, nk, nk) element blocks, writes every
    level's values (ELL, bands, dense) and the coarse inverse, and does the
    per-cell triple product (nk x nk1 by nk x nk), 8 power iterations per
    level and the (nL, nL) inverse; f32 throughout."""
    levels = plan["levels"]
    L = len(levels)
    gammas = (gamma,) if isinstance(gamma, int) else tuple(gamma)

    def nnz(lvl):
        return {"dia": lvl.get("dia", {}).get("nb", 0) * lvl["n"], "dense": lvl["n"] ** 2,
                "ell": lvl["n"] * lvl["cols"].shape[1]}[lvl["kind"]]

    nnz0 = plan["dia0"]["nb"] * plan["n0"]
    nL = levels[-1]["n"]
    ops, visits = 6 * nnz0, 1
    for k in range(1, L):
        g = gammas[min(k - 1, len(gammas) - 1)]
        ops += visits * (6 * nnz(levels[k - 1]) + (g - 1) * nnz(levels[k]))
        visits *= g
    ops = 2 * (ops + visits * nL * nL)
    values = nnz0 + sum(nnz(lvl) for lvl in levels) + nL * nL
    ell = sum(lvl["n"] * lvl["cols"].shape[1] for lvl in levels)
    nk1 = plan["transfers"][0]["W"].shape[2]
    setup_ops = (2 * nc * nk * nk1 * (nk + nk1) + 8 * 2 * (nnz0 + sum(nnz(lvl) for lvl in levels))
                 + 2 * nL ** 3)
    return {"cycle_ops": ops, "cycle_bytes": 4 * (values + 2 * plan["n0"]),
            "setup_ops": setup_ops, "setup_bytes": 4 * (nc * nk * nk + values + ell)}


def mg_layers(fp, Du, sig_n, load):
    """Where one AMG-CG update's time goes at the iterate (Du, sig_n): CUDA
    events around the eager calls (``mg_setup``, one cycle, the f32
    level-0 matvec and the f64 refinement matvec), and the cycle and the
    level-0 matvec replayed from a CUDA graph (device time without the
    host's launches); one ``mg.cuda_graphed`` call on the host's clock (its
    eager warm-up cycle and the capture, as every mg solve makes them); one
    whole solve and its inner iterations; bounds from ``mg_counts``, and for the level-0
    matvec its bands and x read once, its result written once, or its
    multiply-adds at the f32 peak."""
    plan = fp._mg
    C_tang, b = newton_rhs(fp, Du, sig_n, load)
    K_cell = fp._k_cell_masked(C_tang)
    K32 = K_cell.to(torch.float32)
    rt = mg.mg_setup(plan, K32)
    r = b.to(torch.float32)
    if fp._mg_mv0_mode == "dia":
        r = torch.where(plan["mask0_lat"], 0.0, r[plan["perm0_l2o"]])
    mv64 = mg.ebe_matvec(K_cell, plan["ebe"])
    n, nb = fp.n_dofs, plan["dia0"]["nb"]
    counts = mg_counts(plan, fp._mg_gamma, *K32.shape[:2])
    bounds = {"mv0": bound(2 * nb * n, 4 * n * (nb + 2)),
              "vcycle": bound(counts["cycle_ops"], counts["cycle_bytes"]),
              "mg_setup": bound(counts["setup_ops"], counts["setup_bytes"])}

    def cycle():
        return mg.vcycle(plan, rt, r, gamma_coarse=fp._mg_gamma)

    mask = plan["mask0_lat"] if fp._mg_mv0_mode == "dia" else fp.statics["bc_mask"]

    def M32(x):
        return torch.where(mask, x, mg.vcycle(plan, rt, torch.where(mask, 0.0, x),
                                              gamma_coarse=fp._mg_gamma))

    out = {
        "mg_setup_ms": cuda_time_ms(lambda: mg.mg_setup(plan, K32), 5, warmup=1),
        "vcycle_ms": cuda_time_ms(cycle, 20, warmup=3),
        "vcycle_graph_ms": graph_time_ms(cycle, 10),
        "mv0_f32_ms": cuda_time_ms(lambda: rt["mv0"](r), 50, warmup=5),
        "mv0_f32_graph_ms": graph_time_ms(lambda: rt["mv0"](r), 50),
        "refine_mv64_ms": cuda_time_ms(lambda: mv64(b), 50, warmup=5),
        "capture_ms": wall_time_ms(lambda: mg.cuda_graphed(M32, r), 3),
        "solve_ms": cuda_time_ms(lambda: fp._mg_solve(C_tang, b, fp.cg_rtol), 3, warmup=1),
        "solve_inner": fp._mg_solve(C_tang, b, fp.cg_rtol)[1],
        "mv0_bands": nb, "counts": counts,
    }
    for name, (ms, by) in bounds.items():
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = ms, by
    return out


def print_mg_layers(title, layers):
    print(f"{title} (ms, CUDA events; capture on the host's clock): "
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in layers.items()
                      if k.endswith("_ms") and "bound" not in k)
          + f"; the solve's inner iterations {layers['solve_inner']}", flush=True)
    print("  bounds (ms): " + ", ".join(
        f"{k[:-9]} {layers[k]:.4g} ({layers[k[:-3] + '_by']})"
        for k in layers if k.endswith("_bound_ms")), flush=True)


def mg_25x25_phase(report, fp_dense, state):
    """Phase 11: ``entry()``'s program, the 25x25 slope with AMG-CG (dia
    mode) and the kernel over the 52 steps; where step 50's update goes;
    one update's solve beside the dense path's at the iterate ``state``;
    step 51 profiled; the first 10 steps again, bitwise."""
    with open(RECORD) as f:
        rec = json.load(f)["newton_per_step"]
    loads = pt.SLOPE_LOADS
    fp = pt.mohr_coulomb_slope_step(25, 25, route="cuda", linear_solver="mg")
    check(fp.linear_solver == "mg" and fp._mg_mv0_mode == "dia" and fp.mg_sizes[0] == 5202,
          f"25x25 mg: {fp.linear_solver}, {fp._mg_mv0_mode}, {fp.mg_sizes}")
    warm_up(fp, loads[0])
    torch.cuda.reset_peak_memory_stats()
    mc_ops.mc_return_map.launches = 0
    Du_end, its, inner, walls, states = run_loads(fp, loads, capture=(10, 49, 50))
    launches = mc_ops.mc_return_map.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"25x25 slope, mg (dia) + kernel: newton {sum(its)}, launches {launches}, inner "
          f"{sum(inner)} ({sum(inner) / sum(its):.1f} per update), levels {fp.mg_sizes} "
          f"({[lvl['kind'] for lvl in fp._mg['levels']]}), {sum(walls):.2f} s, "
          f"{sum(walls) / len(walls):.4f} s/step, peak memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"  inner per step {inner}", flush=True)
    print(f"  s/step {[round(w, 4) for w in walls]}", flush=True)
    check(its == rec, f"25x25 mg Newton list {its} != record {rec}")
    check(launches == sum(its) + len(its), f"{launches} launches for Newton {its}")
    gap = sum(inner) / MG_25_INNER_JAX - 1.0
    print(f"  inner iterations {sum(inner)} against the JAX package's {MG_25_INNER_JAX} on the "
          f"CPU: {gap:+.1%} (bound {MG_INNER_TOL:.0%})", flush=True)
    check(abs(gap) <= MG_INNER_TOL, f"25x25 mg inner iterations {sum(inner)} beyond "
          f"{MG_INNER_TOL:.0%} of {MG_25_INNER_JAX}")
    out = {"newton": its, "inner": inner, "launches": launches, "wall_s": walls,
           "peak_bytes": peak, "levels": fp.mg_sizes,
           "kinds": [lvl["kind"] for lvl in fp._mg["levels"]]}
    report["mg_25x25"] = out

    Du, sig = states[49]
    layers = mg_layers(fp, Du, sig, loads[49])
    out["layers"] = layers
    print_mg_layers("25x25 mg layers, step 50", layers)
    C_tang, b = newton_rhs(fp_dense, *state, loads[49])
    _, k = fp._mg_solve(C_tang, b, fp.cg_rtol)
    times = {"dense_ms": [], "mg_ms": []}
    for name in ("dense_ms", "mg_ms", "mg_ms", "dense_ms"):
        fn = ((lambda: fp_dense._dense_solve(C_tang, b)) if name == "dense_ms"
              else (lambda: fp._mg_solve(C_tang, b, fp.cg_rtol)))
        times[name].append(cuda_time_ms(fn, 5, warmup=1))
    print(f"25x25 step 50, one update's solve (CUDA events, in turns): dense {times['dense_ms']} "
          f"ms, mg {times['mg_ms']} ms ({k} inner iterations)", flush=True)
    out.update(solve_ms=times, solve_inner=k)

    Du, sig = states[50]
    prof = profile_step(fp, Du, sig, loads[50], os.path.join(OUT_DIR, "trace_mg_step.json"))
    _, _, _, it51, k51 = fp.run_step(Du, sig, loads[50])
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.1%}"
    print(f"25x25 mg step 51 under the profiler: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms (idle {idle}), {prof['device_events']} device events "
          f"and {prof['host_launches']} launch calls of the host for {it51} updates and {k51} "
          f"inner iterations ({prof['device_events'] / max(k51, 1):.0f} and "
          f"{prof['host_launches'] / max(k51, 1):.0f} per inner iteration)", flush=True)
    for name, t in prof["top_ms"][:8]:
        print(f"  {t:9.3f} ms  {name}", flush=True)
    out["profile"] = dict(prof, updates=it51, inner=k51)

    Du10, _ = states[10]
    Du_again, *_ = run_loads(fp, loads[:10])
    check(torch.equal(Du_again, Du10), "25x25 mg: the first 10 steps run twice differ")
    print("25x25 mg: the first 10 steps run a second time give Du bitwise equal", flush=True)
    return launches, {"state10": states[10], "newton": its, "inner": inner, "du": Du_end}


def elastic_25x25_phase(report):
    """Phase 12: the 25x25 slope with the lagged-elastic solver and the
    kernel over the 52 steps."""
    with open(RECORD) as f:
        rec = json.load(f)["newton_per_step"]
    t0 = time.perf_counter()
    fp = pt.mohr_coulomb_slope_step(25, 25, route="cuda", linear_solver="elastic")
    setup_s = time.perf_counter() - t0
    # the warm-up step refreshes the lagged preconditioner: the schedule
    # starts again from the elastic one
    first = fp._el_precond
    warm_up(fp, pt.SLOPE_LOADS[0])
    fp._el_precond = first
    mc_ops.mc_return_map.launches = 0
    _, its, inner, walls, states = run_loads(fp, pt.SLOPE_LOADS, capture=(49,))
    launches = mc_ops.mc_return_map.launches
    print(f"25x25 slope, elastic + kernel: newton {sum(its)}, launches {launches}, inner "
          f"{sum(inner)} ({sum(inner) / sum(its):.1f} per update), setup {setup_s:.2f} s, "
          f"{sum(walls):.2f} s, {sum(walls) / len(walls):.4f} s/step", flush=True)
    print(f"  inner per step {inner}", flush=True)
    check(its == rec, f"25x25 elastic Newton list {its} != record {rec}")
    check(launches == sum(its) + len(its), f"{launches} launches for Newton {its}")
    # the end-of-step refresh at step 50's first tangent: the SPD inverse
    # does n^3 operations (Cholesky, triangular inverse and the product,
    # n^3 / 3 each); it reads the f32 element blocks and writes the inverse
    C_tang, _ = fp._constitutive(*states[49])
    n, (nc, nk) = fp.n_dofs, fp.statics["dofmap"].shape
    refresh_bound, refresh_by = bound(n ** 3, 4 * (nc * nk * nk + n * n + n))
    refresh_ms = cuda_time_ms(lambda: fp._refresh_elastic(C_tang), 5, warmup=1)
    print(f"  end-of-step refresh at step 50: {refresh_ms:.3f} ms against {refresh_bound:.4g} ms "
          f"({refresh_by})", flush=True)
    report["elastic_25x25"] = {"newton": its, "inner": inner, "launches": launches,
                               "wall_s": walls, "setup_s": setup_s, "refresh_ms": refresh_ms,
                               "refresh_bound_ms": refresh_bound, "refresh_bound_by": refresh_by}
    return launches


def mg_100x100_phase(report, steps=MG_100_STEPS):
    """Phase 13: the 100x100 slope with AMG-CG through ``run_step_host(
    forcing=False)``, the protocol of the AMG-CG record, over its first
    ``steps`` loads; one solve at the last step's first iterate beside one
    BCR solve of the same system, in turns."""
    with open(RECORD_100_MG) as f:
        rec = json.load(f)
    loads = pt.SLOPE_LOADS[:steps]
    t0 = time.perf_counter()
    fp = pt.mohr_coulomb_slope_step(100, 100, route="cuda", linear_solver="mg")
    build_s = time.perf_counter() - t0
    check((fp.n_dofs, fp.nc * fp.nq, fp._mg_mv0_mode) == (80802, 60000, "dia"),
          f"100x100 mg: {fp.n_dofs} dofs, {fp._mg_mv0_mode}")
    torch.cuda.reset_peak_memory_stats()
    mc_ops.mc_return_map.launches = 0
    Du, sig = fp.zero_state()
    its, inner, walls = [], [], []
    for k, load in enumerate(loads):
        if k == steps - 1:
            state = (Du.clone(), sig.clone())
        t = time.perf_counter()
        Du, sig, norm, it, cg = fp.run_step_host(Du, sig, load, forcing=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        check(np.isfinite(float(norm)), f"non-finite residual at load {load}")
        its.append(int(it))
        inner.append(int(cg))
    launches = mc_ops.mc_return_map.launches
    peak = torch.cuda.max_memory_allocated()
    ref = rec["newton_per_step"][:steps]
    print(f"100x100 slope, mg (dia) + kernel, host-driven, {steps} steps: host build "
          f"{build_s:.1f} s, levels {fp.mg_sizes} ({[lvl['kind'] for lvl in fp._mg['levels']]}), "
          f"newton {its} ({sum(its)}), launches {launches}, inner {inner} "
          f"({sum(inner) / sum(its):.1f} per update; the record {rec['cg_total']} / "
          f"{rec['newton_total']} = {rec['cg_total'] / rec['newton_total']:.1f}), "
          f"{sum(walls):.2f} s, {sum(walls) / len(walls):.3f} s/step, peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"  s/step {[round(w, 3) for w in walls]}", flush=True)
    check(its == ref, f"100x100 mg Newton list {its} != the record's first {steps} {ref}")
    check(launches == sum(its) + len(its), f"{launches} launches for Newton {its}")
    out = {"newton": its, "inner": inner, "launches": launches, "wall_s": walls,
           "build_s": build_s, "peak_bytes": peak, "levels": fp.mg_sizes, "steps": steps}
    report["mg_100x100"] = out

    fp_bcr = pt.mohr_coulomb_slope_step(100, 100, route="cuda", linear_solver="bcr")
    C_tang, b = newton_rhs(fp, *state, loads[-1])
    _, k_mg = fp._mg_solve(C_tang, b, fp.cg_rtol)
    _, k_bcr = fp_bcr._bcr_solve(C_tang, b, fp.cg_rtol)
    times = {"bcr_ms": [], "mg_ms": []}
    for name in ("bcr_ms", "mg_ms", "mg_ms", "bcr_ms"):
        fn = ((lambda: fp_bcr._bcr_solve(C_tang, b, fp.cg_rtol)) if name == "bcr_ms"
              else (lambda: fp._mg_solve(C_tang, b, fp.cg_rtol)))
        times[name].append(cuda_time_ms(fn, 2, warmup=1))
    print(f"100x100 step {steps}, one update's solve (CUDA events, in turns): BCR "
          f"{times['bcr_ms']} ms ({k_bcr} rounds), mg {times['mg_ms']} ms ({k_mg} inner "
          f"iterations)", flush=True)
    out.update(solve_ms=times, solve_inner=k_mg, solve_bcr_rounds=k_bcr)
    layers = mg_layers(fp, *state, loads[-1])
    out["layers"] = layers
    print_mg_layers(f"100x100 mg layers, step {steps}", layers)
    return launches


def allreduce_ms(mesh, sizes, reps=200):
    """Rank function of ``dist.spawn``: host milliseconds per ``dist.psum``
    of a CUDA tensor of each (length, dtype) in ``sizes``, over ``reps``
    calls ending in a synchronise."""
    out = {}
    for n, dtype in sizes:
        x = torch.ones(n, dtype=getattr(torch, dtype), device=mesh.device)
        for _ in range(5):
            dist.psum(x, mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.psum(x, mesh.group)
        torch.cuda.synchronize()
        out[f"{n} {dtype}"] = (time.perf_counter() - t0) / reps * 1e3
    return out


def sharded_one_rank_phase(report, ref):
    """Phase 14: the first 10 steps of phase 11's program on one NCCL rank
    through the sharded code, bitwise equal to phase 11's run."""
    loads = pt.SLOPE_LOADS[:10]
    t0 = time.perf_counter()
    (run,) = dist.spawn(slope_schedule, 1, "nccl", None, 25, loads, "mg")
    wall = time.perf_counter() - t0
    Du10, sig10 = (t.cpu().numpy() for t in ref["state10"])
    print(f"25x25 mg sharded, 1 rank over NCCL, 10 steps: newton {run['newton']}, inner "
          f"{run['inner']}, K1 launches {run['launches']}, {run['psum_calls']} all-reduces for "
          f"{run['passes']} Newton passes, {sum(run['wall_s']):.2f} s of steps, {wall:.1f} s "
          f"with the process's start", flush=True)
    check(run["newton"] == ref["newton"][:10], f"1-rank Newton list {run['newton']}")
    check(run["inner"] == ref["inner"][:10], f"1-rank inner counts {run['inner']}")
    check(run["launches"] == run["passes"], f"1-rank K1 launches {run['launches']}")
    check(np.array_equal(run["du"], Du10), "1-rank Du differs from phase 11's")
    check(np.array_equal(run["sigma"], sig10), "1-rank sigma differs from phase 11's")
    print("  Du, sigma, the Newton list and the inner counts bitwise equal to phase 11's first "
          "10 steps", flush=True)
    report["sharded_1rank_nccl"] = dict(run, du=None, sigma=None, wall_total_s=wall)
    return run["launches"]


def sharded_schedule_phase(report, ref, n, backend):
    """Phase 15 (and 17 over NCCL): phase 11's program on ``n`` ranks; the
    time of one all-reduce."""
    with open(RECORD) as f:
        rec = json.load(f)["newton_per_step"]
    loads = pt.SLOPE_LOADS
    t0 = time.perf_counter()
    runs = dist.spawn(slope_schedule, n, backend, None, 25, loads, "mg")
    wall = time.perf_counter() - t0
    label = f"{n} ranks over {backend} on {torch.cuda.device_count()} card(s)"
    ref_du = ref["du"].cpu().numpy()
    first = runs[0]
    for run in runs:
        check(run["newton"] == rec, f"{label}: rank {run['rank']} Newton list {run['newton']}")
        check(run["launches"] == run["passes"],
              f"{label}: rank {run['rank']} K1 launches {run['launches']}")
        check(run["norms"] == first["norms"] and np.array_equal(run["du"], first["du"]),
              f"{label}: ranks disagree")
    du_err = float(np.abs(first["du"] - ref_du).max())
    check(du_err < 1e-9, f"{label}: Du {du_err:.3e} from one rank's")
    for k, k1 in zip(first["inner"], ref["inner"]):
        check(abs(k - k1) <= max(10, 0.4 * k1),
              f"{label}: inner {first['inner']} against one rank's {ref['inner']}")
    steps = sum(first["wall_s"])
    # a dof vector (the residual, a matvec) and the level-0 band values
    # (43 bands of 5,202 rows, mg_setup)
    ar = dist.spawn(allreduce_ms, n, backend, None, [(5202, "float64"), (43 * 5202, "float32")])
    print(f"25x25 mg sharded, {label}, {len(loads)} steps: newton {sum(first['newton'])} "
          f"per rank, K1 launches {[r['launches'] for r in runs]}, inner {sum(first['inner'])} "
          f"(one rank: {sum(ref['inner'])}), Du {du_err:.2e} from one rank's, "
          f"{steps:.2f} s of steps ({steps / len(loads):.4f} s/step), {wall:.1f} s with the "
          f"processes' start; {first['psum_calls']} all-reduces for {first['passes']} Newton "
          f"passes ({first['psum_calls'] / first['passes']:.2f} per pass); one all-reduce (ms, "
          f"host clock, rank 0): {ar[0]}", flush=True)
    print(f"  s/step rank 0 {[round(w, 4) for w in first['wall_s']]}", flush=True)
    report[f"sharded_{n}_{backend}"] = {
        "ranks": [dict(r, du=None, sigma=None) for r in runs], "du_err": du_err,
        "wall_total_s": wall, "allreduce_ms": ar, "cards": torch.cuda.device_count()}
    return [r["launches"] for r in runs]


def dryrun_phase(report, n, backend):
    """Phase 16 (and 17 over NCCL): ``dryrun_multichip(n)`` on the card."""
    t0 = time.perf_counter()
    runs = dryrun_multichip(n, backend=backend)
    wall = time.perf_counter() - t0
    for run in runs:
        check(run["newton"] == [1, 2], f"dryrun rank {run['rank']} Newton {run['newton']}")
        check(run["launches"] == run["passes"], f"dryrun K1 launches {run['launches']}")
        for k, rec in zip(run["inner"], DRYRUN_RECORD_INNER):
            check(abs(k - rec) <= max(10, 0.4 * rec),
                  f"dryrun inner {run['inner']} against the record's {DRYRUN_RECORD_INNER}")
    print(f"dryrun_multichip({n}, {backend}): inner {runs[0]['inner']} beside "
          f"MULTICHIP_r05.json's {list(DRYRUN_RECORD_INNER)} (the JAX package, 8 virtual "
          f"devices), {wall:.1f} s", flush=True)
    report[f"dryrun_{n}_{backend}"] = {"ranks": [dict(r, du=None, sigma=None) for r in runs],
                                       "wall_total_s": wall}
    return runs[0]["launches"]


def general_layers(run, step, loads):
    """Where one Newton pass of the general path goes at the starting
    iterate of load step ``step`` (0-based) of ``loads``: host
    milliseconds of each layer, each ending in a synchronise."""
    from dolfinx_external_operator_torch import evaluate_operands
    from dolfinx_external_operator_torch.solvers import lu_factor32, lu_refine

    Du, sigma_n = run["states"][step]
    run["Du"].x.array[:] = Du
    run["sigma_n"].x.array[:] = sigma_n
    run["q"].value = loads[step] * np.array([0.0, -run["gamma"]])
    problem, mat = run["problem"], run["material"]
    (operand,) = run["F_ops"][0].ufl_operands
    deps = evaluate_operands(run["F_ops"])[operand]
    run["constitutive_update"]()
    A = problem.J.matrix()
    mask = torch.zeros(A.shape[0], dtype=torch.bool, device=A.device)
    for bc in problem.bcs:
        mask[torch.as_tensor(bc.dofs, device=A.device)] = True
    keep = (~mask).to(A.dtype)
    A = A * keep[:, None] * keep[None, :] + torch.diag(mask.to(A.dtype))
    factors = lu_factor32(A)
    b = -torch.where(mask, torch.zeros_like(Du), problem.F.vector())
    x = lu_refine(factors, b, 4)
    rel = float((b - A @ x).norm() / b.norm())
    n = A.shape[0]
    return {
        "evaluate_operands_ms": host_time_ms(lambda: evaluate_operands(run["F_ops"])),
        "k1_callback_ms": host_time_ms(lambda: mat.tangent_and_stress(deps, sigma_n, route="cuda")),
        "constitutive_update_ms": host_time_ms(run["constitutive_update"]),
        "F_vector_ms": host_time_ms(problem.F.vector),
        "J_matrix_ms": host_time_ms(problem.J.matrix),
        "J_matrix_bound_ms": n * n * 8 / HBM_BYTES_PER_S * 1e3,
        "lu_factor_ms": host_time_ms(lambda: lu_factor32(A)),
        "lu_factor_bound_ms": 2.0 / 3.0 * n**3 / F32_FLOPS_PER_S * 1e3,
        "refine_4_rounds_ms": host_time_ms(lambda: lu_refine(factors, b, 4)),
        "solve_rel_residual": rel,
    }


def general_slope_phase(report, u_fused, fused_s, n=25, loads=pt.SLOPE_LOADS, device="cuda",
                        steps=(49, 50)):
    """Phase 18: the Mohr-Coulomb slope through the general pipeline
    (``solve_slope_stability``: forms, operands, K1 as the operator's
    callback, dense assembly, f32 LU with 4 f64 rounds, Newton) at n x n
    over ``loads``; ``steps``: the load steps whose layers are timed and
    which runs under the profiler.  The smaller sizes rehearse it."""
    from dolfinx_external_operator_torch.models import mohr_coulomb as mc

    with open(RECORD) as f:
        record = json.load(f)["newton_per_step"]
    expected_its = GENERAL_25X25 if n == 25 else None
    # first calls of the LU and the forms' code, on a small slope
    mc.solve_slope_stability(4, 4, loads[:2], device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the path's count starts at 0 here and is read after it
    mc_ops.mc_return_map.launches = 0
    t0 = time.perf_counter()
    run = mc.solve_slope_stability(n, n, loads, device=device, route="cuda", capture=steps)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = mc_ops.mc_return_map.launches
    peak = torch.cuda.max_memory_allocated()
    its, backtracks = run["iterations"], sum(run["backtracks"])
    backtracked = [k + 1 for k, b in enumerate(run["backtracks"]) if b]
    u = run["u"].data
    check(run["V"].num_dofs == 2 * (2 * n + 1) ** 2 and run["S"].num_dofs == 4 * 6 * n * n,
          "wrong general slope size")
    check(bool(torch.isfinite(u).all()) and u.device.type == device, "bad general-path u")
    check(expected_its is None or its == expected_its,
          f"general-path Newton list {its} != the JAX package's {expected_its}")
    off_record = [k + 1 for k, (a, b) in enumerate(zip(its, record)) if a != b]
    # one update before the schedule, then one per residual: each Newton
    # pass, each step's closing pass, each backtracking retry
    expected = 1 + sum(its) + len(its) + backtracks
    check(launches == expected, f"{launches} K1 launches on the general path, expected {expected}")
    gap = float((u - u_fused).abs().max() / u_fused.abs().max())
    check(gap < 1e-8, f"general-path u differs from the fused step's by {gap:.3e}")
    steps_s = sum(run["step_s"])
    print(f"{n}x{n} slope, general pipeline (K1 callback, f32 LU + 4 rounds): newton {its} "
          f"({sum(its)}; off the fused record at steps {off_record}), backtracks {backtracks} "
          f"(at steps {backtracked}), K1 launches {launches}, u gap to the fused "
          f"step {gap:.2e}; {steps_s:.2f} s of steps ({steps_s / len(its):.4f} s/step), "
          f"{total:.2f} s with the build; the fused step in this run {fused_s:.2f} s "
          f"({fused_s / len(its):.4f} s/step); peak memory {peak / 2**30:.3f} GiB", flush=True)
    layers = general_layers(run, steps[0], loads)
    print(f"{n}x{n} general path, step {steps[0] + 1}'s iterate (ms): "
          + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in layers.items() if k.endswith("_ms"))
          + f"; solve residual {layers['solve_rel_residual']:.2e}", flush=True)
    Du, sigma_n = run["states"][steps[1]]
    run["Du"].x.array[:] = Du
    run["sigma_n"].x.array[:] = sigma_n
    run["q"].value = loads[steps[1]] * np.array([0.0, -run["gamma"]])
    wall, by_name, events, host_launches = traced(
        run["problem"].solve, os.path.join(OUT_DIR, "trace_general_step.json"))
    busy = sum(by_name.values())
    idle = 1.0 - busy / (wall * 1e3) if events else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"{n}x{n} general path, step {steps[1] + 1} under the profiler: wall {wall * 1e3:.2f} ms, device "
          f"busy {busy:.2f} ms (idle {'not measured' if idle is None else f'{idle:.1%}'}), "
          f"{events} device events, {host_launches} host launches", flush=True)
    for name, t in top[:8]:
        print(f"  {t:9.3f} ms  {name}", flush=True)
    report["general_slope"] = {
        "newton": its, "steps_off_record": off_record, "backtracks": run["backtracks"], "launches": launches, "u_gap_to_fused": gap,
        "step_s": run["step_s"], "steps_s": steps_s, "total_s": total, "fused_s": fused_s,
        "peak_bytes": peak, "layers_step50": layers,
        "profile_step51": {"wall_ms": wall * 1e3, "device_busy_ms": busy, "idle_share": idle,
                           "device_events": events, "host_launches": host_launches,
                           "top_ms": top}}
    return launches, {"newton": its, "u": u.cpu().numpy(), "launches": launches}


# the von Mises cylinder's records (the JAX package on the CPU)
VM_RECORD = os.path.join(RECORDS, "von_mises_20steps_general_mg.json")
VM_TWIN_RECORD = os.path.join(RECORDS, "von_mises_20steps.json")
HYPER_RECORD = os.path.join(RECORDS, "hyperelasticity_lc005_100steps.json")
# steps of the cylinder's 20-step schedule before plasticity: their Newton
# counts are forced (0, then one update each); on the plastic steps every
# Gauss point starts on the yield surface (|f| ~ 1e-13 at Du = eps), so the
# first tangent is decided by rounding and a count may move by one
VM_ELASTIC_STEPS = 13
# steps 1-10 of the cylinder's 20-step schedule load it below its elastic
# limit at every mesh size: an exact linear solve converges in one update
VM_LINEAR_STEPS = 11
# the JAX package's Newton counts (tests/test_torch_solvers.py, CPU) for
# the bound-constrained problems: the 12x12 membrane on the floor -0.05
# (dense) and the 10x10 elastic block on the floor -0.04 (cg + mg)
VI_MEMBRANE_NEWTON = 2
VI_BLOCK_NEWTON = 6


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def within_one(its, ref, forced=0):
    """Equal on the first ``forced`` steps, within one update after."""
    return (len(its) == len(ref) and its[:forced] == ref[:forced]
            and all(abs(a - b) <= 1 for a, b in zip(its, ref)))


def vm_update_layers(run, device):
    """One Newton update of a cylinder run, at its last converged state:
    host milliseconds of the constitutive callback, the residual, the
    Jacobian's assembly and the linear solve, each ending in a
    synchronise."""
    from dolfinx_external_operator_torch.assembly import bc_arrays
    from dolfinx_external_operator_torch.solvers import lu_factor32, lu_refine

    problem = run["problem"]
    solver, J = problem.solver, problem.J
    n = problem.u.function_space.num_dofs
    mask, _ = bc_arrays(problem.bcs, n, problem.u.device)
    problem.external_callback()
    b = -torch.where(mask, 0.0, problem.F.vector())

    def timed(fn):
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        sync(device)
        return (time.perf_counter() - t0) / 3 * 1e3

    out = {"callback_ms": timed(problem.external_callback), "F_vector_ms": timed(problem.F.vector)}
    if solver.pc_type == "mg":
        out["J_element_tensors_ms"] = timed(J.element_tensors)
        elems = J.element_tensors()
        out["solve_ms"] = timed(lambda: solver._mg_solve(problem, elems, mask, b, 10000))
    else:
        def eliminated():
            A = J.matrix()
            keep = (~mask).to(A.dtype)
            return A * keep[:, None] * keep[None, :] + torch.diag(mask.to(A.dtype))

        out["J_matrix_ms"] = timed(J.matrix)
        A = eliminated()
        out["solve_ms"] = timed(lambda: lu_refine(lu_factor32(A), b, 4))
    return out


def vm_cylinder_phase(report, lc=0.3, device="cuda"):
    """Phase 19: the von Mises cylinder through the general pipeline at the
    records' size (lc=0.3, 20 increments): direct, cg + mg and the
    pure-form twin."""
    from dolfinx_external_operator_torch.models import von_mises as vmm

    with open(VM_RECORD) as f:
        rec = json.load(f)
    with open(VM_TWIN_RECORD) as f:
        twin_gap_rec = json.load(f)["max_displacement_diff_vs_pure_twin"]
    vmm.solve_von_mises(lc=0.5, num_increments=2, device=device)  # first calls
    runs = {}
    for name, opts in (("direct", None), ("mg", {"ksp_type": "cg", "pc_type": "mg"})):
        sync(device)
        t0 = time.perf_counter()
        runs[name] = vmm.solve_von_mises(lc=lc, num_increments=20, snes_opts=opts, device=device)
        sync(device)
        runs[name]["wall_s"] = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    pure = vmm.solve_von_mises_pure_form(lc=lc, num_increments=20, device=device)
    sync(device)
    pure_s = time.perf_counter() - t0
    d, m = runs["direct"], runs["mg"]
    for r in (d, m, pure):
        check(np.isfinite(r["results"]).all() and bool(torch.isfinite(r["u"].data).all())
              and r["u"].data.device.type == torch.device(device).type, "bad cylinder result")
    gap_mg = float(np.abs(m["results"][:, 0] - d["results"][:, 0]).max())
    gap_pure = float(np.abs(pure["results"][:, 0] - d["results"][:, 0]).max())
    equal = {"direct": d["iterations"] == rec["newton_its_direct"],
             "mg": m["iterations"][:-1] == rec["newton_its_mg"][:-1]
             and m["iterations"][-1] in (6, 7)}
    print(f"von Mises cylinder lc={lc}, 20 increments, general path: direct newton "
          f"{d['iterations']} ({sum(d['iterations'])}; record {rec['newton_total_direct']}, "
          f"equal: {equal['direct']}), {d['wall_s']:.2f} s; cg+mg newton {m['iterations']} "
          f"({sum(m['iterations'])}; record {rec['newton_total_mg']}, equal but the last step: "
          f"{equal['mg']}), inner {sum(m['ksp_iterations'])}, {m['wall_s']:.2f} s; pure twin "
          f"newton {pure['iterations']}, {pure_s:.2f} s; probe gaps to direct: mg {gap_mg:.2e}, "
          f"pure twin {gap_pure:.2e} (record {twin_gap_rec:.2e})", flush=True)
    for name, ref in (("direct", rec["newton_its_direct"]), ("mg", rec["newton_its_mg"])):
        check(within_one(runs[name]["iterations"], ref, VM_ELASTIC_STEPS),
              f"cylinder {name} Newton list {runs[name]['iterations']} off the record's {ref}")
    check(gap_mg <= 1e-10, f"cylinder mg probe {gap_mg:.3e} from direct")
    check(gap_pure <= 1e-10, f"cylinder pure twin probe {gap_pure:.3e} from direct")
    report["vm_cylinder"] = {
        "lc": lc, "newton_direct": d["iterations"], "newton_mg": m["iterations"],
        "newton_pure": pure["iterations"], "equal_to_record": equal,
        "inner_mg": m["ksp_iterations"], "probe_gap_mg": gap_mg, "probe_gap_pure": gap_pure,
        "wall_s": {"direct": d["wall_s"], "mg": m["wall_s"], "pure": pure_s},
        "step_s": {"direct": d["step_s"], "mg": m["step_s"], "pure": pure["step_s"]}}


def dense_rounds(run, device, rounds=8, seed=0):
    """The relative residual of the dense solve (``lu_factor32``, then
    0..``rounds`` f64 refinement rounds) of a run's eliminated Jacobian at
    its last state against a seeded right-hand side: how far the f32
    factorization's rounds contract at this size."""
    from dolfinx_external_operator_torch.assembly import bc_arrays
    from dolfinx_external_operator_torch.solvers import lu_factor32, lu_refine

    problem = run["problem"]
    n = problem.u.function_space.num_dofs
    mask, _ = bc_arrays(problem.bcs, n, problem.u.device)
    problem.external_callback()
    A = problem.J.matrix()
    keep = (~mask).to(A.dtype)
    A = A * keep[:, None] * keep[None, :] + torch.diag(mask.to(A.dtype))
    g = torch.Generator(device=A.device).manual_seed(seed)
    b = torch.where(mask, 0.0, torch.randn(n, dtype=A.dtype, device=A.device, generator=g))
    factors = lu_factor32(A)
    return [float((b - A @ lu_refine(factors, b, k)).norm() / b.norm()) for k in range(rounds + 1)]


def vm_fine_phase(report, lc=0.02, device="cuda", gmres_steps=5):
    """Phase 20: the cylinder at lc=0.02 (11,222 dofs, 8,100 Gauss points),
    where AMG is meant to pay: 20 increments direct and with cg + mg, the
    first ``gmres_steps`` with gmres + mg."""
    from dolfinx_external_operator_torch.models import von_mises as vmm

    runs = {}
    for name, opts, steps in (("direct", None, None),
                              ("mg", {"ksp_type": "cg", "pc_type": "mg"}, None),
                              ("gmres_mg", {"ksp_type": "gmres", "pc_type": "mg"}, gmres_steps)):
        if device == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync(device)
        t0 = time.perf_counter()
        r = vmm.solve_von_mises(lc=lc, num_increments=20, snes_opts=opts, device=device,
                                steps=steps)
        sync(device)
        r["wall_s"] = time.perf_counter() - t0
        r["peak_bytes"] = torch.cuda.max_memory_allocated() if device == "cuda" else None
        runs[name] = r
    d, m, g = runs["direct"], runs["mg"], runs["gmres_mg"]
    n_dofs = d["u"].function_space.num_dofs
    n_pts = d["p"].function_space.num_dofs
    for r in runs.values():
        check(np.isfinite(r["results"]).all() and bool(torch.isfinite(r["u"].data).all()),
              "bad fine cylinder result")
    gap = float(np.abs(m["results"][-1, 0] - d["results"][-1, 0]))
    gap_g = float(np.abs(g["results"][:gmres_steps, 0] - d["results"][:gmres_steps, 0]).max())
    layers = {name: vm_update_layers(runs[name], device) for name in ("direct", "mg")}
    last_hist = {name: runs[name]["problem"].solver.history for name in ("direct", "mg")}
    rounds = dense_rounds(d, device)
    print(f"von Mises cylinder lc={lc}: {n_dofs} dofs, {n_pts} Gauss points", flush=True)
    print("  step  direct  mg  inner(mg)", flush=True)
    for k, (a, b, c) in enumerate(zip(d["iterations"], m["iterations"], m["ksp_iterations"])):
        print(f"  {k:4d}  {a:6d}  {b:2d}  {c:9d}", flush=True)
    for name, r in runs.items():
        steps = len(r["iterations"])
        peak = "not measured" if r["peak_bytes"] is None else f"{r['peak_bytes'] / 2**30:.3f} GiB"
        print(f"  {name}: newton {sum(r['iterations'])} over {steps} steps, inner "
              f"{sum(r['ksp_iterations'])}, {sum(r['step_s']):.2f} s of steps "
              f"({sum(r['step_s']) / steps:.4f} s/step), peak memory {peak}", flush=True)
    for name, lay in layers.items():
        print(f"  one {name} update at the last state (ms): "
              + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in lay.items()), flush=True)
    print(f"  final probe: mg {gap:.2e} from direct; gmres+mg over {gmres_steps} steps "
          f"{gap_g:.2e} from direct", flush=True)
    print("  the dense solve at the last state, relative residual after 0..8 f64 rounds (the "
          "path runs 4): " + ", ".join(f"{x:.1e}" for x in rounds), flush=True)
    for name, h in last_hist.items():
        print(f"  {name}, the last step's residual norms: " + ", ".join(f"{x:.2e}" for x in h),
              flush=True)
    check(n_dofs == 11222 and n_pts == 8100 or lc != 0.02, f"lc=0.02 cylinder has {n_dofs} dofs")
    # the direct path's f32 LU with 4 f64 rounds leaves a residual that
    # grows with the mesh (its rounds contract by about cond * eps32), so
    # at this size its Newton iteration is inexact and takes more updates;
    # mg solves to 1e-12: one update on every linear step, and never more
    # than one update above direct
    linear = m["iterations"][1:VM_LINEAR_STEPS]
    check(linear == [1] * len(linear), f"mg took {linear} updates on the linear steps")
    check(all(b <= a + 1 for a, b in zip(d["iterations"], m["iterations"])),
          f"mg list {m['iterations']} above direct's {d['iterations']} by more than one")
    check(gap <= 1e-8, f"mg final probe {gap:.3e} from direct")
    check(g["iterations"] == m["iterations"][:gmres_steps] and gap_g <= 1e-8,
          f"gmres+mg {g['iterations']} / {gap_g:.3e} against mg's list and direct's probe")
    report["vm_fine"] = {
        "lc": lc, "dofs": n_dofs, "gauss_points": n_pts,
        **{f"newton_{k}": r["iterations"] for k, r in runs.items()},
        **{f"inner_{k}": r["ksp_iterations"] for k, r in runs.items()},
        **{f"step_s_{k}": r["step_s"] for k, r in runs.items()},
        **{f"peak_bytes_{k}": r["peak_bytes"] for k, r in runs.items()},
        "probe_gap_mg": gap, "probe_gap_gmres_mg": gap_g, "update_layers": layers,
        "dense_round_residuals": rounds, "last_step_history": last_hist}


def icnn_call_times(run, device):
    """The ICNN callback at the run's last state: as the path calls it
    (each batch size's call replayed from a CUDA graph: the copy in, the
    replay and the copy out; CUDA events), the same graph's device time,
    and the eager call (``torch.func``'s launches one by one); the graphed
    and eager results must agree within 1e-13 of the largest entry."""
    from dolfinx_external_operator_torch import evaluate_operands

    (operand,) = run["F_ops"][0].ufl_operands
    Fv = evaluate_operands(run["F_ops"])[operand].reshape(-1, 4).contiguous()
    net = run["icnn"]
    out = {"points": Fv.shape[0]}
    if device != "cuda":
        return out
    dP, P = net.stress_and_tangent(Fv)
    dP_e, P_e = (t.reshape(-1) for t in net._stress_and_tangent(Fv))
    out["graphed_equals_eager"] = bool(torch.equal(dP, dP_e) and torch.equal(P, P_e))
    out["graphed_gap"] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in ((dP, dP_e), (P, P_e)))
    out["call_ms"] = cuda_time_ms(lambda: net.stress_and_tangent(Fv), 20)
    out["eager_ms"] = cuda_time_ms(lambda: net._stress_and_tangent(Fv), 20)
    out["graph_ms"] = graph_time_ms(lambda: net._stress_and_tangent(Fv), 20)
    check(out["graphed_gap"] <= 1e-13, f"the graphed ICNN call is {out['graphed_gap']:.2e} "
          "from the eager one")
    return out


def hyperelasticity_phase(report, lc=0.05, n_steps=100, device="cuda"):
    """Phase 21: ICNN hyperelasticity at the record's size (lc=0.05, 100
    steps to 0.5): the ICNN model and its Isihara twin."""
    from dolfinx_external_operator_torch.models import hyperelasticity as hem

    with open(HYPER_RECORD) as f:
        rec = json.load(f)
    hem.run_comparison(lc=0.3, n_steps=1, max_displacement=0.01, device=device)  # first calls
    sync(device)
    t0 = time.perf_counter()
    out = hem.run_comparison(lc=lc, n_steps=n_steps, max_displacement=0.5, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    nn, tw = out["nn"], out["isihara"]
    n_dofs = nn["V"].num_dofs
    its_nn, its_tw = sum(nn["iterations"]), sum(tw["iterations"])
    times = icnn_call_times(nn, device)
    per_step = {k: sum(r["step_s"]) / n_steps for k, r in (("nn", nn), ("isihara", tw))}
    per_update = sum(nn["step_s"]) / (its_nn + n_steps)  # each step ends on a residual pass
    ms = times.get("call_ms")
    share = None if ms is None else ms * 1e-3 / per_update
    rel = {k: abs(out[k] - rec[k]) / rec[k] for k in ("rel_linf", "l2")}
    print(f"hyperelasticity lc={lc}, {n_steps} steps: {n_dofs} dofs, {times['points']} Gauss "
          f"points; newton NN {its_nn}, Isihara {its_tw} (record {rec['newton_total_nn']}, "
          f"{rec['newton_total_isihara']}); rel_linf {out['rel_linf']!r} (record "
          f"{rec['rel_linf']!r}, off by {rel['rel_linf']:.2e} relative), l2 {out['l2']!r} "
          f"(record {rec['l2']!r}, off by {rel['l2']:.2e}); s/step NN {per_step['nn']:.4f}, "
          f"Isihara {per_step['isihara']:.4f}; {wall:.2f} s in all", flush=True)
    if share is None:
        print(f"  ICNN callback at {times['points']} points: not measured (no card)", flush=True)
    else:
        print(f"  ICNN callback at {times['points']} points: {times['call_ms']:.4f} ms a call as "
              f"the path makes it (replayed from a CUDA graph; the graph's device time "
              f"{times['graph_ms']:.4f} ms), {times['eager_ms']:.4f} ms eager; graphed against "
              f"eager {times['graphed_gap']:.1e} (bitwise: {times['graphed_equals_eager']}); "
              f"{share:.1%} of an NN pass", flush=True)
    for r in (nn, tw):
        check(bool(torch.isfinite(r["u"].data).all()), "bad hyperelasticity u")
    if lc == rec["config"]["lc"] and n_steps == rec["config"]["n_steps"]:
        check(n_dofs == rec["config"]["dofs"], f"{n_dofs} dofs, the record {rec['config']['dofs']}")
        check(its_nn == rec["newton_total_nn"] and its_tw == rec["newton_total_isihara"],
              f"Newton totals {its_nn}, {its_tw} against the record's 200, 200")
        check(max(rel.values()) <= 1e-6, f"errors off the record's: {rel}")
    report["hyperelasticity"] = {
        "lc": lc, "n_steps": n_steps, "dofs": n_dofs, "newton_nn": nn["iterations"],
        "newton_isihara": tw["iterations"], "rel_linf": out["rel_linf"], "l2": out["l2"],
        "rel_to_record": rel, "step_s_nn": nn["step_s"], "step_s_isihara": tw["step_s"],
        "wall_s": wall, "icnn_callback": times, "icnn_share_of_pass": share}


def _membrane_obstacle(n, device, lb):
    """The 12x12 membrane of tests/test_vi_newton.py pushed onto the floor
    ``lb`` (dense solver, vinewtonrsls)."""
    mesh = pt.create_unit_square(n, n)
    V = pt.functionspace(mesh, ("Lagrange", 1))
    u = pt.Function(V, device=device)
    v, du = pt.TestFunction(V), pt.TrialFunction(V)
    dx = pt.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 3})
    F = pt.inner(pt.grad(u), pt.grad(v)) * dx + 10.0 * v * dx
    bdofs = pt.locate_dofs_geometrical(
        V, lambda X: np.isclose(X[0], 0) | np.isclose(X[0], 1) | np.isclose(X[1], 0)
        | np.isclose(X[1], 1))
    return F, u, pt.derivative(F, u, du), bdofs, {}


def _elastic_block_obstacle(n, device, lb):
    """The 10x10 elastic block of tests/test_vi_newton.py on the floor
    ``lb`` (cg + mg, vinewtonrsls)."""
    mesh = pt.create_unit_square(n, n)
    V = pt.functionspace(mesh, ("Lagrange", 1, (2,)))
    u = pt.Function(V, device=device)
    v, du = pt.TestFunction(V), pt.TrialFunction(V)
    dx = pt.Measure("dx", metadata={"quadrature_scheme": "default", "quadrature_degree": 2})

    def e(w):
        return pt.symmetric(pt.grad(w))

    F = (2.0 * pt.inner(e(u), e(v)) + 0.5 * pt.tr(e(u)) * pt.tr(e(v))
         - pt.inner(pt.as_vector([0.0, -1.0]), v)) * dx
    bdofs_s = pt.locate_dofs_geometrical(V, lambda X: np.isclose(X[1], 0))
    bdofs = np.concatenate([bdofs_s * 2, bdofs_s * 2 + 1])
    return F, u, pt.derivative(F, u, du), bdofs, {"ksp_type": "cg", "pc_type": "mg"}


def vi_phase(report, device="cuda"):
    """The bound-constrained Newton (vinewtonrsls) on the card: the 12x12
    membrane obstacle with the dense solver and the elastic block with
    cg + mg, each with the JAX package's Newton count and the KKT
    conditions (feasibility, complementarity, stationarity off the contact
    set within 5e-9)."""
    out = {}
    for name, build, n, lb, expected in (
            ("membrane_12x12_dense", _membrane_obstacle, 12, -0.05, VI_MEMBRANE_NEWTON),
            ("elastic_block_10x10_mg", _elastic_block_obstacle, 10, -0.04, VI_BLOCK_NEWTON)):
        F, u, J, bdofs, opts = build(n, device, lb)
        prob = pt.solvers.NonlinearProblem(
            F, u, J, bcs=[pt.DirichletBC(bdofs, np.zeros(len(bdofs)))],
            petsc_options={"snes_atol": 1e-10, "snes_rtol": 1e-10,
                           "snes_type": "vinewtonrsls", **opts})
        prob.solver.set_variable_bounds(lb, np.inf)
        its, conv = prob.solver.solve(prob)
        x = u.data.cpu().numpy()
        r = prob.F.vector().cpu().numpy()
        free = np.ones(x.size, bool)
        free[bdofs] = False
        on_lb = free & (x <= lb + 1e-12)
        inactive = free & ~on_lb
        stat = float(np.abs(r[inactive]).max())
        comp = float(r[on_lb].min()) if on_lb.any() else None
        print(f"vinewtonrsls {name}: newton {its} (the JAX package's {expected}), converged "
              f"{conv}, {int(on_lb.sum())} dofs on the floor, stationarity {stat:.2e}, "
              f"least multiplier {comp}", flush=True)
        check(conv and its == expected, f"{name}: newton {its}, converged {conv}")
        check(x.min() >= lb - 1e-12 and on_lb.any() and stat < 5e-9 and comp > -5e-9,
              f"{name}: KKT check failed")
        out[name] = {"newton": its, "contact_dofs": int(on_lb.sum()), "stationarity": stat,
                     "least_multiplier": comp}
    report["vi"] = out


def sharded_general_phase(report, ref, n, backend, loads=pt.SLOPE_LOADS):
    """Phases 22 and 23: phase 18's program, the 25x25 slope through the
    general pipeline (``entry.general_slope_schedule``), with every form
    and expression cell-sharded over ``n`` ranks, so each rank's K1 runs on
    its own Gauss points.  One rank must give phase 18's bits; more ranks
    phase 18's Newton list and u within 1e-10 relative, the same u on
    every rank."""
    t0 = time.perf_counter()
    runs = dist.spawn(general_slope_schedule, n, backend, None, 25, loads)
    wall = time.perf_counter() - t0
    label = f"general 25x25, {n} rank(s) over {backend}"
    first, its_ref = runs[0], ref["newton"][:len(loads)]
    u_ref = ref["u"]
    for run in runs:
        check(run["newton"] == its_ref, f"{label}: rank {run['rank']} Newton list {run['newton']}")
        # one K1 launch before the schedule, then one per residual
        check(run["launches"] == run["map_calls"] == run["passes"] + 1,
              f"{label}: rank {run['rank']} K1 launches {run['launches']}")
        check(run["points"] == [3750 // n], f"{label}: K1 saw {run['points']} points")
        check(np.array_equal(run["u"], first["u"]), f"{label}: the ranks' u differ")
    gap = float(np.abs(first["u"] - u_ref).max() / np.abs(u_ref).max())
    if n == 1:
        check(np.array_equal(first["u"], u_ref) and first["launches"] == ref["launches"],
              f"{label}: u {gap:.3e} from phase 18's, K1 launches {first['launches']}")
    else:
        check(gap <= 1e-10, f"{label}: u {gap:.3e} from phase 18's")
    steps = sum(first["step_s"])
    passes = first["passes"]
    print(f"{label}, {len(loads)} steps: newton {sum(first['newton'])} (phase 18's list), K1 "
          f"launches {[r['launches'] for r in runs]} on {first['points']} points each, u "
          f"{gap:.2e} from phase 18's{' (bitwise)' if gap == 0 else ''}; {steps:.2f} s of "
          f"steps ({steps / len(loads):.4f} s/step), {wall:.1f} s with the processes' start; "
          f"per Newton pass {first['gather_calls'] / passes:.2f} all-gathers and "
          f"{first['psum_calls'] / passes:.2f} psums; "
          f"peak memory {first['peak_bytes'] / 2**30:.3f} GiB (rank 0)", flush=True)
    print(f"  collectives of rank 0 (calls; ms per call, host clock): "
          + ", ".join(f"{k}: {first['collectives'][k]}; {first['collective_ms'][k]:.3f}"
                      for k in first["collectives"]), flush=True)
    report[f"general_sharded_{n}_{backend}"] = {
        "ranks": [dict(r, u=None) for r in runs], "u_gap_to_phase18": gap,
        "wall_total_s": wall, "steps": len(loads)}
    return [r["launches"] for r in runs] if n > 1 else first["launches"]


# phase 24: (demo, arguments); the von Mises demo runs on one process and
# on two gloo ranks
DEMOS = [("demo_simple_example.py", []), ("demo_nonlinear_heat.py", []),
         ("demo_plasticity_von_mises.py", ["--small"]),
         ("demo_plasticity_von_mises.py", ["--small", "--ranks", "2"]),
         ("demo_plasticity_mohr_coulomb.py", ["--small"]),
         ("demo_hyperelasticity.py", ["--small"])]


def demos_phase(report):
    """Phase 24: the port's demos (``demos_torch/``) on the card, each in a
    process of its own with ``--no-plot``, all started together (each
    spends most of its time starting up); each holds its own asserts, and
    the von Mises demo's final displacement on two gloo ranks must be
    within 1e-12 relative of one process's."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))

    def run(demo, args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.join(root, "demos_torch", demo), *args,
                            "--no-plot"], capture_output=True, text=True, timeout=600,
                           env=env, cwd=root)
        return r, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(DEMOS)) as ex:
        done = [ex.submit(run, demo, args) for demo, args in DEMOS]
        results = [f.result() for f in done]
    total = time.perf_counter() - t0
    out, finals = [], {}
    for (demo, args), (r, wall) in zip(DEMOS, results):
        tail = (r.stdout + r.stderr)[-1500:]
        check(r.returncode == 0, f"{demo} {args} exited {r.returncode}: {tail}")
        lines = r.stdout.strip().splitlines()
        for line in lines:
            if line.startswith("final_displacement="):
                finals[" ".join(args)] = float(line.split("=", 1)[1])
        print(f"{demo} {' '.join(args)}: {wall:.1f} s, {lines[-1]}", flush=True)
        out.append({"demo": demo, "args": args, "wall_s": wall, "last_lines": lines[-4:]})
    one, two = finals["--small"], finals["--small --ranks 2"]
    gap = abs(one - two) / abs(one)
    check(gap <= 1e-12, f"von Mises demo on 2 ranks {two!r} against one process's {one!r}")
    print(f"von Mises demo final displacement: one process {one!r}, 2 gloo ranks {two!r} "
          f"({gap:.2e} relative); the {len(DEMOS)} runs together {total:.1f} s", flush=True)
    report["demos"] = {"runs": out, "von_mises_final": finals, "von_mises_rank_gap": gap,
                       "wall_total_s": total}


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
    report["ptxas"] = {}
    for tag, log in native.BUILD_LOG.items():
        usage = ptxas_usage(log)
        report["ptxas"][tag] = usage
        for fn, u in usage.items():
            print(f"{tag} {fn}: {u.get('registers')} registers, {u.get('spill_stores')} B spill "
                  f"stores, {u.get('spill_loads')} B spill loads, {u.get('stack')} B stack",
                  flush=True)

    n_main = 3750 + (-3750 % 512)  # the main path's 3,750 points padded to the tile
    shapes = [kernel_phase(n) for n in (3750, n_main, 65536)]
    for s in shapes:
        print(f"vonmises n={s['n']}: rel err {s['max_rel_err']:.2e}, dp err "
              f"{s['abs_err_dp']:.2e}, kernel {s['ms'] * 1e3:.2f} us in a graph, "
              f"{s['call_ms'] * 1e3:.2f} us a call, plain "
              f"{s['plain_ms'] * 1e3:.2f} us, bound {s['bound_ms'] * 1e3:.3f} us", flush=True)
    report["vonmises_shapes"] = shapes
    floor_ms = empty_graph_ms()
    print(f"empty kernel in a graph: {floor_ms * 1e3:.2f} us (von Mises kernel at n={n_main}: "
          f"{shapes[1]['ms'] * 1e3:.2f} us)", flush=True)
    report["empty_graph_ms"] = floor_ms

    # phase 4: the main path; counts start at 0 here and are read after it
    fp64 = pt.von_mises_block_step(25, 25, "f64", linear_solver="dense")
    fp32 = pt.von_mises_block_step(25, 25, "f32", linear_solver="dense", **F32_TOLS)
    check((fp64.n_dofs, fp64.nc * fp64.nq) == (5202, 3750), "wrong block size")
    warm_up(fp64, MAIN_LOADS[0])
    warm_up(fp32, MAIN_LOADS[0])
    vm_ops.vonmises_return_map.launches = 0
    Du64, its64, _, wall64, _ = run_loads(fp64, MAIN_LOADS)
    check(vm_ops.vonmises_return_map.launches == 0, "f64 path launched the f32 kernel")
    Du32, its32, _, wall32, _ = run_loads(fp32, MAIN_LOADS)
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
    _, itscg, cgs, wallcg, _ = run_loads(fpcg, MAIN_LOADS)
    print(f"8x8 cg f64: newton {itscg}, cg {cgs}, s/step {[round(w, 4) for w in wallcg]}",
          flush=True)
    check(itscg == [1, 5, 7], f"cg Newton list {itscg} != [1, 5, 7]")
    report["cg_8x8"] = {"newton": itscg, "cg": cgs, "wall_s": wallcg}

    # phases 6-8: the Mohr-Coulomb main path, its kernel, its layers
    mat = pt.MohrCoulombMaterial()
    fp_k, states, mc_launches = mc_main_path(report)
    mc_shapes = [mc_kernel_phase(mat, *kernel_inputs(fp_k, *states[49]), "step 50 iterate"),
                 mc_kernel_phase(mat, *bench_mix(65536), "bench mix")]
    for s in mc_shapes:
        print(f"mohr_coulomb {s['label']} n={s['n']}: rel err C {s['rel_err_C']:.2e} "
              f"({s['lanes_C_above_1e-10']} lanes > 1e-10), sigma {s['rel_err_sig']:.2e}, "
              f"niter differs on {s['niter_diff_lanes']} lanes (max {s['niter_max']}, "
              f"{s['plastic_lanes']} plastic, {s['iterating_lanes']} iterate, "
              f"{s['listed_lanes']} listed for pass B); kernel "
              f"{s['ms'] * 1e3:.2f} us in a graph (traced: pass A {s['pass_a_ms'] * 1e3:.2f}, "
              f"pass B {s['pass_b_ms'] * 1e3:.2f}), {s['call_ms'] * 1e3:.2f} us a call, plain "
              f"{s['plain_ms']:.2f} ms, bound {s['bound_ms'] * 1e3:.3f} us ({s['bound_by']})",
              flush=True)
        print(f"  niter of the listed lanes {s['niter_hist']}, {s['warp_groups']} warp groups, "
              f"lockstep share {s['lockstep_share']}", flush=True)
    report["mc_shapes"] = mc_shapes
    Du, sig = states[49]
    report["mc_layers"] = layer_phase(fp_k, Du, sig, pt.SLOPE_LOADS[49])
    print("25x25 slope layers, step 50 (ms): "
          + ", ".join(f"{k[:-3]} {v:.3f}" for k, v in report["mc_layers"].items()), flush=True)
    Du, sig = states[50]
    prof = profile_step(fp_k, Du, sig, pt.SLOPE_LOADS[50],
                        os.path.join(OUT_DIR, "trace_mc_step.json"))
    idle = "not measured" if prof["idle_share"] is None else f"{prof['idle_share']:.1%}"
    print(f"25x25 slope step 51 under the profiler: wall {prof['wall_ms']:.2f} ms, device "
          f"busy {prof['device_busy_ms']:.2f} ms (idle {idle}), "
          f"{prof['device_events']} device events", flush=True)
    for name, t in prof["top_ms"][:8]:
        print(f"  {t:9.3f} ms  {name}", flush=True)
    report["profile_mc_step"] = prof

    # phases 9-10: the BCR solver at 25x25 and at 100x100
    bcr_launches = bcr_25x25_phase(report, fp_k, states[49])
    launches_100 = bcr_100x100_phase(report, mat)
    # phases 11-13: AMG-CG at 25x25 (entry()'s program), the lagged-elastic
    # solver at 25x25, AMG-CG at 100x100
    mg_launches, mg_ref = mg_25x25_phase(report, fp_k, states[49])
    elastic_launches = elastic_25x25_phase(report)
    mg_launches_100 = mg_100x100_phase(report)
    # phases 14-17: cell sharding, one process per rank
    sharded = {"slope_25x25_mg_1rank_nccl_10steps": sharded_one_rank_phase(report, mg_ref),
               "slope_25x25_mg_2ranks_gloo_per_rank": sharded_schedule_phase(report, mg_ref, 2,
                                                                             "gloo"),
               "dryrun_16x16_mg_2ranks_gloo": dryrun_phase(report, 2, "gloo")}
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(cards, 4)
        sharded[f"slope_25x25_mg_{n}ranks_nccl_per_rank"] = sharded_schedule_phase(
            report, mg_ref, n, "nccl")
        sharded[f"dryrun_16x16_mg_{n}ranks_nccl"] = dryrun_phase(report, n, "nccl")
    else:
        print(f"multi-card NCCL not run: {cards} card", flush=True)
    report["multi_card_nccl_run"] = cards >= 2
    # phase 18: the same slope through the general external-operator pipeline
    general_launches, general_ref = general_slope_phase(report, states["u"],
                                                        sum(report["mc_main"]["wall_kernel_s"]))
    # phases 19-21: the reference's other demos through the general
    # pipeline and its Krylov, AMG and bound-constrained solvers
    vm_cylinder_phase(report)
    vm_fine_phase(report)
    hyperelasticity_phase(report)
    vi_phase(report)
    # phases 22-23: phase 18's slope with the general pipeline cell-sharded,
    # one NCCL rank and two gloo ranks on the card; K1 over a rank's half
    # of step 50's iterate
    sharded["slope_25x25_general_1rank_nccl"] = sharded_general_phase(
        report, general_ref, 1, "nccl")
    sharded["slope_25x25_general_2ranks_gloo_per_rank"] = sharded_general_phase(
        report, general_ref, 2, "gloo")
    deps, sn = kernel_inputs(fp_k, *states[49])
    half = deps.shape[1] // 2
    k1_half = mc_kernel_phase(mat, deps[:, :half].contiguous(), sn[:, :half].contiguous(),
                              "rank half of step 50 iterate")
    print(f"mohr_coulomb on a rank's half of step 50's iterate, n={k1_half['n']}: kernel "
          f"{k1_half['ms'] * 1e3:.2f} us in a graph (pass A {k1_half['pass_a_ms'] * 1e3:.2f}, "
          f"pass B {k1_half['pass_b_ms'] * 1e3:.2f}), {k1_half['call_ms'] * 1e3:.2f} us a call, "
          f"plain {k1_half['plain_ms']:.2f} ms, bound {k1_half['bound_ms'] * 1e3:.3f} us; the "
          f"whole iterate {mc_shapes[0]['ms'] * 1e3:.2f} us", flush=True)
    report["mc_half_shape"] = k1_half
    # phase 24: the port's five demos on the card
    demos_phase(report)

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
        "empty_graph_ms": floor_ms,
    }, {
        "name": "mc_return_map",
        "route": "cuda",
        "source": "dolfinx_external_operator_torch/csrc/mohr_coulomb.cu",
        "replaces": "dolfinx_external_operator_tpu/models/mohr_coulomb.py:224",
        "launches": mc_launches,
        "launches_by_path": {"slope_25x25_dense": mc_launches, "slope_25x25_bcr": bcr_launches,
                             "slope_100x100_bcr": launches_100, "slope_25x25_mg": mg_launches,
                             "slope_25x25_elastic": elastic_launches,
                             "slope_100x100_mg": mg_launches_100,
                             "slope_25x25_general": general_launches, **sharded},
        "max_abs_err": mc_shapes[0]["max_abs_err"],
        "max_rel_err": max(max(s["rel_err_C"], s["rel_err_sig"]) for s in mc_shapes),
        "ms": mc_shapes[0]["ms"],
        "kernel_ms": mc_shapes[0]["ms"],
        "pass_a_ms": mc_shapes[0]["pass_a_ms"],
        "pass_b_ms": mc_shapes[0]["pass_b_ms"],
        "call_ms": mc_shapes[0]["call_ms"],
        "plain_ms": mc_shapes[0]["plain_ms"],
        "bound_ms": mc_shapes[0]["bound_ms"],
        "bound_by": mc_shapes[0]["bound_by"],
        "library_ms": None,
        "n": mc_shapes[0]["n"],
        "rank_half": {k: k1_half[k] for k in ("n", "ms", "call_ms", "pass_a_ms", "pass_b_ms",
                                              "plain_ms", "bound_ms", "max_abs_err")},
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
    finally:
        stop_children()
    sys.exit(code)

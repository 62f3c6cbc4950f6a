"""The Mohr-Coulomb kernel K1 of this checkout against another checkout's,
on one NVIDIA GPU, each built from its own sources:

    python3 -m dolfinx_external_operator_torch.tools.k1_compare OTHER [--fmad false]

``OTHER`` is a directory that holds ``dolfinx_external_operator_torch/csrc``
of the other commit, for example from ``git archive <commit>
dolfinx_external_operator_torch/csrc | tar -x -C OTHER``.  Each launcher's
interface is read from its source: the one-pass launcher (6 output
buffers, n, params, stream) or the two-pass one (a workspace before n).  A
launcher with any other interface is refused, never called.

On each input, both kernels against the plain f64 map (the largest
per-lane gap of C and sigma relative to the largest entry, and the lanes
whose ``niter`` differs), the two kernels against each other (the same,
and whether every output is bitwise equal), and each kernel's device time
in a CUDA graph, timed in turns (other, this, this, other).  ``--fmad
false`` builds both without FMA contraction: two kernels that do the same
arithmetic, operation for operation, then give the same bits.

The inputs: the real iterate of step 50's first Newton pass on the 25x25
slope (the main path of ``chip_smoke.py``); the strain mix of
``bench.py:77-83`` at 65,536 points; and heavily plastic inputs, the mix
with every point sheared by a further 1.2e-2 (as the all-plastic case of
``tests/test_torch_mohr_coulomb.py``, seed 6) at 256 and 65,536 points,
and the plastic lanes of the mix at 3,750 points (seed 0, as
``tests/test_torch_cuda.py``).  One JSON line per input; all of them go to
``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import problems
from .._native import cuda as native
from ..models.mohr_coulomb import MohrCoulombMaterial
from ..ops import mohr_coulomb as mc_ops

_OUTS = ["C", "sig", "niter", "yielding", "norm_res", "dlambda"]
INTERFACES = {
    "one pass": ["deps", "sig_n", *_OUTS, "n", "params", "stream"],
    "two passes": ["deps", "sig_n", *_OUTS, "work", "n", "params", "stream"],
}


class Kernel:
    """A K1 launcher built from the sources in ``csrc``."""

    def __init__(self, csrc, extra_flags, tag):
        with open(os.path.join(csrc, "mohr_coulomb.cu")) as f:
            m = re.search(r'extern "C" int mohr_coulomb_launch\(([^)]*)\)', f.read())
        if m is None:
            raise RuntimeError(f"no mohr_coulomb_launch in {csrc}")
        self.names = [re.findall(r"\w+", p)[-1] for p in m.group(1).split(",")]
        self.interface = next((k for k, v in INTERFACES.items() if v == self.names), None)
        if self.interface is None:
            raise RuntimeError(f"unknown launcher interface in {csrc}: {self.names}")
        flags = native.NVCC_FLAGS + extra_flags
        digest = hashlib.sha256(" ".join(flags).encode())
        for name in sorted(os.listdir(csrc)):
            if name.startswith("mohr_coulomb") and name.endswith((".cu", ".cuh")):
                with open(os.path.join(csrc, name), "rb") as f:
                    digest.update(f.read())
        path = os.path.join(native.BUILD_DIR, f"lib{tag}_{digest.hexdigest()[:16]}.so")
        if not os.path.exists(path):
            os.makedirs(native.BUILD_DIR, exist_ok=True)
            cmd = [native.find_nvcc(), *flags, "-o", path, os.path.join(csrc, "mohr_coulomb.cu")]
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if res.returncode != 0:
                raise RuntimeError(f"build failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        self.fn = native._bind(path, "mohr_coulomb_launch",
                               [native._LL if a == "n" else native._VP for a in self.names],
                               ctypes.c_int)

    def __call__(self, deps, sig_n, params, outs, work):
        ptrs = dict(zip(_OUTS, (t.data_ptr() for t in outs)), deps=deps.data_ptr(),
                    sig_n=sig_n.data_ptr(), work=work.data_ptr(), n=deps.shape[1],
                    params=ctypes.cast(params, ctypes.c_void_p),
                    stream=torch.cuda.current_stream().cuda_stream)
        err = self.fn(*(ptrs[a] for a in self.names))
        if err != 0:
            raise RuntimeError(f"K1 launch failed: cudaError {err}")


def graph_time_ms(fn, reps=20):
    """Device time per call: ``reps`` calls in one CUDA graph, replayed
    between events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gaps(outs, ref_C, ref_sig, ref_niter):
    """Largest per-lane gap of C and sigma relative to the largest entry of
    the reference, and the lanes whose iteration count differs."""
    C, sig, niter = outs[0], outs[1], outs[2]
    return {"rel_gap_C": float(((C - ref_C).abs().amax(0) / ref_C.abs().max()).max()),
            "rel_gap_sig": float(((sig - ref_sig).abs().amax(0) / ref_sig.abs().max()).max()),
            "niter_diff_lanes": int((niter != ref_niter).sum())}


def bench_mix(n, seed, shear=0.0):
    """bench.py:77-83, every point sheared by a further ``shear``."""
    rng = np.random.default_rng(seed)
    deps = rng.normal(scale=1e-3, size=(n, 4))
    deps[:, :3] -= 1.5e-3
    deps[: n // 2, 3] += 6e-3
    deps[:, 3] += shear
    return deps


def step50_iterate():
    """The (deps, sigma_n) that the slope step's return map receives in the
    first Newton pass of step 50 of the schedule, with K1."""
    fp = problems.mohr_coulomb_slope_step(25, 25, route="cuda")
    Du, sig = fp.zero_state()
    for load in problems.SLOPE_LOADS[:49]:
        Du, sig, *_ = fp.run_step(Du, sig, load)
    seen, inner = [], fp._vkernel

    def record(deps, sn):
        seen.append((deps.contiguous(), sn.contiguous()))
        return inner(deps, sn)

    fp._vkernel = record
    try:
        fp._constitutive(Du, sig)
    finally:
        fp._vkernel = inner
    return seen[0]


def inputs(mat):
    dev = torch.device("cuda")

    def soa(deps):
        d = torch.tensor(np.ascontiguousarray(deps.T), dtype=torch.float64, device=dev)
        return d, torch.zeros_like(d)

    mix = bench_mix(3750, 0)
    plastic = mat.f_yield(torch.tensor(mix @ mat.C_elas.T).T).numpy() > 0.0
    return {"step 50 iterate": step50_iterate(),
            "bench mix 65536": soa(bench_mix(65536, 0)),
            "all plastic 256": soa(bench_mix(256, 6, 1.2e-2)),
            "all plastic 65536": soa(bench_mix(65536, 6, 1.2e-2)),
            "plastic lanes of the mix at 3750": soa(mix[plastic])}


def compare(kernels, mat, label, deps, sn):
    n = deps.shape[1]
    params = mc_ops._params(mat)
    C_p, (s_p, it_p, *_) = mat.tangent_stress(deps, sn)
    C_p = C_p.reshape(16, n)
    outs = {}
    for who, k in kernels.items():
        outs[who] = mc_ops._outputs(n, deps.device)
        k(deps, sn, params, outs[who], mc_ops._workspace(n, deps.device))
    torch.cuda.synchronize()
    row = {"input": label, "n": n, "plastic_lanes": int((outs["this"][3] > 0).sum())}
    for who, o in outs.items():
        row[who] = gaps(o, C_p, s_p, it_p)
    o, p = outs["this"], outs["other"]
    row["this_vs_other"] = {**gaps(o, p[0], p[1], p[2]),
                            "bitwise_equal": all(torch.equal(a, b) for a, b in zip(o, p))}
    turns = []
    for who in ("other", "this", "this", "other"):
        work = mc_ops._workspace(n, deps.device)
        turns.append([who, graph_time_ms(
            lambda k=kernels[who], w=work: k(deps, sn, params, outs[who], w))])
    row["graph_ms_in_turns"] = turns
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="a directory holding the other commit's "
                                  "dolfinx_external_operator_torch/csrc")
    ap.add_argument("--fmad", choices=("true", "false"), default="true",
                    help="nvcc's FMA contraction, for both kernels")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "k1_compare.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    extra = [f"-fmad={args.fmad}"]
    srcs = {"other": os.path.join(args.other, "dolfinx_external_operator_torch", "csrc"),
            "this": native.CSRC_DIR}
    with ThreadPoolExecutor(max_workers=2) as ex:
        futures = {who: ex.submit(Kernel, src, extra, f"k1_{who}_fmad_{args.fmad}")
                   for who, src in srcs.items()}
        kernels = {who: f.result() for who, f in futures.items()}
    print(json.dumps({who: k.interface for who, k in kernels.items()}), flush=True)
    mat = MohrCoulombMaterial()
    rows = []
    for label, (deps, sn) in inputs(mat).items():
        rows.append(compare(kernels, mat, label, deps, sn))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "fmad": args.fmad, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

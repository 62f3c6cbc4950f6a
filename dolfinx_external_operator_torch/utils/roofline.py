"""Roofline accounting on an NVIDIA H100: the card's peaks, the work of each
hot function, and the least time the card could take for it.

The port of ``dolfinx_external_operator_tpu/utils/roofline.py``, whose
peaks are a TPU v5e's.  Here:

- **Peaks** of the H100 SXM (NVIDIA's data sheet): HBM 3.35 TB/s, f32 67
  and f64 34 TFLOP/s outside the tensor cores, the units these kernels
  run on.  ``card_line`` gives the card a measurement ran on, with its
  power limit: a card set below 700 W runs slower under load, so every
  measured entry carries it.
- **Work** is counted from the inputs and the algorithm, never from the
  implementation, so that a hand kernel, a library call and the plain
  version are held to the same bound: bytes that the function must move
  (each input read once, each output written once) and the operations it
  does on these inputs (where a loop ends early, the iterations this data
  needs).  ``bound`` turns them into milliseconds: the larger of the bytes
  over the HBM rate and the operations over the peak for their type.
- **The return map's MFU** (``return_map_flops_per_pt``,
  ``return_map_mfu``) and **the level-0 DIA matvec's roofline**
  (``dia_counts``, ``dia_roofline_from_fp``), with the JAX module's
  signatures and entry layouts.

Counts for the von Mises kernel K2 (both entries), the Mohr-Coulomb kernel
K1, the element chain's kernels E1-E4, BCR and AMG-CG are the hand counts
that ``chip_smoke.py`` reports against.  Nothing here imports JAX.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["H100_HBM_BYTES_PER_S", "H100_F32_FLOPS_PER_S", "H100_F64_FLOPS_PER_S",
           "VM_FLOPS_PER_POINT", "VM_BYTES_PER_POINT", "VM_F64_BYTES_PER_POINT",
           "MC_BYTES_PER_POINT", "MC_ITER_OPS", "MC_FIXED_F32_OPS", "MC_FIXED_F64_OPS",
           "card_line", "bound", "vm_bound", "mc_ops", "mc_bound", "bcr_counts", "mg_counts",
           "return_map_flops_per_pt", "return_map_flops_per_pt_hi", "return_map_mfu",
           "dia_counts", "dia_roofline_from_fp", "element_chain_counts", "element_chain_bound"]

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, f32 and f64
# outside the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS_PER_S = 67e12
H100_F64_FLOPS_PER_S = 34e12

# The von Mises map K2 (csrc/vonmises.cuh), f32 operations per point:
# predictor 16, deviator 6, sigma_eq 9, yield and dp 6, beta/scale/n 8,
# stress 8, coef 5, tangent 16 x 5
VM_FLOPS_PER_POINT = 138
# its f32 entry: deps, sig_n (4 + 4) and p read, C, sig (16 + 4) and dp
# written, f32
VM_BYTES_PER_POINT = (4 + 4 + 1) * 4 + (16 + 4 + 1) * 4
# its f64 entry without p or dp: deps, sig_n read, C and sig written, f64
VM_F64_BYTES_PER_POINT = (4 + 4) * 8 + (16 + 4) * 8

# The Mohr-Coulomb map K1: read deps, sig_n (8 f64); written C (16), sig
# (4), yielding, norm_res, dlambda (f64) and niter (int32)
MC_BYTES_PER_POINT = 8 * 8 + (16 + 4 + 3) * 8 + 4
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


def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    first card).  Raises where nvidia-smi fails."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def bound(ops, nbytes, flops_per_s=H100_F32_FLOPS_PER_S):
    """``(ms, "bytes" | "operations")``: the least time for ``nbytes`` over
    the HBM rate and ``ops`` over ``flops_per_s``, whichever is larger, and
    which one that is."""
    t_ops, t_bytes = ops / flops_per_s * 1e3, nbytes / H100_HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def vm_bound(n, bytes_per_point=VM_BYTES_PER_POINT):
    """K2's bound on ``n`` points (the f32 entry's bytes unless given)."""
    return bound(VM_FLOPS_PER_POINT * n, bytes_per_point * n)


def _counts(niter):
    """Per-lane counts as a numpy array, from a tensor on any device."""
    return np.asarray(niter.cpu() if isinstance(niter, torch.Tensor) else niter)


def mc_ops(niter):
    """(f32, f64) operations of the Mohr-Coulomb map on lanes that take
    ``niter`` Newton iterations (both phases, per lane)."""
    niter = _counts(niter)
    n = niter.size
    return MC_FIXED_F32_OPS * n + MC_ITER_OPS * int(niter.sum()), MC_FIXED_F64_OPS * n


def mc_bound(niter):
    """(bound_ms, bound_by) of the Mohr-Coulomb map on lanes that take
    ``niter`` Newton iterations: bytes read and written once over HBM, or
    the operations these lanes need over the f32 and f64 peaks, whichever
    is larger."""
    n = _counts(niter).size
    f32_ops, f64_ops = mc_ops(niter)
    t_bytes = MC_BYTES_PER_POINT * n / H100_HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / H100_F32_FLOPS_PER_S + f64_ops / H100_F64_FLOPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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


def element_chain_counts(kernel, nc, nq, ni, nk, n, mode="matvec", itemsize=8, keep=False,
                         bs=2):
    """(operations, bytes) of one call of an element-chain kernel
    (``ops/element_chain.py``) on ``nc`` cells of ``nq`` Gauss points, ``ni``
    strain components and ``nk`` dofs, against a vector of ``n``: each
    input read once and each output written once (B (nc, nq, ni, nk), w
    (nc, nq), the dofmap (nc, nk) int64, sigma (nc, nq, ni), the tangent
    (nc, nq, ni, ni) in f64; E4's blocks, x and y in ``itemsize`` bytes,
    its node index (nc, nk / bs)), and the operations of the contraction
    done once (a multiply and an add for each term):

    * ``"cell_strain"`` (E1): ``2 nq ni nk`` a cell;
    * ``"cell_residual"`` (E2): ``2 nq nk (ni + 1)``;
    * ``"cell_tangent"`` (E3): ``mode`` ``"matvec"`` B x, C de and B^T
      dsig, ``2 nq (2 ni nk + ni^2 + nk)``; ``"diag"`` C B and its
      diagonal against B, ``2 nq nk (ni^2 + ni + 1)``; ``"blocks"`` C B
      and B^T (C B), ``2 nq nk (ni^2 + ni nk + nk)``, with ``itemsize``
      bytes an output and, with ``keep``, the mask read and applied;
    * ``"ebe_matvec"`` (E4): ``2 nk^2``;
    * ``"cell_product"`` (E5), the arguments read as a product's: ``nc``
      outputs, each a sum of ``nq`` terms, from ``n`` distinct operand
      elements (a broadcast table counted once), ``itemsize`` bytes each:
      ``2 nq`` an output (``ni``, ``nk`` unused); ``mode`` ``"triple"``:
      ``W^T K W`` on ``nc`` cells, W (nk, ni) and K (nk, nk) read, the
      (ni, ni) block written, ``2 (ni nk^2 + ni^2 nk)`` a cell."""
    B, w, dof, C = nc * nq * ni * nk * 8, nc * nq * 8, nc * nk * 8, nc * nq * ni * ni * 8
    if kernel == "cell_strain":
        return 2 * nc * nq * ni * nk, B + dof + 8 * n + nc * nq * ni * 8
    if kernel == "cell_residual":
        return 2 * nc * nq * nk * (ni + 1), B + nc * nq * ni * 8 + w + nc * nk * 8
    if kernel == "cell_tangent":
        if mode == "matvec":
            return (2 * nc * nq * (2 * ni * nk + ni * ni + nk),
                    B + C + w + dof + 8 * n + nc * nk * 8)
        if mode == "diag":
            return 2 * nc * nq * nk * (ni * ni + ni + 1), B + C + w + nc * nk * 8
        if mode == "blocks":
            ops = 2 * nc * nq * nk * (ni * ni + ni * nk + nk) + (2 * nc * nk * nk if keep else 0)
            return ops, B + C + w + (nc * nk * 8 if keep else 0) + nc * nk * nk * itemsize
        raise ValueError(f"unknown cell_tangent mode {mode!r}")
    if kernel == "cell_product":
        if mode == "triple":
            return (2 * nc * (ni * nk * nk + ni * ni * nk),
                    itemsize * nc * (nk * ni + nk * nk + ni * ni))
        return 2 * nc * nq, itemsize * (n + nc)
    if kernel == "ebe_matvec":
        return (2 * nc * nk * nk,
                itemsize * (nc * nk * nk + n + nc * nk) + 8 * nc * (nk // bs))
    raise ValueError(f"unknown element-chain kernel {kernel!r}")


def element_chain_bound(kernel, nc, nq, ni, nk, n, mode="matvec", itemsize=8, keep=False, bs=2):
    """(bound_ms, bound_by) of ``element_chain_counts``' call: its bytes
    over HBM, or its operations over the f64 peak (the f32 peak for
    ``itemsize`` 4), whichever is larger."""
    ops, nbytes = element_chain_counts(kernel, nc, nq, ni, nk, n, mode, itemsize, keep, bs)
    return bound(ops, nbytes, H100_F32_FLOPS_PER_S if itemsize == 4 else H100_F64_FLOPS_PER_S)


def return_map_flops_per_pt(mat, deps, sigma_n, niter=None):
    """Operations per Gauss point of the Mohr-Coulomb return map with its
    consistent tangent on these inputs: the fixed part of every point plus
    ``MC_ITER_OPS`` for each Newton iteration its lane takes, over n.

    The counterpart of the JAX function, which takes XLA's cost analysis
    of the compiled ``while_loop``: a static bracket that counts the body
    once (lo) or up to the trip bound (hi, ``return_map_flops_per_pt_hi``)
    and depends on how the program was compiled.  This count depends only
    on the algorithm and on the iterations these inputs need: ``niter``
    (one count per lane, from any implementation: the JAX map, the plain
    map, K1), or by default the port's plain map
    (``mat.tangent_stress``) on ``deps``, ``sigma_n`` (4, n) f64."""
    if niter is None:
        niter = mat.tangent_stress(deps, sigma_n)[1][1]
    f32_ops, f64_ops = mc_ops(niter)
    return (f32_ops + f64_ops) / deps.shape[-1]


def return_map_flops_per_pt_hi(mat):
    """Operations per point where every lane runs both phases to their caps
    (``max_iter32_eff`` f32 and ``n_polish_max`` f64 iterations): the trip
    bound, the counterpart of the JAX module's ``flops_hi``."""
    it = mat.max_iter32_eff + mat.n_polish_max
    f32_ops, f64_ops = mc_ops(np.array([it]))
    return float(f32_ops + f64_ops)


def return_map_mfu(pts_per_s, flops_lo, flops_hi, card=None):
    """MFU entry for the return map against the H100's f32 peak (CUDA
    cores), with the JAX entry's layout and ranges.  ``flops_lo``: the
    operations per point that the measured inputs need
    (``return_map_flops_per_pt``); ``flops_hi``: at the trip bound
    (``return_map_flops_per_pt_hi``).  Trig calls count as one operation
    each, so the share of the peak is a floor.  ``card``, where given, is
    kept in the entry (``card_line``).

    Keys renamed from the JAX entry, for the same quantities:
    ``flops_per_pt_xla_lo_hi`` -> ``flops_per_pt_lo_hi`` (counted, not
    XLA's), ``vpu_f32_peak_gflops`` -> ``h100_f32_peak_gflops``,
    ``pct_vpu_peak_lo_hi`` -> ``pct_h100_f32_peak_lo_hi``."""
    peak = H100_F32_FLOPS_PER_S / 1e9
    lo = pts_per_s * flops_lo / 1e9
    hi = pts_per_s * flops_hi / 1e9
    entry = {
        "pts_per_s": pts_per_s,
        "flops_per_pt_lo_hi": [flops_lo, flops_hi],
        "achieved_gflops_lo_hi": [lo, hi],
        "h100_f32_peak_gflops": peak,
        "pct_h100_f32_peak_lo_hi": [100 * lo / peak, 100 * hi / peak],
        "note": ("lo = the operations these inputs need (MC_ITER_OPS per Newton iteration "
                 "taken); hi = every lane at both phases' caps; trig calls count as one "
                 "operation each, so %peak is a floor"),
    }
    if card is not None:
        entry["card"] = card
    return entry


def dia_counts(fp):
    """The level-0 DIA matvec of a ``FusedPlasticityStep`` built with
    ``linear_solver="mg"`` in dia mode (``parallel/mg.py::_dia_matvec`` on
    ``plan["dia0"]``): rows, bands, and per matvec its bytes (the bands, x
    read once and y written once, f32) and operations (a multiply-add per
    band value).  None where the step has no banded level 0."""
    plan = getattr(fp, "_mg", None)
    if plan is None or "dia0" not in plan:
        return None
    n0, nb = int(plan["n0"]), int(plan["dia0"]["nb"])
    return {"n_rows": n0, "n_bands": nb, "bytes_per_matvec": 4 * (nb * n0 + 2 * n0),
            "flops_per_matvec": 2 * nb * n0}


def dia_roofline_from_fp(fp, reps=10, chain=100):
    """Roofline entry for the level-0 DIA matvec of an already-built
    ``FusedPlasticityStep(linear_solver="mg")`` on a lattice mesh, on the
    card it lives on.

    Times (a) one matvec per dispatch (eager, CUDA events around ``reps``
    calls) and (b) ``chain`` dependent matvecs captured in one CUDA graph
    and replayed, the counterpart of the JAX ``fori_loop`` in one dispatch:
    the difference is the host's launch cost.  Band values are random
    (scaled so a chain neither overflows nor underflows); the matvec's cost
    depends only on the band structure.  Raises where the step does not
    lie on a CUDA device: a measurement finds a card or fails."""
    from ..parallel.mg import _dia_matvec

    counts = dia_counts(fp)
    if counts is None:
        return {"error": "mesh not lattice-structured; no DIA operator"}
    if fp.device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"dia_roofline_from_fp times on a CUDA device; the step lies on "
                           f"{fp.device}")
    plan = fp._mg
    band, free = plan["dia0"], plan["dia0"]["free"]
    n0, nb = counts["n_rows"], counts["n_bands"]
    rng = np.random.default_rng(0)
    bands = torch.tensor(rng.normal(size=(nb, n0)).astype(np.float32) / (2.0 * nb),
                         device=fp.device)
    xs = [torch.tensor(rng.normal(size=n0).astype(np.float32), device=fp.device)
          for _ in range(reps)]

    def mv(x):
        return _dia_matvec(bands, band, free, x)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for x in xs[:2]:
        mv(x)
    torch.cuda.synchronize()
    start.record()
    for x in xs:
        mv(x)
    end.record()
    torch.cuda.synchronize()
    t_single = start.elapsed_time(end) * 1e-3 / reps

    x = xs[0].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v = x
        for _ in range(chain):
            v = mv(v)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    t_chain = start.elapsed_time(end) * 1e-3 / (reps * chain)

    mbytes, flops = counts["bytes_per_matvec"], counts["flops_per_matvec"]
    peak_gbps = H100_HBM_BYTES_PER_S / 1e9
    return {
        "n_rows": n0, "n_bands": nb,
        "single_dispatch_ms": t_single * 1e3,
        "chained_per_matvec_us": t_chain * 1e6,
        "dispatch_overhead_ms": (t_single - t_chain) * 1e3,
        "bytes_per_matvec": mbytes,
        "achieved_gbps_chained": mbytes / t_chain / 1e9,
        "hbm_peak_gbps": peak_gbps,
        "pct_hbm_peak_chained": 100 * mbytes / t_chain / 1e9 / peak_gbps,
        "achieved_gflops_chained": flops / t_chain / 1e9,
        "bound_us": bound(flops, mbytes)[0] * 1e3,
        "card": card_line(),
    }

"""Mohr-Coulomb return map with consistent tangent (f64, SoA layout).

The wrapper of the hand-written kernel K1 (``csrc/mohr_coulomb.cu``, body
``csrc/mohr_coulomb.cuh``), which replaces the per-Gauss-point return map
that the JAX package compiles with XLA (``models/mohr_coulomb.py:224-361``
with ``ops/abbo_sloan.py:118-166``).  On a CUDA tensor ``mc_return_map``
launches the kernel's two passes: pass A, one thread per Gauss point,
finishes the elastic points and lists the plastic ones; pass B runs each
plastic point on a tile of 8 threads.  On a CPU tensor it runs the plain
PyTorch version, ``MohrCoulombMaterial.tangent_stress``.  There is no
fallback from the kernel to the plain version: a failed build or launch
raises.

Bound on an H100: 252 bytes per point (64 read, 188 written) over
3.35 TB/s is 0.28 us at the main path's 3,750 points; the f32 and f64
arithmetic of the Newton loops lies far above that, so operations bound it.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["mc_return_map", "mc_return_map_host", "BYTES_PER_POINT"]

# read: deps, sig_n (8 f64); written: C (16), sig (4), yielding, norm_res,
# dlambda (f64) and niter (int32)
BYTES_PER_POINT = 8 * 8 + (16 + 4 + 3) * 8 + 4
# the workspace: the plastic lanes' count, the next list entry, the list
LIST_OFFSET = 2


def _check(deps, sig_n, device_type):
    n = deps.shape[-1]
    for name, t in (("deps", deps), ("sig_n", sig_n)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != (4, n):
            raise ValueError(f"{name} must have shape (4, {n}), got {tuple(t.shape)}")
        if t.device.type != device_type or t.device != deps.device:
            raise ValueError(f"{name} lies on {t.device}, expected {deps.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n


def _outputs(n, device):
    """C (16, n), sig (4, n), yielding, norm_res, dlambda (n,): contiguous
    row blocks of one f64 buffer; niter (n,) int32."""
    out = torch.empty((23, n), dtype=torch.float64, device=device)
    niter = torch.empty(n, dtype=torch.int32, device=device)
    return out[:16], out[16:20], niter, out[20], out[21], out[22]


def _params(material):
    """The packed constants as a ctypes double array (kept alive by the
    caller for the duration of the call)."""
    p = material.kernel_params()
    return (ctypes.c_double * p.size)(*p.tolist())


def _workspace(n, device):
    """The kernel's int32 scratch of ``n + 2`` entries: the listed lanes'
    count, the next list entry for pass B, then the list (pass A's order,
    which varies from run to run and changes no output)."""
    if n + LIST_OFFSET > torch.iinfo(torch.int32).max:
        raise ValueError(f"{n} points do not fit the kernel's int32 lane list")
    return torch.empty(n + LIST_OFFSET, dtype=torch.int32, device=device)


def _launch(deps, sig_n, material, outs, work):
    """Launch both passes on the current stream into ``outs`` (as
    ``_outputs`` gives them) with ``work`` (``_workspace``), and count the
    launch on ``mc_return_map.launches``.  ``mc_return_map`` calls it; a
    caller that reads pass A's list in ``work`` (tests, ``chip_smoke.py``)
    may call it too."""
    from .._native.cuda import cuda_function

    n = _check(deps, sig_n, "cuda")
    # the launcher runs on the runtime's current device
    if deps.device.index != torch.cuda.current_device():
        raise ValueError(f"inputs lie on {deps.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    fn = cuda_function("mohr_coulomb")
    params = _params(material)
    err = fn(deps.data_ptr(), sig_n.data_ptr(), *(t.data_ptr() for t in outs), work.data_ptr(),
             n, ctypes.cast(params, ctypes.c_void_p), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mohr_coulomb kernel launch failed: cudaError {err}")
    mc_return_map.launches += 1


def mc_return_map(deps, sig_n, material):
    """deps, sig_n (4, N) f64 -> (C (16, N), sig (4, N), niter (N,) int32,
    yielding, norm_res, dlambda (N,) f64) for a ``MohrCoulombMaterial``.

    CUDA tensors go through the kernel (any N: it masks the ragged edge);
    CPU tensors through the plain version.  ``mc_return_map.launches``
    counts kernel calls (one per call, both passes)."""
    if deps.device.type == "cpu":
        n = _check(deps, sig_n, "cpu")
        C_t, (sig, niter, yielding, norm_res, dlambda) = material.tangent_stress(deps, sig_n)
        return C_t.reshape(16, n), sig, niter, yielding, norm_res, dlambda
    if deps.device.type != "cuda":
        raise ValueError(f"unsupported device {deps.device}")
    n = _check(deps, sig_n, "cuda")
    outs = _outputs(n, deps.device)
    _launch(deps, sig_n, material, outs, _workspace(n, deps.device))
    return outs


mc_return_map.launches = 0


def mc_return_map_host(deps, sig_n, material, reverse=False):
    """The kernel body itself, built for the CPU with g++ (tests only):
    same contract as ``mc_return_map`` on CPU tensors.  ``reverse`` runs
    each point's roles in reverse order, which must give the same bits."""
    from .._native.cuda import host_function

    n = _check(deps, sig_n, "cpu")
    fn = host_function("mohr_coulomb")
    outs = _outputs(n, deps.device)
    params = _params(material)
    fn(deps.data_ptr(), sig_n.data_ptr(), *(t.data_ptr() for t in outs), n,
       ctypes.cast(params, ctypes.c_void_p), int(reverse))
    return outs

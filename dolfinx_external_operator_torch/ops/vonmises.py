"""Von Mises return map with consistent tangent (f32 body, SoA layout).

The port of ``dolfinx_external_operator_tpu/ops/vonmises_pallas.py``, two
entry points of one hand-written kernel (``csrc/vonmises.cu``, body in
``csrc/vonmises.cuh``):

* ``vonmises_return_map``: the Pallas kernel's contract, f32 in and out;
* ``vonmises_return_map_f64``: the fused step's contract, f64 in and out
  with the f32 body between, casts in registers, any n, p optional (none
  means p = 0).  It gives the f32 entry's results on the inputs rounded to
  f32, widened, bit for bit, in one launch.

On a CUDA tensor each launches the kernel; on a CPU tensor it runs its
plain PyTorch version (``vonmises_return_map_reference``, for the f64 entry
with the casts around it).  There is no fallback from the kernel to the
plain version.

Bound on an H100: bytes (``BYTES_PER_POINT`` = 120 for the f32 entry,
``BYTES_PER_POINT_F64`` = 224 for the f64 entry without p and dp) over
3.35 TB/s; at the main path's 3,750 points that is 0.13 or 0.25 us, below
one launch (``utils/roofline.py``).
"""

from __future__ import annotations

import torch

from ..utils.roofline import VM_BYTES_PER_POINT as BYTES_PER_POINT
from ..utils.roofline import VM_F64_BYTES_PER_POINT as BYTES_PER_POINT_F64

__all__ = ["vonmises_return_map", "vonmises_return_map_reference",
           "vonmises_return_map_host", "vonmises_return_map_f64",
           "vonmises_return_map_f64_reference", "vonmises_return_map_f64_host",
           "BYTES_PER_POINT", "BYTES_PER_POINT_F64"]


def _check(deps, sig_n, p, device_type):
    n = deps.shape[-1]
    for name, t, shape in (("deps", deps, (4, n)), ("sig_n", sig_n, (4, n)), ("p", p, (n,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device.type != device_type or t.device != deps.device:
            raise ValueError(f"{name} lies on {t.device}, expected {deps.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n


def vonmises_return_map_reference(deps, sig_n, p, params):
    """Plain PyTorch version: deps/sig_n (4, N) f32, p (N,) f32, params
    [lmbda, mu, H, sig0] -> (C_tang (16, N), sig (4, N), dp (N,)) f32.
    The same operations in the same order as the kernel body."""
    f32 = torch.float32
    lmbda, mu, H, sig0 = (torch.tensor(float(v), dtype=f32, device=deps.device)
                          for v in params)
    e0, e1, e2, e3 = deps.unbind(0)
    tr_e = e0 + e1 + e2
    two_mu = 2.0 * mu
    s0 = sig_n[0] + lmbda * tr_e + two_mu * e0
    s1 = sig_n[1] + lmbda * tr_e + two_mu * e1
    s2 = sig_n[2] + lmbda * tr_e + two_mu * e2
    s3 = sig_n[3] + two_mu * e3

    m = (s0 + s1 + s2) / 3.0
    d0, d1, d2, d3 = s0 - m, s1 - m, s2 - m, s3
    sig_eq = torch.sqrt(1.5 * (d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3))

    f_el = sig_eq - sig0 - H * p
    plastic = f_el > 0.0
    zero = torch.zeros((), dtype=f32, device=deps.device)
    f_plus = torch.where(plastic, f_el, zero)
    dp = f_plus / (3.0 * mu + H)

    seq_safe = torch.where(sig_eq > 0.0, sig_eq, torch.ones((), dtype=f32, device=deps.device))
    beta = torch.where(plastic, 3.0 * mu * dp / seq_safe, zero)
    scale_n = torch.where(plastic, 1.0 / seq_safe, zero)
    nv = (d0 * scale_n, d1 * scale_n, d2 * scale_n, d3 * scale_n)
    sig = torch.stack([s0 - beta * d0, s1 - beta * d1, s2 - beta * d2, s3 - beta * d3])

    coef_n = 3.0 * mu * (3.0 * mu / (3.0 * mu + H) - beta)
    two_mu_beta = two_mu * beta
    # DEV entries: the f32 roundings of 2/3 and -1/3
    dev_diag = torch.tensor(2.0 / 3.0, dtype=f32, device=deps.device)
    dev_off = torch.tensor(-1.0 / 3.0, dtype=f32, device=deps.device)
    rows = []
    for a in range(4):
        for b in range(4):
            if a == 3 and b == 3:
                c_el, dev_ab = two_mu, 1.0
            elif a < 3 and b < 3:
                c_el = lmbda + two_mu if a == b else lmbda
                dev_ab = dev_diag if a == b else dev_off
            else:
                c_el, dev_ab = 0.0, 0.0
            rows.append(c_el - coef_n * nv[a] * nv[b] - two_mu_beta * dev_ab)
    return torch.stack(rows), sig, dp


def _params(params):
    lmbda, mu, H, sig0 = (float(v) for v in params)
    return lmbda, mu, H, sig0


def _outputs(n, device):
    """C (16, n), sig (4, n), dp (n,): contiguous row blocks of one buffer."""
    out = torch.empty((21, n), dtype=torch.float32, device=device)
    return out[:16], out[16:20], out[20]


def vonmises_return_map(deps, sig_n, p, params):
    """deps/sig_n (4, N) f32, p (N,) f32, params [lmbda, mu, H, sig0] ->
    (C_tang (16, N), sig (4, N), dp (N,)) f32.

    CUDA tensors go through the kernel (any N), CPU tensors through the
    plain version.  ``vonmises_return_map.launches``
    counts kernel launches."""
    if deps.device.type == "cpu":
        _check(deps, sig_n, p, "cpu")
        return vonmises_return_map_reference(deps, sig_n, p, params)
    if deps.device.type != "cuda":
        raise ValueError(f"unsupported device {deps.device}")
    from .._native.cuda import cuda_function

    n = _check(deps, sig_n, p, "cuda")
    launch = cuda_function("vonmises")
    C, sig, dp = _outputs(n, deps.device)
    # the launcher runs on the runtime's current device
    if deps.device.index != torch.cuda.current_device():
        raise ValueError(f"inputs lie on {deps.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    err = launch(deps.data_ptr(), sig_n.data_ptr(), p.data_ptr(), C.data_ptr(),
                 sig.data_ptr(), dp.data_ptr(), n, *_params(params),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"vonmises kernel launch failed: cudaError {err}")
    vonmises_return_map.launches += 1
    return C, sig, dp


vonmises_return_map.launches = 0


def vonmises_return_map_host(deps, sig_n, p, params):
    """The kernel body itself, built for the CPU with g++ (tests only):
    same contract as ``vonmises_return_map`` on CPU tensors."""
    from .._native.cuda import host_function

    n = _check(deps, sig_n, p, "cpu")
    fn = host_function("vonmises")
    C, sig, dp = _outputs(n, deps.device)
    fn(deps.data_ptr(), sig_n.data_ptr(), p.data_ptr(), C.data_ptr(), sig.data_ptr(),
       dp.data_ptr(), n, *_params(params))
    return C, sig, dp


def _check_f64(deps, sig_n, p, device_type):
    n = deps.shape[-1]
    for name, t, shape in (("deps", deps, (4, n)), ("sig_n", sig_n, (4, n)), ("p", p, (n,))):
        if t is None:
            continue
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device.type != device_type or t.device != deps.device:
            raise ValueError(f"{name} lies on {t.device}, expected {deps.device}")
    if p is not None and p.stride(0) != 1:
        raise ValueError("p must be contiguous")
    return n


def _outputs_f64(n, device, want_dp):
    """C (16, n), sig (4, n) and dp (n,) or None: contiguous row blocks of
    one f64 buffer."""
    out = torch.empty((21 if want_dp else 20, n), dtype=torch.float64, device=device)
    return out[:16], out[16:20], out[20] if want_dp else None


def vonmises_return_map_f64_reference(deps, sig_n, p, params, want_dp=False):
    """Plain version of the f64 entry: the inputs rounded to f32, the plain
    f32 map, the results widened to f64 (dp None unless ``want_dp``)."""
    f32, f64 = torch.float32, torch.float64
    p32 = (torch.zeros(deps.shape[-1], dtype=f32, device=deps.device) if p is None
           else p.to(f32))
    C, sig, dp = vonmises_return_map_reference(deps.to(f32), sig_n.to(f32), p32, params)
    return C.to(f64), sig.to(f64), dp.to(f64) if want_dp else None


def vonmises_return_map_f64(deps, sig_n, p, params, want_dp=False):
    """The fused step's contract: deps/sig_n (4, N) f64 at any strides, p
    (N,) f64 or None (p = 0), params [lmbda, mu, H, sig0] -> (C_tang (16,
    N), sig (4, N), dp (N,) or None) f64, C and sig contiguous (C views as
    (4, 4, N)).  The values are those of ``vonmises_return_map`` on the
    inputs cast to f32, cast back.

    CUDA tensors go through the kernel in one launch, CPU tensors through
    the plain version.  ``vonmises_return_map_f64.launches`` counts
    kernel launches."""
    if deps.device.type == "cpu":
        _check_f64(deps, sig_n, p, "cpu")
        return vonmises_return_map_f64_reference(deps, sig_n, p, params, want_dp)
    if deps.device.type != "cuda":
        raise ValueError(f"unsupported device {deps.device}")
    from .._native.cuda import cuda_function

    n = _check_f64(deps, sig_n, p, "cuda")
    if deps.device.index != torch.cuda.current_device():
        raise ValueError(f"inputs lie on {deps.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    launch = cuda_function("vonmises_f64")
    C, sig, dp = _outputs_f64(n, deps.device, want_dp)
    err = launch(deps.data_ptr(), deps.stride(0), deps.stride(1), sig_n.data_ptr(),
                 sig_n.stride(0), sig_n.stride(1), None if p is None else p.data_ptr(),
                 C.data_ptr(), sig.data_ptr(), None if dp is None else dp.data_ptr(), n,
                 *_params(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"vonmises f64 kernel launch failed: cudaError {err}")
    vonmises_return_map_f64.launches += 1
    return C, sig, dp


vonmises_return_map_f64.launches = 0


def vonmises_return_map_f64_host(deps, sig_n, p, params, want_dp=False):
    """The f64 entry's body, built for the CPU with g++ (tests only): same
    contract as ``vonmises_return_map_f64`` on CPU tensors."""
    from .._native.cuda import host_function

    n = _check_f64(deps, sig_n, p, "cpu")
    fn = host_function("vonmises_f64")
    C, sig, dp = _outputs_f64(n, deps.device, want_dp)
    fn(deps.data_ptr(), deps.stride(0), deps.stride(1), sig_n.data_ptr(), sig_n.stride(0),
       sig_n.stride(1), None if p is None else p.data_ptr(), C.data_ptr(), sig.data_ptr(),
       None if dp is None else dp.data_ptr(), n, *_params(params))
    return C, sig, dp

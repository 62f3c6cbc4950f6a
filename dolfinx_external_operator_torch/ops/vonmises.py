"""Von Mises return map with consistent tangent (f32, SoA layout).

The port of ``dolfinx_external_operator_tpu/ops/vonmises_pallas.py``: on a
CUDA tensor ``vonmises_return_map`` launches the hand-written kernel of
``csrc/vonmises.cu`` (one thread per Gauss point, body in
``csrc/vonmises.cuh``); on a CPU tensor it runs
``vonmises_return_map_reference``, the plain PyTorch version of the same
f32 formula.  There is no fallback from the kernel to the plain version.

Bound on an H100: 120 bytes per point (36 read, 84 written) over 3.35 TB/s;
at the main path's 4,096 padded points that is 0.15 us, below one launch.
"""

from __future__ import annotations

import torch

__all__ = ["vonmises_return_map", "vonmises_return_map_reference",
           "vonmises_return_map_host", "BYTES_PER_POINT"]

BYTES_PER_POINT = (4 + 4 + 1) * 4 + (16 + 4 + 1) * 4


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

    CUDA tensors go through the kernel (any N: it masks the ragged edge);
    CPU tensors through the plain version.  ``vonmises_return_map.launches``
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

"""AMG-CG's f32 iteration: the elementwise chains of a Chebyshev step and
of a PCG iteration as hand-written kernels (``csrc/mg_cycle.cu``, bodies
in ``csrc/mg_cycle.cuh``).

The JAX package runs these chains inside its ``while_loop``, where XLA
fuses them; the port's torch chains (``parallel/mg.py``:
``_chebyshev_reference``, ``_pcg_iterations_reference``) launch one
kernel an operation.  Each kernel does the same operations in the same
order, each rounded on its own, so it gives the chain's bits:

* ``chebyshev_step``: one Chebyshev launch between two matvecs; ``mode``
  0 (zero start: ``d = (dinv r) / theta``, ``x = d``), 1 (a start:
  ``r = b - A x0``, ``d = (dinv r) / theta``, ``x = x0 + d``) or 2 (a
  step: ``r = r - A d``, ``d = c_old d + c_new (dinv r)``, ``x = x + d``);
* ``pcg_xr``: PCG (a), the step length from ``pAp`` and ``rz``, then ``x
  + alpha p`` and ``r - alpha Ap``;
* ``pcg_p``: PCG (b), the direction ``z + beta p``, the best iterate
  into its slot, and the new best norm and the loop test's row (good,
  the norm, better).

The scalars are 0-dim f32 tensors, read through their pointers by the
kernel, never on the host.  The caller hands every output buffer; an
output may be the input it replaces (``r_in`` and ``r_out``, ``x_in`` and
``x_out``, ``p_in`` and ``p_out``), the scalars a launch writes may not be
any it reads.  On CUDA tensors each wrapper launches its kernel and
counts it (``.launches``); ``*_host`` runs the same bodies built with g++
on CPU tensors (tests only: they give the card's bits).  The wrappers
raise on anything else.
"""

from __future__ import annotations

import torch

__all__ = ["chebyshev_step", "pcg_xr", "pcg_p", "chebyshev_step_host", "pcg_xr_host",
           "pcg_p_host", "reset_launches", "launch_counts"]

_F32 = torch.float32


def _check(device, n, vectors, scalars):
    """Every vector (n,) and every scalar (one element) f32, contiguous,
    on ``device``; ``None`` stands for an operand the launch does not
    read."""
    for name, t in {**vectors, **scalars}.items():
        if t is None:
            continue
        if t.dtype != _F32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in vectors and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
        if name in scalars and t.numel() != 1:
            raise ValueError(f"{name} must hold one value, got shape {tuple(t.shape)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(wrapper, name, device, args, host):
    from .._native.cuda import cuda_function, host_function

    if host:
        if device.type != "cpu":
            raise ValueError(f"{name}_host takes CPU tensors, got {device}")
        host_function(name)(*args)
        return
    if device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {device}")
    if device.index != torch.cuda.current_device():
        raise ValueError(f"inputs lie on {device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    err = cuda_function(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    wrapper.launches += 1


def _cheb(mode, dinv, r_in, av, x_in, r_out, d, x_out, c0, c1, host):
    if mode not in (0, 1, 2):
        raise ValueError(f"mode must be 0, 1 or 2, got {mode}")
    reads = {"av": av, "x_in": x_in, "r_out": r_out} if mode else {}
    if mode and any(t is None for t in reads.values()):
        raise ValueError(f"mode {mode} reads av and x_in and writes r_out")
    n = dinv.shape[0] if dinv.dim() == 1 else -1
    _check(dinv.device, n, {"dinv": dinv, "r_in": r_in, "d": d, "x_out": x_out, **reads},
           {"c0": c0, "c1": c1 if mode == 2 else None})
    args = (mode, n, dinv.data_ptr(), r_in.data_ptr(), _ptr(av), _ptr(x_in), _ptr(r_out),
            d.data_ptr(), x_out.data_ptr(), c0.data_ptr(), _ptr(c1 if mode == 2 else None))
    _call(chebyshev_step, "chebyshev_step", dinv.device, args, host)


def chebyshev_step(mode, dinv, r_in, av, x_in, r_out, d, x_out, c0, c1=None):
    """One Chebyshev launch on the card: ``c0`` is theta in modes 0 and 1
    and c_old in mode 2, ``c1`` c_new (mode 2).  Mode 0 reads ``dinv`` and
    ``r_in`` and writes ``d`` and ``x_out`` (``av``, ``x_in``, ``r_out``
    unused); mode 1 reads ``r_in`` = b, ``av`` = A x0, ``x_in`` = x0; mode
    2 reads ``r_in``, ``av`` = A d, ``d`` and ``x_in``."""
    _cheb(mode, dinv, r_in, av, x_in, r_out, d, x_out, c0, c1, host=False)


def chebyshev_step_host(mode, dinv, r_in, av, x_in, r_out, d, x_out, c0, c1=None):
    """``chebyshev_step``'s bodies built with g++, on CPU tensors."""
    _cheb(mode, dinv, r_in, av, x_in, r_out, d, x_out, c0, c1, host=True)


def _xr(pAp, rz, x_in, r_in, p, ap, x_out, r_out, host):
    n = p.shape[0] if p.dim() == 1 else -1
    _check(p.device, n, {"x_in": x_in, "r_in": r_in, "p": p, "ap": ap, "x_out": x_out,
                         "r_out": r_out}, {"pAp": pAp, "rz": rz})
    args = (n, pAp.data_ptr(), rz.data_ptr(), x_in.data_ptr(), r_in.data_ptr(), p.data_ptr(),
            ap.data_ptr(), x_out.data_ptr(), r_out.data_ptr())
    _call(pcg_xr, "pcg_xr", p.device, args, host)


def pcg_xr(pAp, rz, x_in, r_in, p, ap, x_out, r_out):
    """PCG (a) on the card: ``x_out = x_in + alpha p``, ``r_out = r_in -
    alpha ap``, alpha from ``pAp`` and ``rz`` as ``ir_pcg`` takes it."""
    _xr(pAp, rz, x_in, r_in, p, ap, x_out, r_out, host=False)


def pcg_xr_host(pAp, rz, x_in, r_in, p, ap, x_out, r_out):
    """``pcg_xr``'s bodies built with g++, on CPU tensors."""
    _xr(pAp, rz, x_in, r_in, p, ap, x_out, r_out, host=True)


def _p(pAp, rz, rz2, nn, nb, z, p_in, x, xb_in, p_out, xb_out, nb_out, test, host):
    n = z.shape[0] if z.dim() == 1 else -1
    _check(z.device, n, {"z": z, "p_in": p_in, "x": x, "xb_in": xb_in, "p_out": p_out,
                         "xb_out": xb_out},
           {"pAp": pAp, "rz": rz, "rz2": rz2, "nn": nn, "nb": nb, "nb_out": nb_out})
    _check(z.device, 3, {"test": test}, {})
    written = {nb_out.data_ptr(), test.data_ptr()}
    if written & {t.data_ptr() for t in (pAp, rz, rz2, nn, nb)}:
        raise ValueError("nb_out and test may not be a scalar the launch reads")
    args = (n, pAp.data_ptr(), rz.data_ptr(), rz2.data_ptr(), nn.data_ptr(), nb.data_ptr(),
            z.data_ptr(), p_in.data_ptr(), x.data_ptr(), xb_in.data_ptr(), p_out.data_ptr(),
            xb_out.data_ptr(), nb_out.data_ptr(), test.data_ptr())
    _call(pcg_p, "pcg_p", z.device, args, host)


def pcg_p(pAp, rz, rz2, nn, nb, z, p_in, x, xb_in, p_out, xb_out, nb_out, test):
    """PCG (b) on the card: ``p_out = z + beta p_in`` (beta from the old
    ``rz`` and the new ``rz2``), ``xb_out`` = ``x`` where ``nn < nb``,
    else ``xb_in``; ``nb_out`` the new best norm and ``test`` (3,) the
    loop test's row: good (from ``pAp``, ``rz``, ``nn`` and the new best
    norm), ``nn``, better, as 1 or 0."""
    _p(pAp, rz, rz2, nn, nb, z, p_in, x, xb_in, p_out, xb_out, nb_out, test, host=False)


def pcg_p_host(pAp, rz, rz2, nn, nb, z, p_in, x, xb_in, p_out, xb_out, nb_out, test):
    """``pcg_p``'s bodies built with g++, on CPU tensors."""
    _p(pAp, rz, rz2, nn, nb, z, p_in, x, xb_in, p_out, xb_out, nb_out, test, host=True)


_COUNTED = (chebyshev_step, pcg_xr, pcg_p)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


reset_launches()

"""Build and bind the port's hand-written kernels.

Each kernel source under ``csrc/`` is compiled at first use into a shared
library with a plain C interface and loaded with ``ctypes``: ``nvcc`` for
the CUDA kernels (``sm_90a``), ``g++`` for the CPU build of a kernel's
per-point body that the tests compare with the plain PyTorch version.  The
library's file name carries a hash of its flags and of every file it is
built from (the tables below list each source with the headers it
includes), so an edited source or header is always rebuilt and two
processes never write the same file.  Entries with the same sources
share one library, built once.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# no --use_fast_math: f32 sqrt, division and trig stay IEEE-accurate, as on
# the TPU; -Xptxas -v reports registers and spills into BUILD_LOG.  Every
# kernel takes these flags alone: where K1 must not fuse a product with an
# add, its source says so (mohr_coulomb.cuh, mul())
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_FL = ctypes.c_float
_INT = ctypes.c_int

# name -> (files it is built from, the compiled one first; C function;
# argtypes[; restype of a host entry, default none])
KERNELS = {
    "vonmises": (("vonmises.cu", "vonmises.cuh"), "vonmises_return_map_launch",
                 [_VP] * 6 + [_LL] + [_FL] * 4 + [_VP]),
    "vonmises_f64": (("vonmises.cu", "vonmises.cuh"), "vonmises_f64_launch",
                     [_VP, _LL, _LL] * 2 + [_VP] * 4 + [_LL] + [_FL] * 4 + [_VP]),
    "mohr_coulomb": (("mohr_coulomb.cu", "mohr_coulomb.cuh"), "mohr_coulomb_launch",
                     [_VP] * 9 + [_LL] + [_VP] * 2),
    "empty": (("empty.cu",), "empty_launch", [_VP]),
    # the element chain, E1-E5 (one library)
    "cell_strain": (("element_chain.cu", "element_chain.cuh"), "ec_strain_launch",
                    [_VP] * 3 + [_LL, _VP, _LL] + [_INT] * 3 + [_VP]),
    "cell_residual": (("element_chain.cu", "element_chain.cuh"), "ec_residual_launch",
                      [_VP] * 2 + [_LL] * 3 + [_VP] * 2 + [_LL] + [_INT] * 3 + [_VP]),
    "cell_tangent": (("element_chain.cu", "element_chain.cuh"), "ec_tangent_launch",
                     [_INT] + [_VP] * 2 + [_LL] * 4 + [_VP] * 3 + [_LL] + [_VP] * 2 + [_LL]
                     + [_INT] * 3 + [_VP]),
    "ebe_matvec": (("element_chain.cu", "element_chain.cuh"), "ec_ebe_launch",
                   [_INT, _VP] + [_LL] * 3 + [_VP] * 2 + [_LL, _VP, _LL] + [_INT] * 3 + [_VP]),
    "cell_product": (("element_chain.cu", "element_chain.cuh"), "ec_product_launch",
                     [_INT] + [_VP] * 3 + [_LL] * 14 + [_INT, _VP]),
    "cell_values_grads": (("element_chain.cu", "element_chain.cuh"), "ec_values_grads_launch",
                          [_INT, _VP, _LL, _LL, _VP] + [_LL] * 4 + [_VP] + [_LL] * 3
                          + [_VP] * 2 + [_LL] * 5 + [_VP]),
    "cell_triple": (("element_chain.cu", "element_chain.cuh"), "ec_triple_launch",
                    ([_VP] + [_LL] * 3) * 2 + [_VP] + [_LL] * 3 + [_VP]),
    # AMG-CG's f32 iteration: a Chebyshev step, PCG (a) and (b) (one library)
    "chebyshev_step": (("mg_cycle.cu", "mg_cycle.cuh"), "mg_cheb_launch",
                       [_INT, _LL] + [_VP] * 9 + [_VP]),
    "pcg_xr": (("mg_cycle.cu", "mg_cycle.cuh"), "mg_pcg_xr_launch", [_LL] + [_VP] * 8 + [_VP]),
    "pcg_p": (("mg_cycle.cu", "mg_cycle.cuh"), "mg_pcg_p_launch", [_LL] + [_VP] * 13 + [_VP]),
}
_HOST = {
    "vonmises": (("vonmises_host.cpp", "vonmises.cuh"), "vonmises_return_map_host",
                 [_VP] * 6 + [_LL] + [_FL] * 4),
    "vonmises_f64": (("vonmises_host.cpp", "vonmises.cuh"), "vonmises_f64_host",
                     [_VP, _LL, _LL] * 2 + [_VP] * 4 + [_LL] + [_FL] * 4),
    "mohr_coulomb": (("mohr_coulomb_host.cpp", "mohr_coulomb.cuh"), "mohr_coulomb_host",
                     [_VP] * 8 + [_LL] + [_VP] + [_INT]),
    "cell_strain": (("element_chain_host.cpp", "element_chain.cuh"), "ec_strain_host",
                    [_VP] * 3 + [_LL, _VP, _LL] + [_INT] * 3),
    "cell_residual": (("element_chain_host.cpp", "element_chain.cuh"), "ec_residual_host",
                      [_VP] * 2 + [_LL] * 3 + [_VP] * 2 + [_LL] + [_INT] * 3),
    "cell_tangent": (("element_chain_host.cpp", "element_chain.cuh"), "ec_tangent_host",
                     [_INT] + [_VP] * 2 + [_LL] * 4 + [_VP] * 3 + [_LL] + [_VP] * 2 + [_LL]
                     + [_INT] * 3),
    "ebe_matvec": (("element_chain_host.cpp", "element_chain.cuh"), "ec_ebe_host",
                   [_INT, _VP] + [_LL] * 3 + [_VP] * 2 + [_LL, _VP, _LL] + [_INT] * 3),
    "cell_product": (("element_chain_host.cpp", "element_chain.cuh"), "ec_product_host",
                     [_INT] + [_VP] * 3 + [_LL] * 14 + [_INT]),
    # the staged kernels' composition; they return 1 off the staged shape
    "cell_residual_staged": (("element_chain_host.cpp", "element_chain.cuh"),
                             "ec_residual_staged_host",
                             [_VP] * 2 + [_LL] * 3 + [_VP] * 2 + [_LL] + [_INT] * 3, _INT),
    "cell_tangent_staged": (("element_chain_host.cpp", "element_chain.cuh"),
                            "ec_tangent_staged_host",
                            [_INT] + [_VP] * 2 + [_LL] * 4 + [_VP] * 3 + [_LL] + [_VP] * 2 + [_LL]
                            + [_INT] * 3, _INT),
    "cell_product_staged": (("element_chain_host.cpp", "element_chain.cuh"),
                            "ec_product_staged_host", [_INT] + [_VP] * 3 + [_LL] * 14 + [_INT],
                            _INT),
    "cell_values_grads_staged": (("element_chain_host.cpp", "element_chain.cuh"),
                                 "ec_values_grads_staged_host",
                                 [_INT, _VP, _LL, _LL, _VP] + [_LL] * 4 + [_VP] + [_LL] * 3
                                 + [_VP] * 2 + [_LL] * 5, _INT),
    "cell_triple_staged": (("element_chain_host.cpp", "element_chain.cuh"),
                           "ec_triple_staged_host", ([_VP] + [_LL] * 3) * 2 + [_VP] + [_LL] * 3,
                           _INT),
    "chebyshev_step": (("mg_cycle_host.cpp", "mg_cycle.cuh"), "mg_cheb_host",
                       [_INT, _LL] + [_VP] * 9),
    "pcg_xr": (("mg_cycle_host.cpp", "mg_cycle.cuh"), "mg_pcg_xr_host", [_LL] + [_VP] * 8),
    "pcg_p": (("mg_cycle_host.cpp", "mg_cycle.cuh"), "mg_pcg_p_host", [_LL] + [_VP] * 13),
}
# what each compiler printed for a library built by this process (nvcc's
# -Xptxas -v: registers, stack and spills of each kernel)
BUILD_LOG: dict[str, str] = {}

_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# one lock per library, so that threads building entries of one library
# build it once
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


def _compile(compiler: list[str], flags: list[str], sources) -> str:
    """Build ``sources[0]`` (which includes the rest) from ``CSRC_DIR``
    into a shared library under ``BUILD_DIR``, named after that source;
    returns its path."""
    tag = sources[0].replace(".", "_")
    with _locks_guard:
        lock = _locks.setdefault(tag, threading.Lock())
    with lock:
        digest = hashlib.sha256()
        for part in flags:
            digest.update(part.encode())
        for src in sources:
            with open(os.path.join(CSRC_DIR, src), "rb") as f:
                digest.update(f.read())
        out = os.path.join(BUILD_DIR, f"lib{tag}_{digest.hexdigest()[:16]}.so")
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
        cmd = compiler + flags + ["-o", tmp, os.path.join(CSRC_DIR, sources[0])]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
        BUILD_LOG[tag] = res.stdout + res.stderr
        return out


def _bind(path: str, fn_name: str, argtypes, restype):
    fn = getattr(ctypes.CDLL(path), fn_name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def cuda_function(name: str):
    """The ``extern "C"`` launcher of kernel ``name``, built with nvcc."""
    key = ("cuda", name)
    if key not in _loaded:
        sources, fn, argtypes = KERNELS[name]
        path = _compile([find_nvcc()], NVCC_FLAGS, sources)
        _loaded[key] = _bind(path, fn, argtypes, ctypes.c_int)
    return _loaded[key]


def host_function(name: str):
    """The CPU build of kernel ``name``'s per-point body, built with g++."""
    key = ("host", name)
    if key not in _loaded:
        sources, fn, argtypes, *restype = _HOST[name]
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")
        path = _compile([cxx], GXX_FLAGS, sources)
        _loaded[key] = _bind(path, fn, argtypes, *(restype or [None]))
    return _loaded[key]

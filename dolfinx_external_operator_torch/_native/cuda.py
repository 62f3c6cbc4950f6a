"""Build and bind the port's hand-written kernels.

Each kernel source under ``csrc/`` is compiled at first use into a shared
library with a plain C interface and loaded with ``ctypes``: ``nvcc`` for
the CUDA kernels (``sm_90a``), ``g++`` for the CPU build of a kernel's
per-point body that the tests compare with the plain PyTorch version.  The
library's file name carries a hash of its flags and of every file it is
built from (the tables below list each source with the headers it
includes), so an edited source or header is always rebuilt and two
processes never write the same file.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# no --use_fast_math: f32 sqrt, division and trig stay IEEE-accurate, as on
# the TPU; -Xptxas -v reports registers and spills into BUILD_LOG
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_FL = ctypes.c_float
_INT = ctypes.c_int

# name -> (files it is built from, the compiled one first; C function;
# argtypes)
KERNELS = {
    "vonmises": (("vonmises.cu", "vonmises.cuh"), "vonmises_return_map_launch",
                 [_VP] * 6 + [_LL] + [_FL] * 4 + [_VP]),
    "mohr_coulomb": (("mohr_coulomb.cu", "mohr_coulomb.cuh"), "mohr_coulomb_launch",
                     [_VP] * 9 + [_LL] + [_VP] * 2),
    "empty": (("empty.cu",), "empty_launch", [_VP]),
}
_HOST = {
    "vonmises": (("vonmises_host.cpp", "vonmises.cuh"), "vonmises_return_map_host",
                 [_VP] * 6 + [_LL] + [_FL] * 4),
    "mohr_coulomb": (("mohr_coulomb_host.cpp", "mohr_coulomb.cuh"), "mohr_coulomb_host",
                     [_VP] * 8 + [_LL] + [_VP] + [_INT]),
}
# what each compiler printed for a library built by this process (nvcc's
# -Xptxas -v: registers, stack and spills of each kernel)
BUILD_LOG: dict[str, str] = {}

_loaded: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")


def _compile(compiler: list[str], flags: list[str], sources, tag: str) -> str:
    """Build ``sources[0]`` (which includes the rest) from ``CSRC_DIR``
    into a shared library under ``BUILD_DIR``; returns its path."""
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
        path = _compile([find_nvcc()], NVCC_FLAGS, sources, f"{name}_cuda")
        _loaded[key] = _bind(path, fn, argtypes, ctypes.c_int)
    return _loaded[key]


def host_function(name: str):
    """The CPU build of kernel ``name``'s per-point body, built with g++."""
    key = ("host", name)
    if key not in _loaded:
        sources, fn, argtypes = _HOST[name]
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")
        path = _compile([cxx], GXX_FLAGS, sources, f"{name}_host")
        _loaded[key] = _bind(path, fn, argtypes, None)
    return _loaded[key]

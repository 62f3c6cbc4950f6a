"""ctypes bindings for the native topology kernels (csrc/topology.cpp).

Copy of ``dolfinx_external_operator_tpu/_native/loader.py`` that builds the
library into the port's own ``_build/`` directory (listed in
``.gitignore``).  It degrades to the numpy implementations in ``mesh.py``
when no C++ compiler is present; callers check ``available()``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .cuda import BUILD_DIR

_LIB = None
_TRIED = False


def _try_build(path: str) -> bool:
    """Build the library from csrc/topology.cpp on first use (the binary is
    never committed: it always comes from the reviewed source)."""
    import shutil

    src = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "csrc", "topology.cpp"))
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if not (os.path.exists(src) and cxx):
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path[:-3]}.{os.getpid()}.tmp.so"
    try:
        subprocess.run(
            [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, src],
            check=True, capture_output=True, timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(BUILD_DIR, "libtorchfem_topology.so")
    if not os.path.exists(path) and not _try_build(path):
        return None
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.build_edges.restype = ctypes.c_int32
    lib.build_edges.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                i32p, ctypes.c_int32, i32p, i32p]
    lib.build_facets.restype = ctypes.c_int32
    lib.build_facets.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                 i32p, ctypes.c_int32, ctypes.c_int32,
                                 i32p, i32p, i32p, i32p]
    lib.partition_rcb.restype = None
    lib.partition_rcb.argtypes = [f64p, ctypes.c_int64, ctypes.c_int32,
                                  ctypes.c_int32, i32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build_edges(cells: np.ndarray, local_edges) -> tuple[np.ndarray, np.ndarray]:
    """(edges (ne, 2) sorted-pair, cell_edges (nc, n_le))."""
    lib = _load()
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    le = np.ascontiguousarray(local_edges, dtype=np.int32)
    n_cells, nv = cells.shape
    n_le = le.shape[0]
    cell_edges = np.empty((n_cells, n_le), dtype=np.int32)
    edges_buf = np.empty((max(n_cells * n_le, 1), 2), dtype=np.int32)
    n_edges = lib.build_edges(cells, n_cells, nv, le, n_le, cell_edges, edges_buf)
    return edges_buf[:n_edges].copy(), cell_edges


def build_facets(cells: np.ndarray, local_facets):
    """(facet_vertices, facet_cells, facet_local, cell_facets)."""
    lib = _load()
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    lf = np.ascontiguousarray(local_facets, dtype=np.int32)
    n_cells, nv = cells.shape
    n_lf, nvf = lf.shape
    cap = max(n_cells * n_lf, 1)
    cell_facets = np.empty((n_cells, n_lf), dtype=np.int32)
    fv = np.empty((cap, nvf), dtype=np.int32)
    fc = np.empty((cap, 2), dtype=np.int32)
    flo = np.empty((cap, 2), dtype=np.int32)
    n = lib.build_facets(cells, n_cells, nv, lf, n_lf, nvf, cell_facets, fv, fc, flo)
    return fv[:n].copy(), fc[:n].copy(), flo[:n].copy(), cell_facets


def partition_rcb(midpoints: np.ndarray, n_parts: int) -> np.ndarray:
    lib = _load()
    midpoints = np.ascontiguousarray(midpoints, dtype=np.float64)
    n_cells, gdim = midpoints.shape
    out = np.empty(n_cells, dtype=np.int32)
    lib.partition_rcb(midpoints, n_cells, gdim, n_parts, out)
    return out

"""ctypes binding for the native C++ mesh preprocessor, ported from
conservation_fem_tpu/native_ext.py.

The library is built from the repository's ``native/mesh_preprocess.cpp``
with g++ at first use, into ``_build/libcftmesh.so`` beside this package
(listed in .gitignore; ``native/`` is never written), and rebuilt when the
SHA-256 of the source changes. Processes that build it at once (test
workers) take a file lock and each writes its own temporary file, renamed
into place, so no process loads a half-written library. A failed build raises: nothing
falls back to numpy here. ``ops/mesh.mesh_from_arrays(..., use_native=True)``
takes its boundary mask and ELL adjacency from ``preprocess_mesh``; the
numpy path (the default) computes the same arrays.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(_PKG), "native", "mesh_preprocess.cpp")
LIB = os.path.join(_PKG, "_build", "libcftmesh.so")
_lock = threading.Lock()
_lib = None


def _source_hash() -> str:
    with open(SRC, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def build() -> str:
    """Compile SRC into LIB unless a library of the same source is there;
    returns LIB. Raises RuntimeError if g++ fails or the source is
    missing."""
    if not os.path.exists(SRC):
        raise RuntimeError(f"native preprocessor source not found: {SRC}")
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    stamp = LIB + ".sha256"
    digest = _source_hash()
    with open(LIB + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(LIB) and os.path.exists(stamp):
            with open(stamp) as fh:
                if fh.read().strip() == digest:
                    return LIB
        tmp = f"{LIB}.{os.getpid()}.tmp"
        res = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, SRC],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed to build the native mesh "
                               f"preprocessor:\n{res.stdout}{res.stderr}")
        os.replace(tmp, LIB)
        with open(stamp, "w") as fh:
            fh.write(digest)
    return LIB


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.cft_preprocess_mesh.restype = ctypes.c_int
            lib.cft_preprocess_mesh.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                np.ctypeslib.ndpointer(np.uint8, flags="C"),
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
            ]
            lib.cft_structured_rectangle.restype = None
            lib.cft_structured_rectangle.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                np.ctypeslib.ndpointer(np.int32, flags="C"),
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def preprocess_mesh(n_nodes: int, cells: np.ndarray):
    """(boundary_mask bool(N,), rowptr i64(N+1,), cols i32(nnz,), rcm_perm
    i32(N,) old->new) of a triangle mesh: the node adjacency in CSR with
    sorted columns (self included) and the JAX package's RCM order."""
    lib = _load()
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    if cells.ndim != 2 or cells.shape[1] != 3:
        raise ValueError(f"cells must be (M, 3), got {cells.shape}")
    if cells.size and not 0 <= cells.min() <= cells.max() < n_nodes:
        raise ValueError("cell node ids outside [0, n_nodes)")
    n_cells = cells.shape[0]
    boundary = np.zeros(n_nodes, dtype=np.uint8)
    rowptr = np.zeros(n_nodes + 1, dtype=np.int64)
    cap = n_cells * 9 + n_nodes
    cols = np.zeros(cap, dtype=np.int32)
    nnz = np.zeros(1, dtype=np.int64)
    rcm = np.zeros(n_nodes, dtype=np.int32)
    rc = lib.cft_preprocess_mesh(
        n_nodes, n_cells, cells, boundary, rowptr, cols, cap, nnz, rcm
    )
    if rc != 0:
        raise RuntimeError(f"cft_preprocess_mesh returned {rc}")
    return boundary.astype(bool), rowptr, cols[: int(nnz[0])].copy(), rcm


def structured_rectangle(nx: int, ny: int, x0=0.0, y0=0.0, x1=1.0, y1=1.0):
    """Native structured triangulation (right diagonal): (points (N,2) f64,
    cells (M,3) i64)."""
    lib = _load()
    n_pts = (nx + 1) * (ny + 1)
    points = np.zeros((n_pts, 2), dtype=np.float64)
    cells = np.zeros((2 * nx * ny, 3), dtype=np.int32)
    lib.cft_structured_rectangle(nx, ny, x0, y0, x1, y1, points, cells)
    return points, cells.astype(np.int64)

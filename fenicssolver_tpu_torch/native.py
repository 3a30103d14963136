"""ctypes loader for the shared native C++ setup kernels.

Port of ``fenicssolver_tpu/native.py``.  The source stays in one place,
``native/fst_native.cpp`` at the repository root; this loader compiles it
with g++ into the port's own build directory (``fenicssolver_tpu_torch/
_build/``, listed in ``.gitignore``) and never touches the JAX package's
``native/libfstnative.so``.  The build writes a temporary file and renames
it, so parallel workers cannot race.  Each entry point keeps the
reference's pure-numpy fallback for machines without a toolchain
(``aggregate`` and ``csr_spgemm`` return None and their callers in
``la/amg.py`` and ``la/sparse_algebra.py`` take the numpy route).
``build_ell`` is not bound: the block-ELL layout is not ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "native", "fst_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")

_lib = None
_tried = False


def _so_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfstnative_{digest}.so")


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = _so_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.build_csr_pattern.restype = ctypes.c_int64
    lib.build_csr_pattern.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p, i32p,
    ]
    lib.build_facets.restype = ctypes.c_int64
    lib.build_facets.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, i64p, i32p, i32p, i32p,
    ]
    lib.aggregate.restype = ctypes.c_int64
    lib.aggregate.argtypes = [i32p, i32p, ctypes.c_int64, i64p]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.csr_spgemm.restype = ctypes.c_int64
    lib.csr_spgemm.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, f64p, i64p, i64p, f64p, i64p, i64p, f64p,
    ]
    _lib = lib
    return _lib


def _ptr(arr, t):
    return arr.ctypes.data_as(ctypes.POINTER(t))


def available():
    return _load() is not None


def build_csr_pattern(keys, ndof):
    """keys (n,) int64 row*ndof+col -> (positions, indptr, indices, rows)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    if lib is None:
        uniq, inverse = np.unique(keys, return_inverse=True)
        rows = (uniq // ndof).astype(np.int32)
        cols = (uniq % ndof).astype(np.int32)
        indptr = np.zeros(ndof + 1, dtype=np.int32)
        np.add.at(indptr[1:], rows, 1)
        return (
            inverse.astype(np.int32),
            np.cumsum(indptr).astype(np.int32),
            cols,
            rows,
        )
    nnz = lib.build_csr_pattern(
        _ptr(keys, ctypes.c_int64), n, ndof, None, None, None, None
    )
    positions = np.empty(n, dtype=np.int32)
    indptr = np.empty(ndof + 1, dtype=np.int32)
    indices = np.empty(nnz, dtype=np.int32)
    rows = np.empty(nnz, dtype=np.int32)
    lib.build_csr_pattern(
        _ptr(keys, ctypes.c_int64),
        n,
        ndof,
        _ptr(positions, ctypes.c_int32),
        _ptr(indptr, ctypes.c_int32),
        _ptr(indices, ctypes.c_int32),
        _ptr(rows, ctypes.c_int32),
    )
    return positions, indptr, indices, rows


def build_facets(cells):
    """cells (nc, nvc) int32 (vertex-sorted) -> facet tables, or None if the
    native library is unavailable (the caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc, nvc = cells.shape
    fnv = nvc - 1
    facet_id = np.empty(nc * nvc, dtype=np.int64)
    nf = lib.build_facets(
        _ptr(cells, ctypes.c_int32), nc, nvc, None, None, None, None
    )
    facet_vertices = np.empty(nf * fnv, dtype=np.int32)
    facet_cells = np.empty(nf * 2, dtype=np.int32)
    facet_local = np.empty(nf * 2, dtype=np.int32)
    lib.build_facets(
        _ptr(cells, ctypes.c_int32),
        nc,
        nvc,
        _ptr(facet_id, ctypes.c_int64),
        _ptr(facet_vertices, ctypes.c_int32),
        _ptr(facet_cells, ctypes.c_int32),
        _ptr(facet_local, ctypes.c_int32),
    )
    return (
        facet_id.reshape(nc, nvc),
        facet_vertices.reshape(nf, fnv),
        facet_cells.reshape(nf, 2),
        facet_local.reshape(nf, 2),
    )


def aggregate(indptr, indices, n):
    """Greedy aggregation for AMG; returns (agg ids (n,), n_aggregates) or
    None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int32)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    agg = np.empty(n, dtype=np.int64)
    n_agg = lib.aggregate(
        _ptr(indptr, ctypes.c_int32), _ptr(indices, ctypes.c_int32), n,
        _ptr(agg, ctypes.c_int64),
    )
    return agg, int(n_agg)


def csr_spgemm(m, n, Ap, Ai, Ax, Bp, Bi, Bx):
    """C = A(m x k) @ B(k x n) on host CSR (int64 indptr/indices, f64 data)
    by the native Gustavson row merge; returns (indptr, indices, data) with
    sorted columns, or None when the native library is unavailable (the
    caller then takes ``la/sparse_algebra``'s sort-reduce formulation).

    Two calls: the symbolic one gets null outputs and only returns nnz (it
    does not fill ``Cp``); the numeric one fills all three arrays."""
    lib = _load()
    if lib is None:
        return None
    c_i64, c_f64 = ctypes.c_int64, ctypes.c_double
    Ap = np.ascontiguousarray(Ap, dtype=np.int64)
    Ai = np.ascontiguousarray(Ai, dtype=np.int64)
    Ax = np.ascontiguousarray(Ax, dtype=np.float64)
    Bp = np.ascontiguousarray(Bp, dtype=np.int64)
    Bi = np.ascontiguousarray(Bi, dtype=np.int64)
    Bx = np.ascontiguousarray(Bx, dtype=np.float64)
    operands = (
        _ptr(Ap, c_i64), _ptr(Ai, c_i64), _ptr(Ax, c_f64),
        _ptr(Bp, c_i64), _ptr(Bi, c_i64), _ptr(Bx, c_f64),
    )
    nnz = lib.csr_spgemm(m, n, *operands, None, None, None)
    Cp = np.empty(m + 1, dtype=np.int64)
    Ci = np.empty(nnz, dtype=np.int64)
    Cx = np.empty(nnz, dtype=np.float64)
    lib.csr_spgemm(m, n, *operands,
                   _ptr(Cp, c_i64), _ptr(Ci, c_i64), _ptr(Cx, c_f64))
    return Cp, Ci, Cx

"""The port's native host runtime: src/ogl_host.cpp through ctypes.

Counterpart: ogl_tpu/native/__init__.py, with the same ten entry points and
the same contract: each returns None when the library is unavailable, and
its caller then takes its NumPy path (host set-up code, never a device
fallback).  src/ogl_host.cpp is a copy of the reference's source, so the
two libraries compute the same bits from the same inputs, plus one entry
point of the port's own: `tri_levels`, the dependency level of every row of
a strict triangular factor in one pass (precond/ilu.py `factor_levels`).

The library is compiled with the reference's g++ flags on first use into
native/build/ (listed in .gitignore), keyed by a hash of the source and
flags.  Each build writes a temporary file in that directory and renames it
into place, so parallel test workers that build at once never load a
half-written library (the reference compiles straight into one shared path
under a per-process lock).  Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["lib", "available", "init_local_sparsity", "ilu0_csr", "ic0_csr",
           "pgm_aggregate", "sort_coo", "isai_build", "ilut_triples",
           "ict_triples", "dia_layout", "dia_pack_f32", "tri_levels"]

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "src" / "ogl_host.cpp"
BUILD = _HERE / "build"
# the reference's flags (ogl_tpu/native/__init__.py _compile)
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-Werror")

_lock = threading.Lock()
_state: dict = {"lib": None, "tried": False}


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD / f"libogl_host_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    """g++ into a temporary file beside `out`, then an atomic rename."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(L: ctypes.CDLL) -> ctypes.CDLL:
    i64, f64 = ctypes.c_int64, ctypes.c_double
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pf = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pf32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    sigs = {
        "ogl_init_local_sparsity": ([i64, i64, ctypes.c_int, p64, p64, p32, p32, p32], None),
        "ogl_ilu0": ([i64, p64, p32, pf], ctypes.c_int),
        "ogl_ic0": ([i64, p64, p32, pf], ctypes.c_int),
        "ogl_pgm_aggregate": ([i64, p64, p32, pf, p32], i64),
        "ogl_sort_coo": ([i64, i64, p64, p64, p32, p32, p32], None),
        "ogl_dia_count": ([i64, i64, p32, p32, pu8], i64),
        "ogl_dia_dest": ([i64, i64, pu8, p32, p32, p64, p64], None),
        "ogl_dia_pack_f32": ([i64, i64, p64, pf32, pf32], None),
        "ogl_isai_build": ([i64, p64, p32, pf32, p64, p32, i64, p32, pu8, pf32], None),
        "ogl_ilut": ([i64, p64, p32, pf, f64, i64, i64, p32, p32, pf, pf], i64),
        "ogl_ict": ([i64, p64, p32, pf, f64, i64, p32, p32, pf, pf], i64),
        "ogl_tri_levels": ([i64, i64, p64, p64, p32], i64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return L


def lib():
    """The loaded ctypes library, or None when it cannot be built or loaded."""
    with _lock:
        if _state["lib"] is not None or _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        try:
            out = _so_path()
        except OSError:
            return None  # source absent (a stripped tree): the NumPy paths
        if not out.is_file() and not _compile(out):
            return None
        try:
            _state["lib"] = _bind(ctypes.CDLL(str(out)))
        except OSError:
            return None
        return _state["lib"]


def available() -> bool:
    return lib() is not None


def init_local_sparsity(n, lower_addr, upper_addr, symmetric):
    """Native LDU -> row-major sparsity: (rows, cols, permute) int32, or None."""
    L = lib()
    if L is None:
        return None
    lower_addr = np.ascontiguousarray(lower_addr, np.int64)
    upper_addr = np.ascontiguousarray(upper_addr, np.int64)
    nf = len(upper_addr)
    nnz = 2 * nf + n
    rows = np.empty(nnz, np.int32)
    cols = np.empty(nnz, np.int32)
    permute = np.empty(nnz, np.int32)
    L.ogl_init_local_sparsity(n, nf, int(bool(symmetric)), lower_addr, upper_addr, rows,
                              cols, permute)
    return rows, cols, permute


def ilu0_csr(n, indptr, cols, vals):
    """ILU(0) of a CSR matrix: the factored values (a copy), or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.ascontiguousarray(vals, np.float64).copy()
    if L.ogl_ilu0(n, indptr, cols, out) != 0:
        raise ZeroDivisionError("ILU(0): zero pivot")
    return out


def ic0_csr(n, indptr, cols, vals):
    """IC(0) on the lower-triangle CSR (diagonal included): L's values, or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.ascontiguousarray(vals, np.float64).copy()
    if L.ogl_ic0(n, indptr, cols, out) != 0:
        raise ZeroDivisionError("IC(0): zero pivot")
    return out


def pgm_aggregate(n, indptr, cols, absvals):
    """Pairwise aggregation: (aggregate of each row int32, count), or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    absvals = np.ascontiguousarray(absvals, np.float64)
    agg = np.empty(n, np.int32)
    nc = L.ogl_pgm_aggregate(n, indptr, cols, absvals, agg)
    return agg, int(nc)


def isai_build(n, a_indptr, a_cols, a_vals, s_indptr, s_cols, k):
    """Batched ISAI extract-and-solve: (J (n, k) int32, valid (n, k) bool,
    M (n, k) float32, the solved approximate-inverse rows), or None.  The
    k x k local systems are solved inside the C++ call, in float64, one
    row at a time: no (n, k, k) batch is materialised."""
    L = lib()
    if L is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, np.int64)
    a_cols = np.ascontiguousarray(a_cols, np.int32)
    a_vals = np.ascontiguousarray(a_vals, np.float32)
    s_indptr = np.ascontiguousarray(s_indptr, np.int64)
    s_cols = np.ascontiguousarray(s_cols, np.int32)
    J = np.empty((n, k), np.int32)
    valid = np.empty((n, k), np.uint8)
    M = np.empty((n, k), np.float32)
    L.ogl_isai_build(n, a_indptr, a_cols, a_vals, s_indptr, s_cols, k, J.reshape(-1),
                     valid.reshape(-1), M.reshape(-1))
    return J, valid.astype(bool), M


def ilut_triples(n, indptr, cols, vals, drop_tol=1e-4, fill_factor=10.0):
    """Threshold ILU: ((L/U strict triples), udiag), or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols32 = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = int(fill_factor * max(len(vals), 1)) + n
    # per-part row cap: total factor fill <= ~fill_factor x nnz(A)
    lfil = max(2, int(fill_factor * max(len(vals), 1) / max(n, 1) / 2))
    orows = np.empty(cap, np.int32)
    ocols = np.empty(cap, np.int32)
    ovals = np.empty(cap, np.float64)
    udiag = np.zeros(n, np.float64)
    cnt = int(L.ogl_ilut(n, indptr, cols32, vals, float(drop_tol), lfil, cap, orows, ocols,
                         ovals, udiag))
    if cnt < 0:
        raise RuntimeError("native ILUT failed (fill overflow or zero pivot)")
    return (orows[:cnt].copy(), ocols[:cnt].copy(), ovals[:cnt].copy()), udiag


def ict_triples(n, indptr, cols, vals, drop_tol=1e-3, fill_factor=10.0):
    """Threshold IC: ((strict-lower triples), ldiag), or None."""
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int64)
    cols32 = np.ascontiguousarray(cols, np.int32)
    vals = np.ascontiguousarray(vals, np.float64)
    cap = int(fill_factor * max(len(vals), 1)) + n
    orows = np.empty(cap, np.int32)
    ocols = np.empty(cap, np.int32)
    ovals = np.empty(cap, np.float64)
    ldiag = np.zeros(n, np.float64)
    cnt = int(L.ogl_ict(n, indptr, cols32, vals, float(drop_tol), cap, orows, ocols, ovals,
                        ldiag))
    if cnt < 0:
        raise RuntimeError("native ICT failed (fill overflow)")
    return (orows[:cnt].copy(), ocols[:cnt].copy(), ovals[:cnt].copy()), ldiag


def tri_levels(rows, cols, n):
    """The dependency level of every row of a strict triangular factor
    (int32 (n,)), or None.  Raises ValueError when the entries are not all
    strictly below or all strictly above the diagonal."""
    L = lib()
    if L is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    level = np.zeros(n, np.int32)
    if L.ogl_tri_levels(n, len(rows), rows, cols, level) < 0:
        raise ValueError("not a strict triangular factor: entries on both sides of the "
                         "diagonal, on it, or outside the matrix")
    return level


def dia_layout(rows, cols, n):
    """Dia entry -> slot layout: (offsets tuple, dest int64), or None."""
    L = lib()
    if L is None or n <= 0 or n >= 2**31:
        return None
    rows32 = np.ascontiguousarray(rows, np.int32)
    cols32 = np.ascontiguousarray(cols, np.int32)
    nnz = len(rows32)
    if nnz == 0:
        return (), np.zeros(0, np.int64)
    present = np.empty(2 * n - 1, np.uint8)
    nd = L.ogl_dia_count(nnz, n, rows32, cols32, present)
    offs = np.empty(nd, np.int64)
    dest = np.empty(nnz, np.int64)
    L.ogl_dia_dest(nnz, n, present, rows32, cols32, offs, dest)
    return tuple(int(o) for o in offs), dest


def dia_pack_f32(dest, vals, nd, n):
    """Scatter-accumulate float32 values through `dest` into (nd, n), or None."""
    L = lib()
    if L is None:
        return None
    dest = np.ascontiguousarray(dest, np.int64)
    vals32 = np.ascontiguousarray(vals, np.float32)
    data = np.empty(nd * n, np.float32)
    L.ogl_dia_pack_f32(len(dest), nd * n, dest, vals32, data)
    return data.reshape(nd, n)


def sort_coo(n, rows, cols):
    """Row-major sort of COO coordinates: (rows32, cols32, perm), or None."""
    L = lib()
    if L is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    nnz = len(rows)
    orows = np.empty(nnz, np.int32)
    ocols = np.empty(nnz, np.int32)
    operm = np.empty(nnz, np.int32)
    L.ogl_sort_coo(nnz, n, rows, cols, orows, ocols, operm)
    return orows, ocols, operm

"""Build and load the port's CUDA C++ kernels (ogl_tpu_torch/kernels/csrc).

Each `*.cu` source compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o build/<hash>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/<hash>/libogl_torch_kernels.so build/<hash>/*.o

The build directory is keyed by a hash of the sources (and the flags), so
an edit rebuilds.  Nothing here runs on import: the first CUDA launch
calls `library()`, which builds if needed and raises if nvcc is missing or
the build fails.  There is no fallback.

Every C entry point takes raw device pointers and the CUDA stream as
`void*` (ctypes.c_void_p — an unannotated Python int would be cut to 32
bits) and returns `cudaGetLastError()` after its launch; `check()` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["library", "check", "build_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
LIB_NAME = "libogl_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float

# name -> argtypes; every entry point returns int (a cudaError_t)
_SIGNATURES = {
    # data, offsets, nd, x, y, n, vec, blocks, stream
    "ogl_dia_spmv": (_P, _P, _INT, _P, _P, _I64, _INT, _I64, _P),
    # data, offsets, nd, z, p, beta, pout, q, partials, n, threads, grid, stream
    "ogl_cg_k1": (_P, _P, _INT, _P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # data, data_bf16, offsets, nd, x, b, invd, relax, out, n, threads, stream
    "ogl_amg_sweep": (_P, _INT, _P, _INT, _P, _P, _P, _F32, _P, _I64, _INT, _P),
    # data, data_bf16, offsets, nd, x, b, out, n, threads, stream
    "ogl_amg_resid": (_P, _INT, _P, _INT, _P, _P, _P, _I64, _INT, _P),
    # cols, vals, vals_bf16, warp_slots, x, b, invd, relax, out, n, blocks, stream
    "ogl_amg_ell_sweep": (_P, _P, _INT, _P, _P, _P, _P, _F32, _P, _I64, _I64, _P),
    # cols, vals, vals_bf16, warp_slots, x, b, out, n, blocks, stream
    "ogl_amg_ell_resid": (_P, _P, _INT, _P, _P, _P, _P, _I64, _I64, _P),
    # vals, vals_bf16, lidx, qoffs, np, r, x, b, invd, relax, out, n, blocks, stream
    "ogl_amg_gdia_sweep": (_P, _INT, _P, _P, _INT, _I64, _P, _P, _P, _F32, _P, _I64, _I64, _P),
    # vals, vals_bf16, lidx, qoffs, np, r, x, b, out, n, blocks, stream
    "ogl_amg_gdia_resid": (_P, _INT, _P, _P, _INT, _I64, _P, _P, _P, _I64, _I64, _P),
    # starts, members, r, rc, nc, blocks, stream
    "ogl_pgm_restrict": (_P, _P, _P, _P, _I64, _I64, _P),
    # x, ec, agg, out, n, blocks, stream
    "ogl_pgm_prolong_add": (_P, _P, _P, _P, _I64, _I64, _P),
    # source_words (5 int64 per source), n_sources, write_words (6 per write), scales,
    # n_writes, flat, blocks, stream
    "ogl_value_update": (ctypes.POINTER(_I64), _INT, ctypes.POINTER(_I64),
                         ctypes.POINTER(_F32), _INT, _P, _I64, _P),
    # vals, lidx, qoffs, np, r, x, y, n, vec, blocks, stream
    "ogl_gdia_spmv": (_P, _P, _P, _INT, _I64, _P, _P, _I64, _INT, _I64, _P),
    # vals, lidx, qoffs, np, r, z, p, beta, pout, q, partials, n, vec, blocks, stream
    "ogl_gdia_k1": (_P, _P, _P, _INT, _I64, _P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, x, y, n,
    # bands, stream
    "ogl_xell_spmv": (_P, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _P, _I64, _I64, _P),
    # vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, z, p, beta,
    # pout, q, partials, n, vec, bands, stream
    "ogl_xell_k1": (_P, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _I64, _INT, _I64, _P),
    # variant, threads, blocks (out)
    "ogl_xell_cg_loop_grid": (_INT, _INT, ctypes.POINTER(_I64)),
    # variant, vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, x, r, z,
    # invd, p, pn, q, rho, absr, nf, partials, record, n, tol, rel_tol, min_iter, max_iter,
    # frequency, vec, threads, blocks, stream
    "ogl_xell_cg_loop": (_INT, _P, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT,
                         _I64, _P),
    # data, offsets, nd, r, invd (NULL = identity), w, partials, n, threads, grid, stream
    "ogl_cg_ka": (_P, _P, _INT, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # data, offsets, nd, a, b, c, rhat, ca, cb, w, q, partials, n, vec, blocks, stream
    "ogl_bicgstab_k1b": (_P, _P, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT,
                         _I64, _P),
    # c, d, nd, y, n, vec, blocks, stream
    "ogl_read_peak": (_P, _P, _INT, _P, _I64, _INT, _I64, _P),
    # alpha, x, r, p, q, invd, z, partials, n, vec, blocks, stream
    "ogl_cg_k2": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # alpha, x, r, p, q, partials, n, vec, blocks, stream
    "ogl_cg_k2i": (_P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # alpha, x, r, p, q, partials, n, vec, blocks, stream
    "ogl_cg_k2n": (_P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # variant, threads, blocks (out)
    "ogl_cg_loop_grid": (_INT, _INT, ctypes.POINTER(_I64)),
    # variant, coef, lidx, offsets, nd, rows, x, r, z, invd, p, pn, q, rho, absr, nf,
    # partials, record, n, tol, rel_tol, min_iter, max_iter, frequency, vec, threads,
    # blocks, stream
    "ogl_cg_loop": (_INT, _P, _P, _P, _INT, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # alpha, beta, w, p, s, x, r, invd (NULL = identity), n, vec, blocks, stream
    "ogl_cg_kb_pipe": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # variant, cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals, x, r, z, invd, p, pn,
    # q, rho, absr, nf, partials, record, n, tol, rel_tol, min_iter, max_iter, frequency,
    # vec, threads, blocks, stream
    "ogl_cg_loop_ell": (_INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # variant, row_ptr, cols, vals, x, r, z, invd, p, pn, q, rho, absr, nf, partials, record,
    # n, tol, rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream
    "ogl_cg_loop_csr": (_INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # variant, table, n_buckets, slice_buckets, slice_widths, slot_rows, cols, vals, slots,
    # slice_height, x, r, z, invd, p, pn, q, rho, absr, nf, partials, record, n, tol,
    # rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream
    "ogl_cg_loop_sell": (_INT, _P, _INT, _P, _P, _P, _P, _P, _I64, _INT, _P, _P, _P, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P, _I64, _F32, _F32, _INT, _INT, _INT, _INT,
                         _INT, _I64, _P),
    # variant, threads, blocks (out)
    "ogl_cg_pipe_loop_grid": (_INT, _INT, ctypes.POINTER(_I64)),
    # variant, data, offsets, nd, invd, x, r, p, s, w, nf, partials, record, n, tol,
    # rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream
    "ogl_cg_pipe_loop": (_INT, _P, _P, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _F32,
                         _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # alpha, omega, x, p, s, t, rhat, r, partials, n, vec, blocks, stream
    "ogl_bicgstab_kb_update": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # variant (0), threads, blocks (out)
    "ogl_bicgstab_loop_grid": (_INT, _INT, ctypes.POINTER(_I64)),
    # data, offsets, nd, rhat, x, r, p, pn, v, vn, s, t, rho, absr, nf, partials, record, n,
    # tol, rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream
    "ogl_bicgstab_loop": (_P, _P, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # variant, threads, blocks (out)
    "ogl_bicgstab_gen_loop_grid": (_INT, _INT, ctypes.POINTER(_I64)),
    # variant, coef, lidx, offsets, nd, rows, invd (block Jacobi: inv_t), bs, rhat, x, r, p,
    # pn, v, vn, s, t, y, z, rho, absr, nf, partials, record, n, tol, rel_tol, min_iter,
    # max_iter, frequency, vec, threads, blocks, stream
    "ogl_bicgstab_gen_loop": (_INT, _P, _P, _P, _INT, _I64, _P, _INT, *(_P,) * 16, _I64, _F32,
                              _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # variant, vals, ll, bbT, n_slots, c_left, sp_ptr, sp_cols, sp_gidx, sp_vals, invd, bs,
    # rhat, x, r, p, pn, v, vn, s, t, y, z, rho, absr, nf, partials, record, n, tol, rel_tol,
    # min_iter, max_iter, frequency, vec, threads, blocks, stream
    "ogl_bicgstab_gen_loop_xell": (_INT, _P, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _INT,
                                   *(_P,) * 16, _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT,
                                   _I64, _P),
    # variant, cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals, invd, bs, rhat, x, r, p,
    # pn, v, vn, s, t, y, z, rho, absr, nf, partials, record, n, tol, rel_tol, min_iter,
    # max_iter, frequency, vec, threads, blocks, stream
    "ogl_bicgstab_gen_loop_ell": (_INT, _P, _P, _P, _P, _P, _P, _P, _INT, *(_P,) * 16, _I64,
                                  _F32, _F32, _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # variant, row_ptr, cols, vals, invd, bs, rhat, x, r, p, pn, v, vn, s, t, y, z, rho, absr,
    # nf, partials, record, n, tol, rel_tol, min_iter, max_iter, frequency, vec, threads,
    # blocks, stream
    "ogl_bicgstab_gen_loop_csr": (_INT, _P, _P, _P, _P, _INT, *(_P,) * 16, _I64, _F32, _F32,
                                  _INT, _INT, _INT, _INT, _INT, _I64, _P),
    # variant, table, n_buckets, slice_buckets, slice_widths, slot_rows, cols, vals, slots,
    # slice_height, invd, bs, rhat, x, r, p, pn, v, vn, s, t, y, z, rho, absr, nf, partials,
    # record, n, tol, rel_tol, min_iter, max_iter, frequency, vec, threads, blocks, stream
    "ogl_bicgstab_gen_loop_sell": (_INT, _P, _INT, _P, _P, _P, _P, _P, _I64, _INT, _P, _INT,
                                   *(_P,) * 16, _I64, _F32, _F32, _INT, _INT, _INT, _INT, _INT,
                                   _I64, _P),
    # inv_t, r, y, n, bs, blocks, stream
    "ogl_block_jacobi": (_P, _P, _P, _I64, _INT, _I64, _P),
    # bf16, threads, smem, blocks (out)
    "ogl_gmres_arnoldi_grid": (_INT, _INT, _I64, ctypes.POINTER(_I64)),
    # bf16, V, ld, w, vnext, h, partials, n, j, tiny, slice, resident, stages, w_resident,
    # hint, blocks, smem, stream
    "ogl_gmres_arnoldi": (_INT, _P, _I64, _P, _P, _P, _P, _I64, _INT, _F32, _I64, _INT, _INT,
                          _INT, _INT, _I64, _I64, _P),
    # bf16, blocks (out)
    "ogl_gmres_combine_grid": (_INT, ctypes.POINTER(_I64)),
    # bf16, V, ld, y, j, out, n, blocks, stream
    "ogl_gmres_combine": (_INT, _P, _I64, _P, _INT, _P, _I64, _I64, _P),
    # blocks (out), capacity (out)
    "ogl_tri_sweep_grid": (ctypes.POINTER(_I64), ctypes.POINTER(_I64)),
    # l_ptr, l_cols, l_vals, l_d, kl, l_bounds, l_held, u_ptr, u_cols, u_vals, u_d, ku,
    # u_bounds, u_held, r, t0, t1, out, n, blocks, capacity, stream
    "ogl_tri_sweep": (_P, _P, _P, _P, _INT, _P, _P, _P, _P, _P, _P, _INT, _P, _P, _P, _P, _P,
                      _P, _I64, _I64, _I64, _P),
    # block, threads, blocks (out)
    "ogl_tri_levels_grid": (_INT, _INT, ctypes.POINTER(_I64)),
    # l_ptr, l_src, l_vals, l_rows, l_inv, l_d, u_ptr, u_src, u_vals, u_rows, u_inv, u_d, r,
    # out, l_words, u_words, epoch, sleep_ns, limit_ns, block, n, threads, blocks, stream
    "ogl_tri_levels": (*(_P,) * 16, _I64, _INT, _I64, _INT, _I64, _INT, _I64, _P),
    # row_ptr, cols, vals, x, y, n, group, blocks, stream
    "ogl_csr_spmv": (_P, _P, _P, _P, _P, _I64, _INT, _I64, _P),
    # cols, vals, warp_slots, tail_ptr (NULL = no tail), tail_cols, tail_vals, x, y, n,
    # blocks, stream
    "ogl_ell_spmv": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P),
    # table, n_buckets, slice_buckets, slice_widths, slot_rows, cols, vals, slots,
    # slice_height, x, y, n, blocks, stream
    "ogl_sell_spmv": (_P, _INT, _P, _P, _P, _P, _P, _I64, _INT, _P, _P, _I64, _I64, _P),
    # variant, threads, smem, blocks (out)
    "ogl_amg_loop_grid": (_INT, _INT, _I64, ctypes.POINTER(_I64)),
    # variant, table, levels, outer (8 int64 words on the host), x, r, z, p, pn, q, absr, nf,
    # partials, record, n, vec, relax, sweeps, tol, rel_tol, min_iter, max_iter, frequency,
    # threads, blocks, smem, stream
    "ogl_amg_loop": (_INT, _P, _INT, ctypes.POINTER(_I64), _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _P, _I64, _INT, _F32, _INT, _F32, _F32, _INT, _INT, _INT, _INT, _I64, _I64,
                     _P),
}

_lock = threading.Lock()
_state: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc" if cand else None
        if p is not None and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the port's CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _start(cmd: list, name: str) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True), time.perf_counter(), name


def _wait(procs: list) -> str:
    """Wait for every (cmd, Popen, start, name) of _start, each in a thread
    of its own; raise on the first that failed; returns their joined output,
    each followed by a line `nvcc seconds: <name> <s>` (its wall time)."""
    def finish(item):
        _, proc, t0, _ = item
        return proc.communicate(), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        done = list(pool.map(finish, procs))
    log = []
    for (cmd, proc, _, name), ((stdout, stderr), sec) in zip(procs, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{stdout}\n{stderr}")
        log.append(f"{stdout}{stderr}nvcc seconds: {name} {sec:.1f}\n")
    return "".join(log)


def _build(out: Path) -> str:
    """Compile every .cu with its own nvcc, all at once, then link into
    `out` (written atomically); returns nvcc's output (-Xptxas -v:
    registers, shared memory and spills per kernel)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.suffix == ".cu"]
    objs = [str(out.parent / f"{s.stem}.o") for s in cu]
    log = _wait([_start([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(s)], s.name)
                 for s, o in zip(cu, objs)])
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        log += _wait([_start([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs], "link")])
    except RuntimeError:
        os.unlink(tmp)
        raise
    os.replace(tmp, out)
    (out.parent / "build.log").write_text(log)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from csrc/ on first use."""
    with _lock:
        lib = _state.get("lib")
        if lib is not None:
            return lib
        out = BUILD / _source_hash() / LIB_NAME
        t0 = time.perf_counter()
        built = not out.is_file()
        if built:
            log = _build(out)
        else:
            log_file = out.parent / "build.log"
            log = log_file.read_text() if log_file.is_file() else ""
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ogl_error_string.argtypes = (ctypes.c_int,)
        lib.ogl_error_string.restype = ctypes.c_char_p
        _state.update(lib=lib, path=str(out), built=built, log=log,
                      seconds=time.perf_counter() - t0)
        return lib


def build_info() -> dict:
    """Where the library came from: path, whether this process built it,
    the seconds build+load took and nvcc's -Xptxas -v report."""
    library()
    return {k: _state[k] for k in ("path", "built", "seconds", "log")}


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        name = library().ogl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({name}) at launch")

"""Where the time of the AMG loop kernel goes, phase by phase, on the card.

    python -m ogl_tpu_torch.amg_phases

Builds the kernel of `kernels/csrc/amg_loop.cuh` once more with a stamp of
%globaltimer (block 0, thread 0) at the start of the launch and after every
grid barrier, its Dia outer's variants and the mixed ones on the Csr and
Gdia outers with amg_loop.cu's entry points, into its own library under
`kernels/build/phases/`, and runs 3
pinned iterations of the CG and the IR variant (bfloat16 smoother
coefficients) on two kinds of hierarchy: the `auto` hierarchy of
`testing.poisson_ldu` (Dia levels, Dia outer) at 1,048,576 cells and at
64×64×48, and GKOCG + Multigrid on the RCM-numbered kNN-6 mesh of
1,048,576 cells as Csr (`pKMG` of chip_smoke.py: Ell levels, natural
transfers, a Dia coarsest level) and GKOCG + Multigrid on the shuffled
grid of 1,048,576 cells as Gdia (`pSMG`: a Gdia fine level), each with the
levels staged and with the register and direct bodies (`unstaged`: the
same table with no Ell level staged).  It prints, for each
phase in the kernel's order, the microseconds from the barrier before it to the barrier
after it (the phase's work and its barrier), the median over the pinned
iterations, and then the stamped and the package's own kernel per
iteration over 50 pinned iterations (CUDA events), which shows what the
stamps cost.  Needs a card; nothing else of the package uses this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess

import numpy as np
import torch

from ogl_tpu_torch import testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import _build, amg_loop, gdia
from ogl_tpu_torch.kernels.fused import CgKernels, GdiaCgKernels
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels
from ogl_tpu_torch.precond import amg
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

GRIDS = ((128, 128, 64), (64, 64, 48))
KNN_CELLS = 1 << 20  # the kNN-6 mesh of pKMG (chip_smoke.py phase 14)
STAGE_FIELD = 22  # a level's slots per staged Ell chunk in the table (amg_loop.LevelTable)
PINNED, TIMED = 3, 50
STAMP = """
__device__ unsigned long long g_stamp[1024];
__device__ int g_nstamp;
__device__ __forceinline__ void stamp() {
  if (blockIdx.x == 0 && threadIdx.x == 0 && g_nstamp < 1024) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[g_nstamp++] = t;
  }
}
extern "C" int ogl_phase_stamps(unsigned long long* out, int* n) {
  cudaMemcpyFromSymbol(out, g_stamp, sizeof(unsigned long long) * 1024);
  cudaMemcpyFromSymbol(n, g_nstamp, sizeof(int));
  const int zero = 0;
  cudaMemcpyToSymbol(g_nstamp, &zero, sizeof(int));
  return static_cast<int>(cudaGetLastError());
}
"""
_ANCHORS = ("namespace cg = cooperative_groups;\n", "grid.sync();",
            "  __syncthreads();\n\n  const int blocks = gridDim.x;")


def stamped_source(src: str) -> str:
    """amg_loop.cuh with a stamp at the launch's start and after every
    grid.sync(); raises if the source no longer has the anchors."""
    for a in _ANCHORS:
        if a not in src:
            raise RuntimeError(f"amg_loop.cuh has no {a!r}: update amg_phases.py")
    src = src.replace(_ANCHORS[0], _ANCHORS[0] + STAMP, 1)
    src = src.replace(_ANCHORS[1], "grid.sync(); stamp();")
    return src.replace(_ANCHORS[2], _ANCHORS[2].replace("\n\n", "\n  stamp();\n\n"))


# the stamped library's variants: the Dia outer's (amg_loop.cu), and the
# mixed ones on the Csr and Gdia outers (the Ell outer's are left out: their
# entries return no kernel)
_OUTERS = ("OGL_AMG_LOOP_KERNELS(loop_kernel_csr_cg, ogl::amg::kOuterCsr)\n"
           "OGL_AMG_LOOP_KERNELS(loop_kernel_csr_ir, ogl::amg::kOuterCsr | ogl::amg::kIr)\n"
           "OGL_AMG_LOOP_KERNELS(loop_kernel_gdia_cg, ogl::amg::kOuterGdia)\n"
           "OGL_AMG_LOOP_KERNELS(loop_kernel_gdia_ir, ogl::amg::kOuterGdia | ogl::amg::kIr)\n"
           "namespace ogl {\nnamespace amg {\n"
           + "".join(f"const void* loop_kernel_{k}(int) {{ return nullptr; }}\n"
                     for k in ("ell_cg", "ell_ir"))
           + "}\n}\n")


def build() -> ctypes.CDLL:
    header = stamped_source((_build.CSRC / "amg_loop.cuh").read_text())
    unit = (_build.CSRC / "amg_loop.cu").read_text() + _OUTERS
    out = _build.BUILD / "phases" / hashlib.sha256((header + unit).encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    (out / "amg_loop.cuh").write_text(header)  # found before csrc/'s by the unit's include
    (out / "amg_loop.cu").write_text(unit)
    lib_path = out / "lib.so"
    if not lib_path.is_file():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                        "-o", str(lib_path), str(out / "amg_loop.cu")], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ogl_amg_loop_grid", "ogl_amg_loop"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ogl_phase_stamps.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    lib.ogl_phase_stamps.restype = ctypes.c_int
    return lib


def phase_names(op, ir: bool, iters: int) -> list[str]:
    """The kernel's barriers in order, named (csrc/amg_loop.cuh vcycle)."""
    s, nlev = op.smooth_iters, len(op.state)
    cycle = []
    for lv in range(nlev - 1):
        if s >= 2:
            cycle += [f"l{lv} sweep (x1 folded)"] + [f"l{lv} sweep"] * (s - 2)
        cycle.append(f"l{lv} residual + restrict")
    cycle.append(f"l{nlev - 1} coarse inv . b (+ prolong)")
    for lv in range(nlev - 2, -1, -1):
        cycle += [f"l{lv} sweep"] * (s - 1)
        cycle.append(f"l{lv} sweep + prolong" if lv else "l0 last sweep: " +
                     ("z, x += z" if ir else "z, r.z"))
    if ir:
        return (cycle + ["IR residual r - A z"]) * iters
    return cycle + (["K1", "K2n"] + cycle) * (iters - 1) + ["K1", "K2n"]


def launch(lib, kern, data, op, x, r, absr, nf, cfg, ir):
    """amg_loop._launch through `lib`."""
    amg_loop._launch("amg_ir_loop" if ir else "amg_cg_loop", kern, data, op, x, r, absr, nf,
                     cfg, lib=lib)


def unstaged(op) -> amg_loop.LevelTable:
    """op's level table with no level staged: every Ell level's stage
    column (its slots per staged chunk) 0, the register body, and no dynamic
    shared memory."""
    tab = amg_loop.LevelTable(op.state)
    tab.table[:, STAGE_FIELD] = 0
    tab.smem = 0
    return tab


def per_iteration_ms(fn, reps=5) -> float:
    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / TIMED)
    return statistics.median(times)


def systems(dev):
    """(label, plan, packed values, AmgOp) of each hierarchy measured: the
    Poisson grids' Dia hierarchies, then pKMG's (kNN-6 mesh as Csr)."""
    for grid in GRIDS:
        coo = ldu.ldu_to_coo_host(testing.poisson_ldu(grid), dtype=np.float32)
        mat = formats.coo_to_dia(coo, dev)
        kern = CgKernels(mat.shape[0], mat.offsets, dev)
        op = amg.amg(coo, dev, aggregation="auto", smoother_dtype=torch.bfloat16)
        yield "x".join(map(str, grid)), kern, kern.pack_values(mat), op
    mo, perm = testing.knn_ldu(KNN_CELLS)
    coo = ldu.ldu_to_coo_host(testing.renumber_ldu(mo, np.argsort(perm)), dtype=np.float32)
    mat = formats.coo_to_csr(coo, dev)
    kern = CsrCgKernels(mat)
    op = amg.amg(coo, dev, max_levels=9, min_coarse_rows=10, aggregation="auto",
                 smoother_dtype=torch.bfloat16)
    yield f"pKMG kNN-6 {KNN_CELLS} as Csr", kern, kern.pack_values(mat), op
    op.loop_table = unstaged(op)
    yield f"pKMG kNN-6 {KNN_CELLS} as Csr, unstaged", kern, kern.pack_values(mat), op
    coo = ldu.ldu_to_coo_host(testing.shuffled_poisson_ldu(GRIDS[0]), dtype=np.float32)
    mat = gdia.gdia_from_coo(coo, device=dev)
    kern = GdiaCgKernels(mat.shape[0], mat.plane_offsets, dev)
    op = amg.amg(coo, dev, max_levels=9, min_coarse_rows=10, aggregation="auto",
                 smoother_dtype=torch.bfloat16)
    yield f"pSMG shuffled {mat.shape[0]} as Gdia", kern, kern.pack_values(mat), op
    op.loop_table = unstaged(op)
    yield f"pSMG shuffled {mat.shape[0]} as Gdia, unstaged", kern, kern.pack_values(mat), op


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("amg_phases needs an NVIDIA GPU")
    dev = torch.device("cuda")
    lib = build()
    buf, count = (ctypes.c_ulonglong * 1024)(), ctypes.c_int()
    for label, kern, data, op in systems(dev):
        b = torch.randn(kern.n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        x0 = torch.zeros_like(b)
        r0 = b - kern.apply(data, x0)
        state = (torch.sum(torch.abs(r0)), merged_norm_factor(kern, data, r0, x0, b))
        levels = ", ".join(f"{type(lv.mat).__name__} {lv.n}" for lv in op.state)
        print(f"== {label}: levels {levels}, bfloat16 smoother coefficients, "
              f"{amg_loop.table_of(op).smem} bytes of staged shared memory")
        for ir in (False, True):
            name = "amg_ir_loop" if ir else "amg_cg_loop"
            pinned = stopping.StoppingParams(0.0, 0.0, PINNED, PINNED, 1)
            lib.ogl_phase_stamps(buf, ctypes.byref(count))  # resets the count
            launch(lib, kern, data, op, x0.clone(), r0.clone(), *state, pinned, ir)
            torch.cuda.synchronize()
            _build.check(lib.ogl_phase_stamps(buf, ctypes.byref(count)), "stamps")
            t = list(buf[:count.value])
            names = phase_names(op, ir, PINNED)
            if len(t) != len(names) + 1:
                raise RuntimeError(f"{len(t)} stamps for {len(names)} phases")
            by: dict = {}
            for i, nm in enumerate(names):
                by.setdefault(nm, []).append((t[i + 1] - t[i]) / 1e3)
            total = 0.0  # each name's median times its count per iteration
            for nm, v in by.items():
                med = statistics.median(v)
                total += med * len(v) / PINNED
                print(f"  {name} {label} {nm:34s} {med:7.1f} us  (x{len(v)})")
            timed = stopping.StoppingParams(0.0, 0.0, TIMED, TIMED, 1)
            loop = amg_loop.amg_ir_loop if ir else amg_loop.amg_cg_loop
            ms_stamped = per_iteration_ms(lambda: launch(lib, kern, data, op, x0.clone(),
                                                         r0.clone(), *state, timed, ir))
            ms_package = per_iteration_ms(lambda: loop(kern, data, op, x0.clone(), r0.clone(),
                                                       *state, timed))
            print(f"  {name} {label}: phases sum to {total:.1f} us per iteration; over {TIMED} "
                  f"pinned iterations {ms_stamped:.4f} ms stamped, {ms_package:.4f} ms the "
                  "package's kernel")
        del kern, data, op
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

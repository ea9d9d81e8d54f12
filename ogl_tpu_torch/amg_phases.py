"""Where the time of the AMG loop kernel goes, phase by phase, on the card.

    python -m ogl_tpu_torch.amg_phases

Builds `kernels/csrc/amg_loop.cu` once more with a stamp of %globaltimer
(block 0, thread 0) at the start of the launch and after every grid
barrier, into its own library under `kernels/build/phases/`, and runs 3
pinned iterations of the CG and the IR variant (bfloat16 smoother
coefficients, the `auto` hierarchy of `testing.poisson_ldu`) at 1,048,576
cells and at 64×64×48.  It prints, for each phase in the kernel's order,
the microseconds from the barrier before it to the barrier after it (the
phase's work and its barrier), the median over the pinned iterations, and
then the stamped and the package's own kernel per iteration over 50 pinned
iterations (CUDA events), which shows what the stamps cost.  Needs a card;
nothing else of the package uses this module.
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
from ogl_tpu_torch.kernels import _build, amg_loop
from ogl_tpu_torch.kernels.fused import LOOP_THREADS, CgKernels
from ogl_tpu_torch.precond import amg
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

GRIDS = ((128, 128, 64), (64, 64, 48))
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
    """amg_loop.cu with a stamp at the launch's start and after every
    grid.sync(); raises if the source no longer has the anchors."""
    for a in _ANCHORS:
        if a not in src:
            raise RuntimeError(f"amg_loop.cu has no {a!r}: update amg_phases.py")
    src = src.replace(_ANCHORS[0], _ANCHORS[0] + STAMP, 1)
    src = src.replace(_ANCHORS[1], "grid.sync(); stamp();")
    return src.replace(_ANCHORS[2], _ANCHORS[2].replace("\n\n", "\n  stamp();\n\n"))


def build() -> ctypes.CDLL:
    src = stamped_source((_build.CSRC / "amg_loop.cu").read_text())
    out = _build.BUILD / "phases" / hashlib.sha256(src.encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    (out / "amg_loop.cu").write_text(src)
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
    """The kernel's barriers in order, named (csrc/amg_loop.cu vcycle)."""
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
    tab = amg_loop.table_of(op)
    variant = tab.variant | (amg_loop.VARIANT_IR if ir else 0)
    blocks = ctypes.c_int64()
    _build.check(lib.ogl_amg_loop_grid(variant, LOOP_THREADS, ctypes.byref(blocks)), "grid")
    nb = min(blocks.value, -(-kern.n // LOOP_THREADS))
    z = torch.empty_like(x)
    p, pn, q = ((None,) * 3 if ir else
                (torch.zeros_like(x), torch.empty_like(x), torch.empty_like(x)))
    partials = torch.empty(3 * nb, device=x.device)
    record = torch.empty(4, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.check(lib.ogl_amg_loop(
        variant, tab.table.data_ptr(), tab.n_levels, data.data_ptr(),
        kern.plan.offsets_dev.data_ptr(), len(kern.offsets), x.data_ptr(), r.data_ptr(),
        z.data_ptr(), ptr(p), ptr(pn), ptr(q), absr.data_ptr(), nf.data_ptr(),
        partials.data_ptr(), record.data_ptr(), kern.n, int(kern.n % 4 == 0), op.relax,
        op.smooth_iters, cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter,
        cfg.frequency, LOOP_THREADS, nb, torch.cuda.current_stream().cuda_stream), "amg_loop")


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("amg_phases needs an NVIDIA GPU")
    dev = torch.device("cuda")
    lib = build()
    buf, count = (ctypes.c_ulonglong * 1024)(), ctypes.c_int()
    for grid in GRIDS:
        coo = ldu.ldu_to_coo_host(testing.poisson_ldu(grid), dtype=np.float32)
        mat = formats.coo_to_dia(coo, dev)
        kern = CgKernels(mat.shape[0], mat.offsets, dev)
        data = kern.pack_values(mat)
        op = amg.amg(coo, dev, aggregation="auto", smoother_dtype=torch.bfloat16)
        b = torch.randn(kern.n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        x0 = torch.zeros_like(b)
        r0 = b - kern.apply(data, x0)
        state = (torch.sum(torch.abs(r0)), merged_norm_factor(kern, data, r0, x0, b))
        label = "x".join(map(str, grid))
        print(f"== {label}: levels {[lv.n for lv in op.state]}, bfloat16 smoother coefficients")
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the time of one Arnoldi step goes on the card.

    python -m ogl_tpu_torch.arnoldi_phases

Builds `kernels/csrc/gmres.cu` once more over a copy of
`kernels/csrc/gmres_arnoldi.cuh` stamped with %globaltimer in CTA 0 (the
start and end of the step; at each pass the end of its steps, of the CTA's
sums, of the grid barrier and of the totals; consumer thread 0's time
waiting for its stages and computing them; the producer's time waiting for
free stages), into its own library under `kernels/build/arnoldi_phases/`.
It runs the step at j = 99 on orthonormal rows (chip_smoke.arnoldi_inputs'
recipe) at 262,144, 1,048,576 and 8,388,608 rows in float32 and bfloat16
with the plan of `kernels/gmres.py arnoldi_plan` and prints the breakdown.
Needs a card; nothing else of the package uses this module.
"""

from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess

import torch

from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels import gmres as gk

J = 99
SIZES = (1 << 18, 1 << 20, 1 << 23)
STAMP = """
__device__ unsigned long long g_arnoldi_stamp[256];
__device__ __forceinline__ unsigned long long arnoldi_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define ARNOLDI_STAMP(i, v) \\
  if (blockIdx.x == 0 && threadIdx.x == 0) g_arnoldi_stamp[i] = (v)
"""
# anchor -> what replaces it (each anchor must occur once)
_EDITS = {
    "namespace ogl {\nnamespace arnoldi {":
        STAMP + "namespace ogl {\nnamespace arnoldi {",
    "  float hp[kRows];  // h of the block the next pass subtracts\n":
        "  unsigned long long t_wait = 0, t_comp = 0, t_pw = 0;\n"
        "  ARNOLDI_STAMP(0, arnoldi_now());\n"
        "  float hp[kRows];  // h of the block the next pass subtracts\n",
    "        if (issued >= D && pl_lane == 0) tma::wait(empty + q.stage, q.parity ^ 1u);":
        "        if (issued >= D && pl_lane == 0) {\n"
        "          const unsigned long long a = arnoldi_now();\n"
        "          tma::wait(empty + q.stage, q.parity ^ 1u);\n"
        "          t_pw += arnoldi_now() - a;\n"
        "        }",
    "        tma::wait(full + stage, parity);\n        if (m > 0) {":
        "        const unsigned long long ta = arnoldi_now();\n"
        "        tma::wait(full + stage, parity);\n"
        "        const unsigned long long tb = arnoldi_now();\n"
        "        t_wait += tb - ta;\n"
        "        if (m > 0) {",
    "        __syncwarp();  // the warp is done with step t's pieces":
        "        t_comp += arnoldi_now() - tb;\n"
        "        __syncwarp();  // the warp is done with step t's pieces",
    "      float* part = partials + static_cast<int64_t>(pass & 1) * kRows * gridDim.x;\n"
    "      if (pass < nblk) {\n"
    "        cta_sums<kRows>(acc, sm.red, part);\n"
    "        grid.sync();\n"
    "        cta_totals<kRows>(part, sm.tot, hp);":
        "      float* part = partials + static_cast<int64_t>(pass & 1) * kRows * gridDim.x;\n"
        "      ARNOLDI_STAMP(8 + 4 * pass, arnoldi_now());\n"
        "      if (pass < nblk) {\n"
        "        cta_sums<kRows>(acc, sm.red, part);\n"
        "        ARNOLDI_STAMP(9 + 4 * pass, arnoldi_now());\n"
        "        grid.sync();\n"
        "        ARNOLDI_STAMP(10 + 4 * pass, arnoldi_now());\n"
        "        cta_totals<kRows>(part, sm.tot, hp);\n"
        "        ARNOLDI_STAMP(11 + 4 * pass, arnoldi_now());",
    "    if (blockIdx.x == 0 && tid == 0) h[live] = wnorm;\n":
        "    if (blockIdx.x == 0 && tid == 0) h[live] = wnorm;\n"
        "    ARNOLDI_STAMP(1, arnoldi_now());\n"
        "    ARNOLDI_STAMP(2, t_wait);\n"
        "    ARNOLDI_STAMP(3, t_comp);\n",
    "  __syncthreads();  // every wait is over, every arrival made":
        "  if (blockIdx.x == 0 && threadIdx.x == kConsumers) g_arnoldi_stamp[4] = t_pw;\n"
        "  __syncthreads();  // every wait is over, every arrival made",
}
_READ = """
extern "C" int ogl_arnoldi_stamps(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_arnoldi_stamp, sizeof(unsigned long long) * 256));
}
"""


def stamped_source(header: str) -> str:
    """gmres_arnoldi.cuh with the stamps; raises if the header no longer
    has an anchor."""
    for anchor, repl in _EDITS.items():
        if header.count(anchor) != 1:
            raise RuntimeError(f"gmres_arnoldi.cuh has {header.count(anchor)} of {anchor!r}: "
                               "update arnoldi_phases.py")
        header = header.replace(anchor, repl)
    return header


def build() -> ctypes.CDLL:
    """The stamped library (its own header first on the include path)."""
    header = stamped_source((_build.CSRC / "gmres_arnoldi.cuh").read_text())
    cu = (_build.CSRC / "gmres.cu").read_text() + _READ
    out = _build.BUILD / "arnoldi_phases" / hashlib.sha256(
        (header + cu).encode()).hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    (out / "gmres_arnoldi.cuh").write_text(header)
    (out / "gmres.cu").write_text(cu)
    lib_path = out / "lib.so"
    if not lib_path.is_file():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(out), "-I", str(_build.CSRC),
                        "-shared", "-o", str(lib_path), str(out / "gmres.cu")], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ogl_gmres_arnoldi_grid", "ogl_gmres_arnoldi"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ogl_arnoldi_stamps.argtypes = (ctypes.c_void_p,)
    lib.ogl_arnoldi_stamps.restype = ctypes.c_int
    return lib


def inputs(n: int, dtype, device, g):
    """Rows 0..J+1 orthonormal (a QR of seeded normals) and w = V[0..J]ᵀc + e
    (chip_smoke.arnoldi_inputs)."""
    q, _ = torch.linalg.qr(torch.randn((n, J + 2), device=device, generator=g))
    V = gk.new_basis(J + 1, n, dtype, device)
    V[:J + 2, :n] = q.t().to(dtype)
    del q
    c = 0.3 * torch.randn(J + 1, device=device, generator=g)
    w = V[:J + 1, :n].float().t() @ c + torch.randn(n, device=device, generator=g) / n ** 0.5
    return V, w


def launch(lib, V, w, h, partials, plan: gk.ArnoldiPlan) -> None:
    """One step at J through `lib` with `plan`."""
    n = w.shape[0]
    _build.check(lib.ogl_gmres_arnoldi(
        int(V.dtype == torch.bfloat16), V.data_ptr(), V.shape[1], w.data_ptr(),
        V[J + 1].data_ptr(), h.data_ptr(), partials.data_ptr(), n, J, gk.TINY, plan.slice,
        plan.resident, plan.stages, int(plan.w_resident), int(plan.hint), plan.ctas, plan.smem,
        torch.cuda.current_stream().cuda_stream), "gmres_arnoldi")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("arnoldi_phases needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = build()
    stamps = (ctypes.c_ulonglong * 256)()
    for n in SIZES:
        for dt in (torch.float32, torch.bfloat16):
            bf16 = dt == torch.bfloat16
            plan = gk.arnoldi_plan(n, bf16, sms)
            blocks = ctypes.c_int64()
            _build.check(lib.ogl_gmres_arnoldi_grid(int(bf16), gk.ARNOLDI_THREADS, plan.smem,
                                                    ctypes.byref(blocks)), "grid")
            V, w = inputs(n, dt, dev, g)
            h = torch.zeros(J + 2, device=dev)
            partials = torch.empty(2 * gk.BLOCK * plan.ctas, device=dev)
            for _ in range(3):
                launch(lib, V, w.clone(), h, partials, plan)
            torch.cuda.synchronize()
            _build.check(lib.ogl_arnoldi_stamps(stamps), "stamps")
            t0 = stamps[0]
            passes = (J + 1 + gk.BLOCK - 1) // gk.BLOCK  # those with a grid barrier
            at = [stamps[8 + 4 * p] for p in range(passes)]
            per_pass = statistics.median((b - a) / 1e3 for a, b in zip(at, at[1:]))
            sums, syncs, totals = (statistics.median(
                (stamps[8 + 4 * p + k + 1] - stamps[8 + 4 * p + k]) / 1e3
                for p in range(passes)) for k in range(3))
            print(f"{n} rows {str(dt)[6:]} j {J}: plan {plan.resident} rows held, {plan.stages} "
                  f"stages, w held {plan.w_resident}, hint {plan.hint}, {plan.chunks} steps a "
                  f"pass; CTA 0 {(stamps[1] - t0) / 1e3:.1f} us: consumer thread 0 waited "
                  f"{stamps[2] / 1e3:.1f} us for its stages and computed {stamps[3] / 1e3:.1f} us "
                  f"over {(passes + 1) * plan.chunks} steps, the producer waited "
                  f"{stamps[4] / 1e3:.1f} us for free stages; a pass {per_pass:.2f} us (median), "
                  f"of which the CTA's sums {sums:.2f}, the grid barrier {syncs:.2f}, the "
                  f"totals {totals:.2f}")
            del V, w
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

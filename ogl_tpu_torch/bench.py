"""The headline lanes of the reference's bench on the port, on one card.

    python -m ogl_tpu_torch.bench

Counterpart: bench.py of the reference (`_slope_timed`, `main`'s headline
lanes, `_device_busy_of`, `_poisson_dia`, the per-step lane of
`_foam_large_benches`).  In order:

  1. SpMV roofline: the Dia SpMV kernel chained at 256x256x128 =
     8,388,608 rows (working set ≈ 302 MB, beyond the 50 MB L2), timed by
     `roofline.measure_chained` (a replayed CUDA graph, CUDA events),
     against the denominator max(published, triad, read-dominant peak),
     calibrated on every run; a fraction above 1.05 raises.  Cross-checked
     on the device timeline against the read peak on the same clock.
  2. CG 1M: the merged CG (preconditioner none; on the card one launch of
     the persistent loop kernel, K1 and K2i its phases) on b = A·x_true,
     time/iter and time/iter/DOF by slope timing; the reference's JSON
     line; the implied bandwidth; the device-timeline cross-check.
  3. CG 8.4M: the same at 8,388,608 rows, with the minimum bytes of its
     two phases per iteration.
  4. The foam per-step lane: GKOCG's first solve at 1M, three steady
     steps (upper and diag nudged), the phase split, the device-only
     solve (`FoamSolver.time_device_solve`), three diag-only steps that
     upload (1, 2) blocks.

Every lane checks its own results and raises: the solves must converge
with a true float64 residual within 10x the tolerance, and every fraction
of a peak must be at most 1.05.  Nothing catches a failing lane.  On the
CPU (`run(torch.device("cpu"), ...)`, the tests' rehearsal) the lanes run
the plain kernels on the host clock, and no number is printed under a
device's name.  Without CUDA, `main()` exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ogl_tpu_torch import foam, registry, testing
from ogl_tpu_torch.core import formats
from ogl_tpu_torch.kernels import device_time, roofline
from ogl_tpu_torch.kernels.dia_spmv import DiaPlan, dia_spmv, dia_spmv_plain
from ogl_tpu_torch.kernels.fused import CgKernels
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.cg_fused import cg_fused

__all__ = ["run", "main", "GRID_1M", "GRID_8M"]

GRID_1M = (128, 128, 64)
GRID_8M = (256, 256, 128)
TOL = 1e-6
TRUE_RESIDUAL_MARGIN = 10.0  # float32 recurrence vs the float64 residual of x
PEAK_FRACTION_LIMIT = 1.05  # above: a fault of the measurement, never a result
L2_MB = 50.0  # the H100's L2
# the device-timeline chains: enough device time for the union of event
# intervals, few enough events for the profiler to parse them in seconds
DEVICE_ITERS = 300
DEVICE_SECONDS = 0.05


def log(line: str) -> None:
    print(line, flush=True)


def _poisson_dia(dims, device) -> formats.Dia:
    """The 7-point Dirichlet-pinned Poisson Dia operator, built analytically
    in numpy (equal to coo_to_dia(ldu_to_coo_host(poisson_ldu(dims)))) and
    uploaded once."""
    nx, ny, nz = dims
    n = nx * ny * nz
    i = np.arange(n)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    planes = []
    offsets = []
    for stride, coord, m in ((nx * ny, iz, nz), (nx, iy, ny), (1, ix, nx)):
        if m > 1:
            offsets.append(-stride)
            planes.append(np.where(coord != 0, -1.0, 0.0))
    offsets.append(0)
    planes.append(np.full(n, 2.0 * sum(m > 1 for m in (nx, ny, nz))))
    for stride, coord, m in ((1, ix, nx), (nx, iy, ny), (nx * ny, iz, nz)):
        if m > 1:
            offsets.append(stride)
            planes.append(np.where(coord != m - 1, -1.0, 0.0))
    order = np.argsort(offsets)
    data = np.stack([planes[k] for k in order]).astype(np.float32)
    return formats.Dia(data=torch.from_numpy(data).to(device),
                       offsets=tuple(int(offsets[k]) for k in order), shape=(n, n))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slope_timed(call, device, lo=1, hi=9, reps=3) -> float:
    """Per-call seconds of `call`, the slope between runs of `lo` and `hi`
    calls, each ended by torch.cuda.synchronize() (on the host: by the
    call's own return): the fixed cost of a run cancels."""
    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            call()
        _sync(device)
        return time.perf_counter() - t0

    run(1)
    tlo = min(run(lo) for _ in range(reps))
    thi = min(run(hi) for _ in range(reps))
    return max((thi - tlo) / (hi - lo), 1e-9)


def _device_busy_of(call, device):
    """Device-busy seconds (union of the card's event intervals) of one
    call under torch.profiler; None on the CPU (no device timeline)."""
    if device.type != "cuda":
        return None
    return device_time.device_busy_seconds(call)


def _check_fraction(what: str, frac: float) -> None:
    if not frac <= PEAK_FRACTION_LIMIT:
        raise RuntimeError(f"{what}: {frac:.3f} of its peak, above {PEAK_FRACTION_LIMIT}: "
                           "a fault of the measurement")


def _true_residual(mat: formats.Dia, x, b) -> float:
    """‖b − A x‖₁ / normfactor in float64 (the zero initial guess's norm
    factor, ‖b‖₁)."""
    r = b.double() - dia_spmv_plain(mat.data.double(), mat.offsets, x.double())
    return float(r.abs().sum()) / (float(b.double().abs().sum()) + stopping.small_of(
        torch.float64))


def _check_solve(what: str, res_or_perf, mat, x, b) -> float:
    converged = bool(res_or_perf.converged)
    tr = _true_residual(mat, x, b)
    if not converged:
        raise RuntimeError(f"{what}: did not converge")
    if tr > TRUE_RESIDUAL_MARGIN * TOL:
        raise RuntimeError(f"{what}: true residual {tr:.3e} above "
                           f"{TRUE_RESIDUAL_MARGIN:g} x {TOL:g}")
    return tr


def _cg_solver(mat: formats.Dia, b, max_iter: int):
    """The merged CG on mat from a zero guess, as a closure: on the card
    its whole loop is one launch of the persistent CG kernel."""
    kern = CgKernels(mat.shape[0], mat.offsets, b.device)
    data = kern.pack_values(mat)
    params = stopping.StoppingParams(tolerance=TOL, rel_tol=0.0, min_iter=0,
                                     max_iter=max_iter, frequency=1)
    return lambda: cg_fused(kern, data, b, torch.zeros_like(b), params)


def peaks(n: int, device, target_seconds: float) -> dict:
    """The roofline denominators for an n-row problem: the published rate,
    the triad over 8·n floats and the read-dominant plane sum of 7 planes of
    n rows (CUDA events and device timeline)."""
    rows = max(n // 128, 1)
    secs = []

    def timed(fn, **kw):
        t0 = time.perf_counter()
        value = fn(**kw)
        secs.append(time.perf_counter() - t0)
        return value

    out = {"published_gbps": roofline.hbm_peak_gbps(device),
           "triad_gbps": timed(roofline.measure_stream_peak, n=8 * n,
                               target_seconds=target_seconds, device=device),
           "read_gbps": timed(roofline.measure_read_peak, rows=rows, device=device),
           "read_device_gbps": timed(roofline.measure_read_peak_device, rows=rows,
                                     iters=DEVICE_ITERS, device=device)}
    out["denominator_gbps"] = max(out["published_gbps"], out["triad_gbps"], out["read_gbps"])
    # the device clock's: the published rate holds on every clock
    out["device_denominator_gbps"] = max(out["published_gbps"], out["read_device_gbps"])
    if device.type == "cuda":
        log(f"peaks ({torch.cuda.get_device_name(device)}): published "
            f"{out['published_gbps']:.0f} GB/s; triad {out['triad_gbps']:.1f} GB/s and "
            f"read-dominant {out['read_gbps']:.1f} GB/s (CUDA events, replayed CUDA "
            f"graphs), read-dominant {out['read_device_gbps']:.1f} GB/s (device timeline) "
            f"-> denominator {out['denominator_gbps']:.1f} GB/s (in "
            f"{' + '.join(f'{t:.1f}' for t in secs)} s)")
        # beyond the L2 no reading can pass the data sheet's rate
        for key in ("triad_gbps", "read_gbps", "read_device_gbps"):
            _check_fraction(f"the {key[:-5]} peak", out[key] / out["published_gbps"])
    else:
        log(f"peaks on the CPU (host clock; not device figures): nominal "
            f"{out['published_gbps']:.0f} GB/s, triad {out['triad_gbps']:.2f} GB/s, "
            f"read-dominant {out['read_gbps']:.2f} GB/s")
    return out


def spmv_roofline(mat: formats.Dia, pk: dict, device, target_seconds: float) -> dict:
    """Lane 1: the chained Dia SpMV kernel against the denominator, and its
    device-timeline cross-check against the read peak on the same clock."""
    n = mat.shape[0]
    plan = DiaPlan.of(mat)
    x = torch.ones(n, dtype=torch.float32, device=device)

    def mv(v, data):
        return dia_spmv(plan, data, v)

    nbytes = roofline.spmv_bytes(mat)
    r = roofline.measure_chained(mv, x, warmup=3, target_seconds=target_seconds,
                                 operands=(mat.data,), bytes_moved=nbytes,
                                 flops=roofline.spmv_flops(mat))
    frac = r.gbps / pk["denominator_gbps"]
    out = {"n": n, "us": r.seconds * 1e6, "gbps": r.gbps, "fraction": frac}
    where = "CUDA events, replayed CUDA graph" if device.type == "cuda" else \
        "host clock, CPU run"
    log(f"SpMV roofline (n={n:,}): {r.seconds * 1e6:.2f} µs, {r.gbps:.1f} GB/s = "
        f"{100 * frac:.1f}% of the {pk['denominator_gbps']:.0f} GB/s read-dominant peak "
        f"({where})")
    _check_fraction("SpMV roofline", frac)
    if device.type != "cuda":
        log("SpMV device-timeline cross-check: not measured (CPU run)")
        return out
    k_dev = int(min(max(DEVICE_SECONDS / r.seconds, 64), 4000))
    dev_s = roofline.measure_device_chained(mv, x, k_dev, operands=(mat.data,))
    dgbps = nbytes / dev_s / 1e9
    dfrac = dgbps / pk["device_denominator_gbps"]
    out.update(device_us=dev_s * 1e6, device_gbps=dgbps, device_fraction=dfrac)
    log(f"SpMV device-timeline cross-check ({k_dev} chained applies): {dev_s * 1e6:.2f} µs/"
        f"apply busy, {dgbps:.1f} GB/s = {100 * dfrac:.1f}% of the device-clock denominator "
        f"{pk['device_denominator_gbps']:.0f} GB/s (max of the published rate and the "
        f"device-clock read peak, {pk['read_device_gbps']:.0f} GB/s: "
        f"{100 * dgbps / pk['read_device_gbps']:.1f}% of it); replayed-graph time "
        f"{100 * (r.seconds - dev_s) / dev_s:+.1f}% vs device")
    _check_fraction("SpMV device-timeline", dfrac)
    return out


def cg_lane(mat: formats.Dia, seed: int, max_iter: int, pk: dict, device,
            hi: int, reps: int) -> dict:
    """Lanes 2 and 3: the merged CG on b = A·x_true, time/iter/DOF by slope
    timing, its implied rate over its minimum bytes, and its device busy
    time."""
    n, nd = mat.shape[0], len(mat.offsets)
    label = f"n={n:,}"
    x_true = torch.from_numpy(np.random.default_rng(seed).normal(size=n).astype(np.float32))
    b = dia_spmv(DiaPlan.of(mat), mat.data, x_true.to(device))
    solve = _cg_solver(mat, b, max_iter)
    res = solve()
    _sync(device)
    tr = _check_solve(f"CG {label}", res, mat, res.x, b)
    solve_t = _slope_timed(solve, device, hi=hi, reps=reps)
    iters = res.iters
    tpi = solve_t / max(iters, 1)
    # minimum bytes per iteration: K1 reads nd planes, z(=r) and p, writes
    # p' and q; K2i reads x, r, p', q and writes x, r
    it_bytes = (nd + 4) * n * 4 + 6 * n * 4
    gbps = it_bytes / tpi / 1e9
    frac = gbps / pk["denominator_gbps"]
    ws_mb = (nd + 6) * n * 4 / 1e6  # the planes and the live vectors
    out = {"n": n, "iters": iters, "solve_ms": solve_t * 1e3, "us_per_iter": tpi * 1e6,
           "ns_per_iter_dof": tpi * 1e9 / n, "true_residual": tr, "implied_gbps": gbps,
           "fraction": frac}
    clock = "" if device.type == "cuda" else " (host clock, CPU run)"
    log(f"CG {label}: {iters} iters, converged, final {float(res.final_res_norm):.2e}, true "
        f"float64 residual {tr:.2e}, solve {solve_t * 1e3:.2f} ms, time/iter "
        f"{tpi * 1e6:.2f} µs, time/iter/DOF {tpi * 1e9 / n:.4f} ns{clock}")
    note = (f" [working set ≈ {ws_mb:.0f} MB, within 2x the {L2_MB:.0f} MB L2: partly an "
            "L2 rate, not a device-memory rate]" if ws_mb < 2 * L2_MB else "")
    log(f"CG {label} implied bandwidth: {gbps:.1f} GB/s over its minimum "
        f"{it_bytes / n:.0f} bytes/DOF per iteration ({100 * frac:.1f}% of the denominator)"
        f"{note}")
    _check_fraction(f"CG {label} implied bandwidth", frac)
    busy = _device_busy_of(solve, device)
    if busy is None:
        log(f"CG {label} device-timeline cross-check: not measured (CPU run)")
        return out
    out.update(device_ms=busy * 1e3, device_ns_per_iter_dof=busy * 1e9 / max(iters, 1) / n)
    log(f"CG {label} device-timeline cross-check: {busy * 1e3:.2f} ms device-busy = "
        f"{busy * 1e9 / max(iters, 1) / n:.4f} ns/iter/DOF; host slope "
        f"{100 * (solve_t - busy) / busy:+.1f}% vs device (idle share "
        f"{max(0.0, 1 - busy / solve_t):.3f})")
    return out


def foam_step_lane(dims, device) -> dict:
    """Lane 4 (the reference's `_foam_large_benches` (a)): GKOCG through
    foam.solve — first solve, three steady steps, the phase split
    (`update_local_matrix`, `update_device_values`, `solve`, `res_eval`),
    the device-only solve, three diag-only steps (the diag block's affine
    plan: one value-update launch), and the same diag-only steps with
    `uploadPrecision bfloat16` (the reference's bf16-upload lane,
    bench.py:634)."""
    t0 = time.perf_counter()
    m = testing.poisson_ldu(dims)
    n = m.n
    b = np.random.default_rng(1).normal(size=n).astype(np.float32)
    log(f"foam per-step lane: LDU build {time.perf_counter() - t0:.2f} s, n={n:,}")
    ctl = {"solver": "GKOCG", "tolerance": TOL, "relTol": 0, "maxIter": 2000,
           "executor": "cuda" if device.type == "cuda" else "cpu"}
    registry.global_registry.clear()

    def step(mk, what=None, field="benchStep", extra=None):
        t0 = time.perf_counter()
        x, perf = foam.solve(field, mk, b, {**ctl, **(extra or {})})
        _sync(device)
        wall = time.perf_counter() - t0
        slv = registry.global_registry.get(f"{field}_solver")
        _check_solve(f"foam step of {n} cells", perf, slv.matrix, x,
                     torch.from_numpy(b).to(device))
        if what:
            log(f"  {what}: wall {wall * 1e3:.2f} ms = " + ", ".join(
                f"{k} {v * 1e3:.2f}" for k, v in sorted(slv.last_timings.items())) +
                f" ms; iters {perf.n_iterations}, blocks uploaded {slv.last_blocks_uploaded} "
                f"(bf16 {slv.last_blocks_bf16[0]}), {slv.last_upload_bytes} bytes")
        return wall, perf, slv

    first, perf, slv = step(m)
    log(f"per-step: first solve (host set-up + solve) {first:.3f} s, "
        f"iters={perf.n_iterations}")
    walls = []
    for i in range(3):
        m_k = dataclasses.replace(m, upper=m.upper * (1.0 + 1e-7 * (i + 1)),
                                  diag=m.diag * (1.0 + 1e-7 * (i + 1)))
        wall, perf, slv = step(m_k, f"steady step {i + 1}")
        walls.append(wall)
    it = max(perf.n_iterations, 1)
    out = {"n": n, "first_s": first, "step_ms": min(walls) * 1e3, "iters": perf.n_iterations,
           "split_ms": {k: v * 1e3 for k, v in sorted(slv.last_timings.items())}}
    log(f"per-step (update+solve, steady state): {min(walls) * 1e3:.2f} ms, "
        f"iters={perf.n_iterations}, {min(walls) * 1e9 / it / n:.4f} ns/iter/DOF incl. "
        "coefficient update")
    log("per-step phase split: " + ", ".join(f"{k} {v:.2f} ms"
                                             for k, v in out["split_ms"].items()))
    dt = slv.time_device_solve()
    out["device_only_ms"] = dt * 1e3
    log(f"per-step device-only solve (resident state, ended by a synchronize): "
        f"{dt * 1e3:.2f} ms, {dt * 1e6 / it:.2f} µs/iter, "
        f"{dt * 1e9 / it / n:.4f} ns/iter/DOF")
    walls = []
    for i in range(3):
        m_k = dataclasses.replace(m_k, diag=m.diag * (1.0 + 1e-7 * (i + 5)))
        wall, perf, slv = step(m_k, f"diag-only step {i + 1}")
        walls.append(wall)
        if slv.last_blocks_uploaded != (1, 2):
            raise RuntimeError(f"diag-only step {i}: uploaded {slv.last_blocks_uploaded} "
                               "blocks, not (1, 2)")
    out["diag_only_ms"] = min(walls) * 1e3
    out["diag_only_split_ms"] = {k: v * 1e3 for k, v in sorted(slv.last_timings.items())}
    log(f"per-step diag-only change (delta upload {slv.last_blocks_uploaded}): "
        f"{min(walls) * 1e3:.2f} ms, iters={perf.n_iterations}")
    bf = {"uploadPrecision": "bfloat16"}
    step(m_k, field="benchStepBf", extra=bf)  # first solve: blocks resident at full width
    # the first steady step sends its changed block at full width (the
    # reference's), and sets the host mirror the deltas start from
    m_k = dataclasses.replace(m_k, diag=m.diag * (1.0 + 1e-7 * 8))
    step(m_k, field="benchStepBf", extra=bf)
    walls = []
    for i in range(3):
        m_k = dataclasses.replace(m_k, diag=m.diag * (1.0 + 1e-7 * (i + 9)))
        wall, perf, slv = step(m_k, f"diag-only bf16 step {i + 1}", "benchStepBf", bf)
        walls.append(wall)
        if slv.last_blocks_bf16 != (1, 2):
            raise RuntimeError(f"diag-only bf16 step {i}: {slv.last_blocks_bf16} bf16 blocks, "
                               "not (1, 2)")
    out["diag_only_bf16_ms"] = min(walls) * 1e3
    out["diag_only_bf16_split_ms"] = {k: v * 1e3 for k, v in sorted(slv.last_timings.items())}
    log(f"per-step diag-only change, uploadPrecision bfloat16 ({slv.last_upload_bytes} bytes "
        f"uploaded): {min(walls) * 1e3:.2f} ms, iters={perf.n_iterations}")
    return out


def run(device: torch.device, dims_main=GRID_1M, dims_big=GRID_8M,
        target_seconds: float = 1.5) -> dict:
    """Every lane of the slice, in order; returns their results.  Prints
    the reference's JSON line {"metric": "cg_time_per_iter_per_dof", ...}
    after the CG lane."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    log(f"device: {name}; problems {'x'.join(map(str, dims_main))} and "
        f"{'x'.join(map(str, dims_big))}")
    t0 = time.perf_counter()
    mat = _poisson_dia(dims_main, device)
    mat_big = _poisson_dia(dims_big, device)
    log(f"setup: {time.perf_counter() - t0:.2f} s (analytic Dia, {len(mat.offsets)} "
        "diagonals)")
    out = {"device": name, "seconds": {}}

    def lane(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out[key] = fn(*args, **kw)
        out["seconds"][key] = time.perf_counter() - t0
        log(f"[{key}: {out['seconds'][key]:.1f} s]")
        return out[key]

    pk = lane("peaks", peaks, mat_big.shape[0], device, target_seconds)
    lane("spmv", spmv_roofline, mat_big, pk, device, target_seconds)
    lane("cg", cg_lane, mat, 0, 1000, pk, device, hi=33, reps=3)
    print(json.dumps({"metric": "cg_time_per_iter_per_dof",
                      "value": round(out["cg"]["ns_per_iter_dof"], 4), "unit": "ns",
                      "vs_baseline": round(out["spmv"]["fraction"] / 0.80, 3)}), flush=True)
    lane("cg_big", cg_lane, mat_big, 3, 2000, pk, device, hi=5, reps=2)
    del mat, mat_big
    lane("foam_step", foam_step_lane, dims_main, device)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ogl_tpu_torch.bench: torch.cuda.is_available() is False: the bench "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    run(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

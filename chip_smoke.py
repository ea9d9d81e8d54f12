#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ogl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns PARENT . . PARENT   (phase 3's kernels in turns)
    python3 chip_smoke.py --turns-gather PARENT . . PARENT   (the gather formats' part alone)
    python3 chip_smoke.py --turns-gmres PARENT . . PARENT   (the GMRES basis kernels and solves)
    python3 chip_smoke.py --turns-tri PARENT . . PARENT   (the ILU family's kernels and solves)
    python3 chip_smoke.py --turns-amg PARENT . . PARENT   (the unstructured AMG solves and kernels)
    python3 chip_smoke.py --turns-step PARENT . . PARENT   (the 1M steady steps' phase split)

Drives the port's main paths at 1,048,576 cells in OpenFOAM LDU form,
through `ogl_tpu_torch.foam.solve`: on a 128x128x64 Poisson pressure
system, GKOCG with preconditioner `none` and scalar `BJ` (slice 1; each
solve's whole loop one launch of the persistent CG kernel) and the
AMG-preconditioned solve, GKOCG + Multigrid and GKOMultigrid (slice 2;
each solve one launch of the AMG loop kernel, the V-cycle on the device);
then the unstructured-mesh solve (slice 3) on a kNN-6 FV graph (auto-routed
to Xell) and on the Poisson grid renumbered inside each x-line (auto-routed
to Gdia); then (slice 4) the pipelined GKOCG and GKOBiCGStab, on the
Poisson grid, on an asymmetric convection-diffusion system and on the
shuffled grid — each followed by steady-state steps; the pipelined CG with
`none` or `BJ` and GKOBiCGStab `fusedBiCGStab true` each run their whole
loop as one launch of a persistent kernel; then (slice 5) the
headline lanes of the bench, `ogl_tpu_torch.bench.run`, on the read-peak
kernel, the SpMV roofline at 8,388,608 rows and the merged CG; then
(slices 14–16) the reference-parity formats Coo, Csr, Ell, Sell and Hybrid
on the kNN-6 mesh, the Poisson grid and convection-diffusion, and the
ladder's Ell landing on a small unstructured mesh (GKOCG and GKOBiCGStab
`none`/`BJ` on every one of them one launch of a loop kernel); then
(slice 17, BASELINE.json configs 2 and 3) GKOBiCGStab + blocked `BJ`
and GKOGMRES + ISAI/GISAI on the Poisson grid, convection-diffusion and
the kNN-6 mesh; then (slice 20) the ILU family, GKOCG + IC and ICT,
GKOBiCGStab + ILU, IRILU and ILUT and GKOGMRES + ILU, approximate and
`triSolve exact` — after
building the port's kernels from the sources in this checkout and holding
each against its plain PyTorch version on the card, at the slices' size
and at 8,388,608 rows.

Phases (any failure raises, and the script exits non-zero):
  1. device: nvidia-smi name and power limit, torch/CUDA versions,
     compute capability 9.0 required;
  2. build: the CUDA C++ kernels (nvcc, sm_90a), nvcc's register report
     and, for each of the persistent CG loop kernel's ten variants (Dia,
     Gdia, Ell, Csr or Sell, identity or Jacobi), the Xell CG loop kernel's
     two (identity or Jacobi, with its shared-memory ring), the pipelined
     loop kernel's two (identity or Jacobi), the merged-BiCGStab loop
     kernel, the general BiCGStab loop kernel's twelve (Dia, Gdia, Xell,
     Ell, Csr or Sell) and the AMG loop kernel's four (CG or IR,
     float32 or bfloat16 smoother coefficients), its grid (co-resident
     blocks) and registers;
  3. kernels vs plain versions at 1M and 8.4M rows (the smoother kernels
     with float32 and bfloat16 coefficients, KA and KB_pipe with identity
     and Jacobi, K1B with distinct b and c and with b = c): max error
     against the stated tolerance, median times (CUDA events), implied
     GB/s, torch's CSR SpMV beside the Dia SpMV and torch.addmv(b, A_csr,
     x, alpha=-1) beside the float32 residual kernel, at both sizes; then
     the CG loop kernel's Dia variants (identity, Jacobi) against their
     plain twin (x after 30 iterations), timed per iteration in turns with
     the twin and with the host loop over the K1 and K2 (K2i) kernels (200
     iterations, the criterion checked at each), also at 64x64x48, about
     one row per thread of its grid (its fixed cost per iteration); the
     pipelined loop kernel's two variants the same way, against its plain
     twin and the host loop over the KA and KB_pipe kernels; the
     merged-BiCGStab loop kernel the same way against its plain twin (x and
     the normalised residual after 10 pinned iterations: float32 BiCGStab
     on the Poisson grid parts from another summation order later) and the
     host loop over the K1B and KB_update kernels, with its bytes per
     iteration (124 B per row at 7 diagonals); the AMG loop kernel's CG and
     IR variants on the 1M hierarchy with bfloat16 and float32 smoother
     coefficients (and bfloat16 at 64x64x48, its fixed cost) against their
     plain twins (x after 10 iterations), timed per iteration over 20 in
     turns with the twin and the host-launched cycle, with their bytes per
     iteration; then on
     the shuffled grid built on the device at both sizes the Gdia SpMV and
     the row-quad Gdia K1 against their plain versions and the loop's two
     Gdia variants as the Dia ones;
  4. slice 1's path: both solves, launch counts of its kernels (each
     solve: the loop kernel once, K1 twice for its set-up, no K2 or K2i), the
     true float64 residual, and the iteration count against the same solve
     run by the merged CG over the plain kernel functions on the card (and,
     for p, against its 275 iterations);
  5. slice 1's steady-state steps (diag scaled by 1.01, new b): only the
     diag block and the RHS may cross to the device, one loop launch each;
  6. torch.profiler over one more slice-1 step (kernels per solve);
  7. the AMG path: GKOCG + Multigrid and GKOMultigrid (each solve the AMG
     loop kernel once, K1 twice for its set-up, no standalone sweep,
     residual or K2n; 16 and 54 iterations +- 1), GKOCG + Multigrid with
     cycle w on the host-launched cycle (the standalone sweep, residual and
     K2n), the hierarchy, the preconditioner build time, the true float64
     residual and the iteration count against the loop's plain twin (the
     host cycle over the plain kernels for cycle w) on the card; two steady
     steps that rebuild the hierarchy and its level table (one loop launch
     each, against their twins at the same adapted parameters); the host
     cost per call of the host cycle's launches; each loop solve on
     resident state; torch.profiler over one more step;
  8. the unstructured path: the two meshes built on the host (timed),
     GKOCG `none` and `BJ` on each with no matrixFormat (routed format,
     launch counts — each solve one loop launch, its format's K1 twice for
     its set-up, no K2 or K2i —, true float64 residual, iterations against
     the merged CG over the plain twins on the card), one steady step per
     mesh, the kNN mesh once more in its points' numbering with `reorder
     rcm` (one Xell loop launch); then the Gdia and Xell kernels against
     their plain versions (also on the shuffled grid at 8,388,608 rows:
     Gdia built on the device, Xell packed on the host; the Xell SpMV and K1
     also against their twins run on CPU copies, bit-equal), the Xell loop
     kernel's two variants on the kNN mesh, without spill, and on the
     shuffled grid as Xell at 1M and 8.4M rows (x against the twin after 30
     iterations; per iteration over 30 in turns with the twin and the host
     loop over the band K1 and K2i or K2), the general-BiCGStab loop's two
     Xell variants the same way on the kNN mesh and at 8.4M rows (x after
     10 pinned iterations), GKOBiCGStab `none` and `BJ` on the kNN mesh
     (uK, uKBJ: one loop launch each, held to the route over the plain twins
     at 10 pinned iterations and to an exact repeat), torch's CSR SpMV beside the Gdia
     and Xell SpMVs at both sizes, the profiler's device time per launch of
     the Xell SpMV and of torch's CSR SpMV, and a profile of one steady step
     per format;
  9. slice 4: GKOCG `pipelinedCG true` (`none`, `BJ`; each solve the
     pipelined loop kernel once, K1 twice for its set-up, no KA or KB_pipe;
     `none` at 275 iterations) and GKOBiCGStab as
     the reference bench ran it (`BJ`, `none`, `none` + `fusedBiCGStab`)
     on the Poisson grid; GKOBiCGStab `BJ` on convection-diffusion with a
     diag-only step and a step that changes every block, and `none` +
     `fusedBiCGStab` there; GKOBiCGStab `none` on the shuffled grid (Gdia).
     Each fused BiCGStab solve: the merged-BiCGStab loop kernel once, K1
     twice for its set-up, no K1B or KB_update; the general route's time
     per iteration beside the fused one's.  Each solve: the true float64 residual,
     the same route over the plain twins on the card, free-running and
     pinned to the first iterations, and the kernel route again (the same
     count) and with b nudged by one ulp; a profile of one steady step
     each of the merged BiCGStab and the pipelined CG;
 10. slice 5, the bench's headline lanes: the read-peak plane-sum kernel
     against its plain version at 7 x 1,048,576 and 7 x 8,388,608 (bit-equal;
     torch.sum beside it; the profiler's device time per launch of both),
     the card line and published rate, then
     `ogl_tpu_torch.bench.run`: the triad and read-dominant peaks (CUDA
     events over replayed CUDA graphs, and the device timeline), the Dia
     SpMV roofline at 8,388,608 rows against max(published, triad, read
     peak) with its device-timeline cross-check, the merged CG at 1M and
     8.4M (time/iter/DOF, the reference's JSON line, implied bandwidth,
     device busy; µs per iteration and idle share printed after the run),
     the foam per-step, device-only and diag-only lanes.  Any fraction of
     a peak above 1.05 fails the run;
 11. slices 14–16, the reference-parity formats: GKOCG and GKOBiCGStab
     `none` and `BJ` on the 1M kNN-6 mesh with an explicit matrixFormat
     Coo, Csr, Ell, Sell and Hybrid (CG 28 and 23 iterations ± 1,
     BiCGStab 21 and 17 ± 1), `pipelinedCG` on Csr, the Poisson grid as
     Csr (275 ± 1), GKOBiCGStab `BJ` on convection-diffusion as Csr (24 ±
     1), the 20,000-cell kNN-6 mesh in its points' numbering auto-routed to
     Ell, and a steady step on the Csr and Ell solvers (diag block and b
     uploaded); each GKOCG and GKOBiCGStab solve one launch of the loop
     kernel's variant of its format (Ell and Hybrid: Ell; Coo and Csr:
     Csr; Sell) with the format's gather kernel for the set-up and the
     residual-eval timing only, the pipelined CG one gather launch per
     SpMV and no loop kernel; no plain twin called, each count equal ±1 to
     the same route over the plain twins on the card, each true float64
     residual within the limit; then the Ell, Csr and Sell variants of the
     CG and general-BiCGStab loop kernels against their twins on Ell,
     Hybrid, Csr and Sell at kNN 1M and on Ell at 64x64x48 (its fixed
     cost), timed per iteration in turns with the twin and the host loop
     over the SpMV kernel; then the four gather kernels on the kNN mesh and
     on the 8.4M Poisson grid (formats built by core/formats.py's
     converters) against their twins on the card (bit-equal), timed in
     turns with torch's CSR SpMV beside them, each bound from the
     function's least bytes and the format's stored bytes beside it (Sell:
     the bytes its slices read), the CSR kernel at its number of lanes per
     row and the next (also on random graphs of 16, 64 and 256 entries per
     row), and the profiler's device time per launch on the kNN mesh.  The
     loop rows of phase 3 are timed over 5 iterations (200 before phase
     11 joined, 100 before phase 12, 30 before phase 12 took the blocked
     loops, 20 before phase 14 took the device V-cycle's unstructured
     variants), phase 8's Xell loops over 5, phase 11's over 5 and the AMG
     loops over 10, the twins and the host loops at those counts; every
     loop kernel's ms per iteration is from pinned launches of 30 less
     those, its set-up and record read subtracted (LOOP_TIMED_LONG);
 12. slice 17, BASELINE.json configs 2 and 3: the native host runtime
     built (asserted), the block-Jacobi, Arnoldi and combine kernels' and
     the general-BiCGStab loop's block-Jacobi variants' registers, spills
     and the Arnoldi grid; GKOBiCGStab + BJ maxBlockSize 4 on the Poisson
     grid (held to the route over the plain twins at 10 pinned iterations)
     and 4 and 8 on convection-diffusion as Dia and 4 as Csr and Gdia (±1),
     8, 32 and 3 on the 262,144-cell kNN-6 mesh as Xell, Ell and Sell (10
     pinned), GKOCG + BJ 4 on the Poisson grid (±1), GKOGMRES + GISAI on
     the 1M kNN-6 mesh as Ell (and a steady step at its adapted minIter and
     frequency) and as Hybrid, + ISAI on the Poisson grid with a float32
     and a bfloat16 basis (the latter held to its true residual); each
     solve: iterations, the true float64 residual, generate_preconditioner
     ms, µs per iteration on resident state and its launches (a GKOBiCGStab
     + blocked BJ solve one launch of its format's general-BiCGStab loop
     kernel, no block-Jacobi launch, the SpMV 2 + 9 times; GKOCG + blocked
     BJ one block-Jacobi launch per iteration; one Arnoldi launch per GMRES
     iteration, no loop kernel); config 2's blocked loops against their
     plain twins at 10 pinned iterations, timed per iteration in turns with
     the twin and the host loop over the SpMV and block-Jacobi kernels, and
     beside every blocked solve one run of that host loop on its own state
     and the loop's bound per iteration;
     then the three kernels against their twins at 1M and 8.4M rows (block
     Jacobi at bs 4 and 8 and the combine bit-equal, the Arnoldi step at j
     = 99 within the vector tolerance; float32 and bfloat16 bases) with
     torch.bmm and torch.mv beside;
 13. slice 20, the ILU family: GKOCG + IC (`pIC`) and + IC `triSolve
     exact` (`pICx`) on the Poisson grid, GKOBiCGStab + ILU and IRILU and
     GKOGMRES + ILU exact on convection-diffusion (`uILU`, `uIRILU`,
     `wILUx`), GKOBiCGStab + ILUT and GKOCG + ICT on phase 12's
     262,144-cell kNN-6 mesh as Csr (`uKILUT`, `pKICT`); each solve: one
     tri_sweep (exact: tri_levels) launch per preconditioner apply the host
     loop made, none of the other, no loop kernel; iterations ±1 against the
     route over the plain twins on the card (`uKILUT` pinned at 10), the
     true float64 residual, generate_preconditioner and factor_depth; then
     both kernels against their twins on the grid's IC(0) and ILU(0)
     factors at 1M and 8.4M rows (bit-equal; kernel 2 also bit-equal to
     kernel 1 run to the factors' depths), with the apply's least bytes,
     a model of the bytes kernel 1 moves from device memory over its sweeps
     (its factors' rows held in shared memory read once), the dependency depth
     times the µs of one dependent hop of kernel 2 (a chain probe), and
     torch.triangular_solve with a sparse-CSR A (one call per triangle)
     beside kernel 2.
Each phase prints its wall time.  Each path's launch counts are set to 0
just before it and read just after; a kernel of the path that never
launched fails the run.  The line before the last is one JSON object
describing each kernel, with the least time the card could take for its
work (published H100 SXM peaks), its share of the read peak measured in
phase 10, torch's own call for the same function where there is one, and
under "cases" every variant and size it was checked on; the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits with an error and
prints no result.  `--turns` runs phase 3's kernel checks (and the Gdia
kernels on the device-built shuffled grid, 200 pinned iterations of
cg_pipelined_fused and of bicgstab_fused on the Dia plan at 1M and 8.4M
rows, the pMG, pGMG and GKOBiCGStab solves (config 2's blocked BJ ones
too) at 1M cells on resident state, the Xell SpMV and K1 on the shuffled grid packed as Xell at 1M and
8.4M rows, and pK and pKBJ on the kNN-6 mesh on resident state) from
each given checkout in order, one process each, and prints
their kernel lines: an earlier commit unpacked with `git archive` against
this one on the same card; `--turns-gather` runs only its gather part
(GKOCG and GKOBiCGStab `none` and `BJ` on the kNN-6 mesh as Ell, Hybrid,
Csr and Sell on resident state, the four SpMVs at kNN 1M and 8.4M beside
torch's CSR SpMV); `--turns-gmres` runs the Arnoldi step at j = 0, 12,
49 and 99 in float32 and bfloat16 at 262,144 and 1,048,576 rows and at
j = 99 at 8,388,608, the combine at j = 100 beside torch.mv at 1M in five
rounds (three in bfloat16 and at 8.4M), and wK (GKOGMRES + GISAI on the kNN-6 mesh), wP and wPbf (+ ISAI
on the Poisson grid) on resident state; `--turns-tri` runs kernels 1 and 2
on the Poisson grid's IC(0) and ILU(0) factors at 1M and 8.4M rows and on
the 262,144-cell kNN-6 mesh's ILUT and ICT factors, and pIC, pICx, wILUx
and pKICT on resident state.
Phase 14 (slices 22-23, AMG on unstructured meshes): GKOCG + Multigrid on the
1M kNN-6 mesh as Csr (BASELINE config 4) with aggregation auto (`pKMG`) and
pgm (`pKMGpgm`, the native aggregation and the pgm transfer kernels),
GKOMultigrid on it as Ell (`gKMG`), GKOCG + Multigrid on the 1M shuffled grid
through the format ladder (`pSMG`, a Gdia matrix, a Gdia fine level), on the
kNN mesh through the ladder (`pKMGx`, Xell) and with cycle w on the
262,144-cell shuffled grid (`pSMGw`); each solve: its level formats, the
generate_preconditioner ms, µs per iteration on resident state, its launches
(`pKMG`, `gKMG`, `pSMG`: one launch of the device V-cycle's loop kernel, the
outer set-up's SpMVs, no level or transfer kernel; `pKMGpgm`, `pKMGx`,
`pSMGw`: the host cycle, each smoothing level's format its sweep and residual
kernels, pgm its transfer kernels, amg_loop.why_not naming the reason), the
true float64 residual and the iterations against the host cycle over the
plain twins on the card (±1, +2 with bfloat16 packing) and, for the loop
solves, against the loop's plain twin (±1); the native pgm aggregation beside
the pure-Python loop on the 262,144-cell kNN mesh; then the three new loop
variants (Csr, Ell and Gdia outer) against their twins, timed per iteration in
turns with the host cycle over the standalone kernels; then the Ell and Gdia
level smoothers in both value types and the pgm transfers against their twins
at 1M (bit-equal), with the profiler's device time and the chained time of
the path's cases, torch.addmv beside the float32 residuals and index_add_
beside the restriction (also by device time).
`--turns-amg` runs pMG, pGMG, pKMG, gKMG and pSMG on resident state, the
Dia V-cycle's loop kernel by device time per iteration, and the level
kernels by device, chained and around-each-call time in each tree.
Phase 15 (slice 24, the transient steady step): GKOCG on the 1M Poisson
grid as Dia (`pVU`: a diag-only step stages 1 of 2 blocks, takes the diag
block's affine plan and launches value_update once; then an all-block
step), on the 1M kNN-6 mesh as Csr (`pKVU`: both steps, scatter and gather +
scatter plans), with `uploadPrecision bfloat16` (`pVUbf`: the first
steady step sends the diag at full width, as the reference's does, the
next the diag block and b as bfloat16 deltas, half the block's bytes, the
decoded copies bit-equal to the host mirrors) and GKOBiCGStab on the grid with every third
x face duplicated by a cyclic interface (`pVUacc`: the accumulate plan);
each step's container bit-equal to the full path, to itself on a second
run and to the twin on CPU copies; both examples (cavity n 32, Karman
96x32) for 40 steps on the card, ψ within 1e-4 of the same steps on the
CPU; then value_update against its twin on the card (bit-equal) on those
plans at 1M and an affine run of 8.4M, flat.index_copy_ beside the
one-block identity-src plans.  `--turns-step` runs three diag-only and
three all-block steps at 1M on the Poisson grid as Dia and the kNN mesh as
Csr, with bfloat16 deltas where a tree has them, each step's wall and
phase split, in each tree.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from ogl_tpu_torch import bench, foam, kernels, native, registry, testing
from ogl_tpu_torch.config import parse_controls
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import (_build, amg_level, amg_loop, device_time, gather_spmv, gdia,
                                   roofline, spmv, xell)
from ogl_tpu_torch.kernels import gmres as gmres_kernels
from ogl_tpu_torch.kernels import value_update as vu
from ogl_tpu_torch.kernels.block_jacobi import block_jacobi, block_jacobi_plain
from ogl_tpu_torch.kernels.dia_spmv import DiaPlan, dia_spmv, dia_spmv_plain
from ogl_tpu_torch.kernels.fused import (CgKernels, GdiaCgKernels, k1_plain, k1b_plain,
                                         k2_plain, k2i_plain, k2n_plain, ka_plain,
                                         kb_pipe_plain, kb_update_plain, kresid_plain,
                                         ksweep_plain)
from ogl_tpu_torch.precond import amg
from ogl_tpu_torch.precond import ilu
from ogl_tpu_torch.kernels import tri_solve
from ogl_tpu_torch.kernels.ell import EllCgKernels
from ogl_tpu_torch.kernels.fused import (LOOP_BLOCK_JACOBI, LOOP_CSR, LOOP_ELL, LOOP_GDIA,
                                         LOOP_JACOBI, LOOP_SELL, LOOP_THREADS, LOOP_XELL,
                                         bicgstab_gen_loop_plain, bicgstab_loop_plain,
                                         cg_loop_plain, cg_pipe_loop_plain)
from ogl_tpu_torch.kernels.gather_loop import (CsrCgKernels, GatherCgKernels, SellCgKernels,
                                               gather_k1_plain)
from ogl_tpu_torch.kernels.gmres import (gmres_arnoldi, gmres_arnoldi_plain, gmres_combine,
                                         gmres_combine_plain, new_basis)
from ogl_tpu_torch.solve import (bicgstab, bicgstab_fused, cg, cg_fused, cg_pipelined,
                                 cg_pipelined_fused, ir, krylov, stopping)
from ogl_tpu_torch.solve.gmres import gmres as gmres_solve
from ogl_tpu_torch.solve.ir import ir_fused
from ogl_tpu_torch.solve.cg_fused import merged_norm_factor

GRID_1M = (128, 128, 64)
GRID_8M = (256, 256, 128)
KNN_1M = 1 << 20  # cells of the kNN-6 FV graph
TOL = 1e-6
# float32 recurrence residual vs the float64 residual of the returned x:
# the two drift apart by rounding over hundreds of iterations
TRUE_RESIDUAL_MARGIN = 10.0
VEC_RTOL = 1e-5  # elementwise: |err| <= VEC_RTOL * max(1, max|plain|) (FMA vs mul+add)
SUM_RTOL = 1e-4  # block sums: summed in another order than torch.sum

RELAX = 0.9  # the AMG smoother's damping (ogl_tpu_torch/precond/amg.py)
# published NVIDIA H100 SXM peaks (data sheet, at the full 700 W): device
# memory, and float32 outside the tensor cores — the denominators of bound_ms
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# name -> (route, source, TPU kernel it replaces, phase-3/8 case its JSON row
# reports, and the label of that case's run: None = the 1M Poisson grid)
KERNELS = {
    "dia_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/dia_spmv.cu",
                 "ogl_tpu/kernels/pallas_spmv.py:38", "dia_spmv", None),
    "cg_k1": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_k1.cu",
              "ogl_tpu/kernels/fused.py:36", "cg_k1", None),
    "cg_k2": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_k2.cu",
              "ogl_tpu/kernels/fused.py:396", "cg_k2", None),
    "cg_k2i": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_k2i.cu",
               "ogl_tpu/kernels/fused.py:492", "cg_k2i", None),
    "cg_k2n": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_k2n.cu",
               "ogl_tpu/kernels/fused.py:382", "cg_k2n", None),
    # the AMG path packs its smoother coefficients in bfloat16
    "amg_sweep": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_smooth.cu",
                  "ogl_tpu/kernels/fused.py:195", "amg_sweep[bf16]", None),
    "amg_resid": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_smooth.cu",
                  "ogl_tpu/kernels/fused.py:242", "amg_resid[bf16]", None),
    "gdia_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/gdia.cu",
                  "ogl_tpu/kernels/gdia.py:183", "gdia_spmv", "shuffled"),
    "gdia_k1": ("cuda", "ogl_tpu_torch/kernels/csrc/gdia.cu",
                "ogl_tpu/kernels/fused.py:111", "gdia_k1", "shuffled"),
    # the spill correction _spill_corr (xell.py:430) runs inside both
    "xell_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/xell.cu",
                  "ogl_tpu/kernels/xell.py:462, ogl_tpu/kernels/xell.py:430",
                  "xell_spmv", "knn"),
    "xell_k1": ("cuda", "ogl_tpu_torch/kernels/csrc/xell.cu",
                "ogl_tpu/kernels/xell.py:525, ogl_tpu/kernels/xell.py:430",
                "xell_k1", "knn"),
    # the whole merged CG loop on Xell: the band K1 (csrc/xell_band.cuh) and
    # K2 (Jacobi) or K2i (identity) as its phases; its row's times are per
    # iteration, its cases xell_cg_loop[none] and [BJ]
    "xell_cg_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/xell_cg_loop.cu",
                     "ogl_tpu/kernels/xell.py:525, ogl_tpu/kernels/xell.py:430, "
                     "ogl_tpu/kernels/fused.py:396, ogl_tpu/kernels/fused.py:492",
                     "xell_cg_loop[none]", "knn"),
    "cg_ka": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_pipe.cu",
              "ogl_tpu/kernels/fused.py:415", "cg_ka[none]", None),
    "cg_kb_pipe": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_kb_pipe.cu",
                   "ogl_tpu/kernels/fused.py:477", "cg_kb_pipe[none]", None),
    "bicgstab_k1b": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab.cu",
                     "ogl_tpu/kernels/fused.py:283", "bicgstab_k1b", None),
    "bicgstab_kb_update": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab_kb_update.cu",
                           "ogl_tpu/kernels/fused.py:363", "bicgstab_kb_update", None),
    # "big": at the bench's shape, 7 planes of the 8.4M grid's rows
    "read_peak": ("cuda", "ogl_tpu_torch/kernels/csrc/read_peak.cu",
                  "ogl_tpu/kernels/roofline.py:200", "read_peak", "big"),
    # the whole merged CG loop: K1 (Dia or Gdia) and K2 (Jacobi) or K2i
    # (identity) as its phases; its row's times are per iteration, its
    # cases one per variant (cg_loop = Dia none, cg_loop[Dia BJ], ...)
    "cg_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_loop.cu",
                "ogl_tpu/kernels/fused.py:36, ogl_tpu/kernels/fused.py:111, "
                "ogl_tpu/kernels/fused.py:396, ogl_tpu/kernels/fused.py:492", "cg_loop", None),
    # the whole merged pipelined CG loop: KA and KB_pipe as its phases; its
    # row's times are per iteration, its cases cg_pipe_loop[none] and [BJ]
    "cg_pipe_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_pipe_loop.cu",
                     "ogl_tpu/kernels/fused.py:415, ogl_tpu/kernels/fused.py:477",
                     "cg_pipe_loop[none]", None),
    # the whole merged BiCGStab loop: K1B twice and KB_update as its phases;
    # its row's times are per iteration
    "bicgstab_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab_loop.cu",
                      "ogl_tpu/kernels/fused.py:283, ogl_tpu/kernels/fused.py:363",
                      "bicgstab_loop", None),
    # the AMG solves with the V-cycle on the device: GKOCG + Multigrid (K1,
    # K2n, the sweep and the residual as phases) and GKOMultigrid (the
    # sweep and the residual, the SpMV's residual r - A z); their rows'
    # times are per iteration, their cases [bf16] and [f32]
    "amg_cg_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_loop.cu",
                    "ogl_tpu/kernels/fused.py:36, ogl_tpu/kernels/fused.py:382, "
                    "ogl_tpu/kernels/fused.py:195, ogl_tpu/kernels/fused.py:242",
                    "amg_cg_loop[bf16]", None),
    "amg_ir_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_loop.cu",
                    "ogl_tpu/kernels/pallas_spmv.py:38, ogl_tpu/kernels/fused.py:195, "
                    "ogl_tpu/kernels/fused.py:242", "amg_ir_loop[bf16]", None),
    # the whole general BiCGStab loop (GKOBiCGStab, fusedBiCGStab false): the
    # Dia SpMV's row-quad body (Gdia: the Gdia SpMV's) as its two SpMV phases;
    # its row's times are per iteration, its cases one per variant
    "bicgstab_gen_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab_gen_loop.cu",
                          "ogl_tpu/kernels/pallas_spmv.py:38, ogl_tpu/kernels/gdia.py:183",
                          "bicgstab_gen_loop[Dia none]", None),
    # the gather SpMVs of the reference-parity formats (phase 11): XLA ops in
    # the reference, no TPU kernel; their rows report the 1M kNN-6 mesh
    "csr_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/csr_spmv.cu",
                 "XLA op in the reference: ogl_tpu/kernels/spmv.py:38 (spmv_csr), "
                 "ogl_tpu/kernels/spmv.py:33 (spmv_coo)", "csr_spmv", "knn"),
    "ell_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/ell_spmv.cu",
                 "XLA op in the reference: ogl_tpu/kernels/spmv.py:50 (spmv_ell)", "ell_spmv",
                 "knn"),
    "sell_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/sell_spmv.cu",
                  "XLA op in the reference: ogl_tpu/kernels/spmv.py:55 (spmv_sell)",
                  "sell_spmv", "knn"),
    "hybrid_spmv": ("cuda", "ogl_tpu_torch/kernels/csrc/ell_spmv.cu",
                    "XLA op in the reference: ogl_tpu/kernels/spmv.py:92 (spmv_hybrid)",
                    "hybrid_spmv", "knn"),
    # the loops on Ell and Hybrid (phase 11): the Ell variants of the CG and
    # general-BiCGStab loop kernels, the Ell row body (ell_rows.cuh) as their
    # SpMV phases; the reference runs its general loops over XLA SpMVs.  Their
    # rows' times are per iteration, their cases [Ell|Hybrid none|BJ]
    "ell_cg_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_loop.cu",
                    "no TPU kernel: the reference's CG loop, ogl_tpu/solve/cg.py:47, over the "
                    "XLA op ogl_tpu/kernels/spmv.py:50 (spmv_ell)", "ell_cg_loop[Ell none]",
                    "knn"),
    "ell_bicgstab_gen_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab_gen_loop.cu",
                              "no TPU kernel: the reference's BiCGStab loop, "
                              "ogl_tpu/solve/bicgstab.py:52, over the XLA op "
                              "ogl_tpu/kernels/spmv.py:50 (spmv_ell)",
                              "ell_bicgstab_gen_loop[Ell none]", "knn"),
    # the loops on Coo, Csr and Sell (phase 11): their variants of the CG and
    # general-BiCGStab loop kernels, the Csr row body (csr_rows.cuh csr_row)
    # or the Sell slot body (sell_rows.cuh) as their SpMV phases; times per
    # iteration, cases [Csr|Sell none|BJ]
    "csr_cg_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_loop.cu",
                    "no TPU kernel: the reference's CG loop, ogl_tpu/solve/cg.py:47, over the "
                    "XLA op ogl_tpu/kernels/spmv.py:38 (spmv_csr)", "csr_cg_loop[Csr none]",
                    "knn"),
    "csr_bicgstab_gen_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab_gen_loop.cu",
                              "no TPU kernel: the reference's BiCGStab loop, "
                              "ogl_tpu/solve/bicgstab.py:52, over the XLA op "
                              "ogl_tpu/kernels/spmv.py:38 (spmv_csr)",
                              "csr_bicgstab_gen_loop[Csr none]", "knn"),
    "sell_cg_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/cg_loop.cu",
                     "no TPU kernel: the reference's CG loop, ogl_tpu/solve/cg.py:47, over the "
                     "XLA op ogl_tpu/kernels/spmv.py:55 (spmv_sell)", "sell_cg_loop[Sell none]",
                     "knn"),
    "sell_bicgstab_gen_loop": ("cuda", "ogl_tpu_torch/kernels/csrc/bicgstab_gen_loop.cu",
                               "no TPU kernel: the reference's BiCGStab loop, "
                               "ogl_tpu/solve/bicgstab.py:52, over the XLA op "
                               "ogl_tpu/kernels/spmv.py:55 (spmv_sell)",
                               "sell_bicgstab_gen_loop[Sell none]", "knn"),
    # slice 17 (phase 12): the block-Jacobi apply (bs 4; case [bs 8] beside),
    # the GMRES Arnoldi step at j = 99 and the recombination of 100 rows
    # (float32 basis; cases [bf16] beside); the reference runs all three as
    # XLA ops, no TPU kernel
    "block_jacobi": ("cuda", "ogl_tpu_torch/kernels/csrc/block_jacobi.cu",
                     "no TPU kernel: XLA op in the reference, ogl_tpu/precond/jacobi.py:56-59 "
                     "(the einsum apply)", "block_jacobi", None),
    "gmres_arnoldi": ("cuda", "ogl_tpu_torch/kernels/csrc/gmres.cu",
                      "no TPU kernel: XLA ops in the reference, ogl_tpu/solve/gmres.py:264-301 "
                      "(blocked MGS)", "gmres_arnoldi", None),
    "gmres_combine": ("cuda", "ogl_tpu_torch/kernels/csrc/gmres.cu",
                      "no TPU kernel: XLA ops in the reference, ogl_tpu/solve/gmres.py:108-123 "
                      "(x_at)", "gmres_combine", None),
    # slice 20 (phase 13): the ILU family's apply on the Poisson grid's IC(0)
    # factor (cases [ILU] beside): kernel 1, the Jacobi sweeps of both
    # factors, and kernel 2, exact substitution level by level; the
    # reference runs both as XLA ops over its factors' SpMV, no TPU kernel
    "tri_sweep": ("cuda", "ogl_tpu_torch/kernels/csrc/tri_sweep.cu",
                  "no TPU kernel: XLA ops in the reference, ogl_tpu/precond/ilu.py:65-110 "
                  "(_sweep, make_lu_apply, make_ic_apply)", "tri_sweep", None),
    "tri_levels": ("cuda", "ogl_tpu_torch/kernels/csrc/tri_levels.cu",
                   "no TPU kernel: XLA ops in the reference, ogl_tpu/precond/ilu.py:65-110 run "
                   "to factor_depth (:45-62) under triSolve exact", "tri_levels", None),
    # slice 22 (phase 14): the level smoothers on pKMG's fine Ell level (kNN)
    # and pSMG's fine Gdia level (shuffled grid), sweep rows in bfloat16 (the
    # path's packing), residual rows in float32 (torch.addmv beside them;
    # the other type under cases), and the pgm transfers of pKMGpgm's first
    # level
    "amg_ell_sweep": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_ell_smooth.cu",
                      "no TPU kernel: XLA ops in the reference, ogl_tpu/precond/amg.py:420-430 "
                      "(_smooth) over ogl_tpu/kernels/spmv.py:50 (spmv_ell)",
                      "amg_ell_sweep[bf16]", "knn"),
    "amg_ell_resid": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_ell_smooth.cu",
                      "no TPU kernel: XLA ops in the reference, ogl_tpu/precond/amg.py:520 "
                      "(b - _apply_mat) over ogl_tpu/kernels/spmv.py:50 (spmv_ell)",
                      "amg_ell_resid[f32]", "knn"),
    "amg_gdia_sweep": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_gdia_smooth.cu",
                       "ogl_tpu/kernels/gdia.py:183", "amg_gdia_sweep[bf16]", "shuffled"),
    "amg_gdia_resid": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_gdia_smooth.cu",
                       "ogl_tpu/kernels/gdia.py:183", "amg_gdia_resid[f32]", "shuffled"),
    "pgm_restrict": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_transfer.cu",
                     "no TPU kernel: XLA op in the reference, ogl_tpu/precond/amg.py:350-357 "
                     "(_restrict, jax.ops.segment_sum)", "pgm_restrict", "knn"),
    "pgm_prolong": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_transfer.cu",
                    "no TPU kernel: XLA op in the reference, ogl_tpu/precond/amg.py:360-367 "
                    "(_prolong, jnp.take)", "pgm_prolong", "knn"),
    # slice 23 (phase 14): the device V-cycle over Ell and Gdia levels on the
    # outer operators of pKMG (Csr), gKMG (Ell) and pSMG (Gdia): the loop
    # kernel's variants from amg_loop_csr_cg.cu, amg_loop_ell_ir.cu and
    # amg_loop_gdia_cg.cu; their rows' times are per iteration, their launches
    # the path's launches of amg_cg_loop / amg_ir_loop in those solves
    "amg_cg_loop_csr": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_loop_csr_cg.cu",
                        "no TPU kernel: the reference's CG loop with the V-cycle in its body, "
                        "ogl_tpu/solve/cg.py:93 and ogl_tpu/precond/amg.py:471-545, over the "
                        "XLA ops ogl_tpu/kernels/spmv.py:38 (spmv_csr) and :50 (spmv_ell)",
                        "amg_cg_loop_csr[bf16]", "knn"),
    "amg_ir_loop_ell": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_loop_ell_ir.cu",
                        "no TPU kernel: the reference's Richardson loop with the V-cycle in its "
                        "body, ogl_tpu/solve/ir.py:64 and ogl_tpu/precond/amg.py:471-545, over "
                        "the XLA op ogl_tpu/kernels/spmv.py:50 (spmv_ell)",
                        "amg_ir_loop_ell[bf16]", "knn"),
    "amg_cg_loop_gdia": ("cuda", "ogl_tpu_torch/kernels/csrc/amg_loop_gdia_cg.cu",
                         "ogl_tpu/kernels/fused.py:111, ogl_tpu/kernels/fused.py:382, "
                         "ogl_tpu/kernels/gdia.py:183", "amg_cg_loop_gdia[bf16]", "shuffled"),
    # slice 24 (phase 15): the steady step's value update, the Dia diag block's
    # affine plan at 1M (an affine run of 8.4M beside; cases: the kNN Csr
    # scatter, gather + scatter and full plans, a bfloat16 delta, the
    # accumulate plan)
    "value_update": ("cuda", "ogl_tpu_torch/kernels/csrc/value_update.cu",
                     "no TPU kernel: XLA ops in the reference, ogl_tpu/foam/solver.py:483-529 "
                     "(_apply_block_updates) and :38-42 (_apply_delta), "
                     "ogl_tpu/core/formats.py:641-654 (ValueMap.update)", "value_update", None),
}
SLICE1_KERNELS = ("dia_spmv", "cg_k1", "cg_loop")
# the loops (pMG, pGMG, the steps); the standalone smoother kernels and
# K2n: the host-launched cycle of the cycle-w solve (pMGw)
AMG_KERNELS = ("dia_spmv", "cg_k1", "amg_cg_loop", "amg_ir_loop", "cg_k2n", "amg_sweep",
               "amg_resid")
# xell_spmv: the residual-eval timing after each Xell solve; bicgstab_gen_loop:
# GKOBiCGStab on the kNN mesh (uK, uKBJ)
UNSTRUCTURED_KERNELS = ("gdia_spmv", "gdia_k1", "xell_spmv", "xell_k1", "xell_cg_loop",
                        "cg_loop", "bicgstab_gen_loop")
SLICE4_KERNELS = ("cg_pipe_loop", "bicgstab_loop", "bicgstab_gen_loop", "dia_spmv",
                  "gdia_spmv")
BENCH_KERNELS = ("read_peak", "dia_spmv", "cg_k1", "cg_loop")
# a GKOCG `none` or `BJ` solve on Dia (Gdia): the loop kernel once, its K1
# twice (the set-up's r0 and norm factor), no K2 and no K2i
LOOP_SOLVE_LAUNCHES = {"cg_loop": 1, "cg_k1": 2, "cg_k2": 0, "cg_k2i": 0}
GDIA_LOOP_SOLVE_LAUNCHES = {"cg_loop": 1, "gdia_k1": 2, "cg_k2": 0, "cg_k2i": 0}
# the same on Xell: the Xell loop kernel once, the band K1 twice
XELL_LOOP_SOLVE_LAUNCHES = {"xell_cg_loop": 1, "xell_k1": 2, "cg_k2": 0, "cg_k2i": 0}
# a GKOCG `pipelinedCG` solve (`none` or `BJ`) on Dia: the pipelined loop
# kernel once, K1 twice (the set-up's r0 and norm factor), no KA or KB_pipe
PIPE_LOOP_SOLVE_LAUNCHES = {"cg_pipe_loop": 1, "cg_k1": 2, "cg_ka": 0, "cg_kb_pipe": 0}
# a GKOBiCGStab `fusedBiCGStab` solve (`none`) on Dia: the merged-BiCGStab
# loop kernel once, K1 twice (the set-up's r0 and norm factor), no K1B or
# KB_update
BICGSTAB_LOOP_SOLVE_LAUNCHES = {"bicgstab_loop": 1, "cg_k1": 2, "bicgstab_k1b": 0,
                                "bicgstab_kb_update": 0}
# a GKOBiCGStab solve (`fusedBiCGStab` false) with `none` or `BJ` on Dia (Gdia):
# the general-BiCGStab loop kernel once, the format's SpMV eleven times — the
# set-up's r0 and norm factor, then the criterion's residual-eval timing after
# the solve (foam/solver.py _res_eval_seconds: one warm-up and 8) — and no
# SpMV per iteration
RES_EVAL_SPMVS = 9
GEN_LOOP_SOLVE_LAUNCHES = {"bicgstab_gen_loop": 1, "dia_spmv": 2 + RES_EVAL_SPMVS,
                           "bicgstab_loop": 0, "bicgstab_k1b": 0, "bicgstab_kb_update": 0}
GDIA_GEN_LOOP_SOLVE_LAUNCHES = {"bicgstab_gen_loop": 1, "gdia_spmv": 2 + RES_EVAL_SPMVS,
                                "dia_spmv": 0}
XELL_GEN_LOOP_SOLVE_LAUNCHES = {"bicgstab_gen_loop": 1, "xell_spmv": 2 + RES_EVAL_SPMVS,
                                "xell_k1": 0, "xell_cg_loop": 0}
# GKOBiCGStab `none` and `BJ` on the kNN mesh (phase 8): the general loop's
# Xell variants, held as the Poisson-grid solves of phase 9 are
XELL_GEN_SOLVES = {"uK": "none", "uKBJ": {"preconditioner": "BJ"}}
# the general-BiCGStab loop kernel's variants (bits of csrc/bicgstab_gen_loop.cu)
GEN_LOOP_VARIANTS = {0: "Dia none", LOOP_JACOBI: "Dia BJ", LOOP_GDIA: "Gdia none",
                     LOOP_GDIA | LOOP_JACOBI: "Gdia BJ", LOOP_XELL: "Xell none",
                     LOOP_XELL | LOOP_JACOBI: "Xell BJ", LOOP_ELL: "Ell none",
                     LOOP_ELL | LOOP_JACOBI: "Ell BJ", LOOP_CSR: "Csr none",
                     LOOP_CSR | LOOP_JACOBI: "Csr BJ", LOOP_SELL: "Sell none",
                     LOOP_SELL | LOOP_JACOBI: "Sell BJ",
                     **{LOOP_BLOCK_JACOBI | bit: f"{fmt} blocked BJ" for bit, fmt in (
                         (0, "Dia"), (LOOP_GDIA, "Gdia"), (LOOP_XELL, "Xell"), (LOOP_ELL, "Ell"),
                         (LOOP_CSR, "Csr"), (LOOP_SELL, "Sell"))}}
# x after BICGSTAB_LOOP_CHECK pinned iterations against the twin: the phases
# give the twin's bits at every row, the block sums add in another order, and
# float32 BiCGStab amplifies that (the rtol the phase-9 pin holds residuals to)
GEN_LOOP_RTOL = 1e-4
# the loop kernel's ten variants (bits of csrc/cg_loop.cu), as phase 2 names them
LOOP_VARIANTS = {0: "Dia none", LOOP_JACOBI: "Dia BJ", LOOP_GDIA: "Gdia none",
                 LOOP_GDIA | LOOP_JACOBI: "Gdia BJ", LOOP_ELL: "Ell none",
                 LOOP_ELL | LOOP_JACOBI: "Ell BJ", LOOP_CSR: "Csr none",
                 LOOP_CSR | LOOP_JACOBI: "Csr BJ", LOOP_SELL: "Sell none",
                 LOOP_SELL | LOOP_JACOBI: "Sell BJ"}
PIPE_LOOP_VARIANTS = {0: "none", LOOP_JACOBI: "BJ"}  # csrc/cg_pipe_loop.cu
XELL_LOOP_VARIANTS = {0: "none", LOOP_JACOBI: "BJ"}  # csrc/xell_cg_loop.cu
P_ITERS = 275  # field p at 1M cells, as the merged CG over the plain twins takes it
# the loop's check (x against the plain twin), its timing (200 until the
# formats' phase 11 joined the script, 100 until phase 12 did, 30 until
# phase 12 took the blocked loops; 20 until phase 14 took the device
# V-cycle's unstructured variants; 5 keeps the script within its time)
LOOP_ITERS = (30, 5)
# every loop kernel's ms per iteration: a pinned launch of this many
# iterations less one of the timing's, so the set-up and the record's read
# (a run's fixed 0.3-0.4 ms) drop out of the row (30, not 50, keeps the
# script within its time)
LOOP_TIMED_LONG = 30
# the Xell loops': their plain twins' SpMV takes 3-9 ms per iteration at
# 1M-8.4M rows (the general BiCGStab's check stays BICGSTAB_LOOP_CHECK);
# timed over 5 since phase 14 took the device V-cycle's unstructured
# variants (10 since phase 12 took the blocked loops, 15 since phase 12
# joined, 30 before)
XELL_LOOP_ITERS = (30, 5)
# every loop kernel's ms per iteration: a pinned launch of this many
# iterations less one of the timing's, so the set-up and the record's read
# (a run's fixed 0.3-0.4 ms) drop out of the row (30, not 50, keeps the
# script within its time)
LOOP_TIMED_LONG = 30
# the BiCGStab loop's check: float32 BiCGStab on the Poisson grid from a
# random b parts from another summation order within 30 iterations (phase 3
# prints the gap there), so x is held to the twin after 10, as phase 9 pins
BICGSTAB_LOOP_CHECK = 10
# about one row per thread of the loop kernel's grid (3 x 132 blocks of 512 on
# an H100): its time per iteration is the loop's fixed cost (two grid
# barriers, the partial sums, the phases' ramps)
LOOP_FIXED_GRID = (64, 64, 48)
READ_PLANES = 7  # the read peak's planes (roofline.measure_read_peak's default)
AMG_SOLVES = {"pMG": {"solver": "GKOCG", "preconditioner": "Multigrid"},
              "pGMG": {"solver": "GKOMultigrid"}}
# each AMG solve on a qualifying hierarchy: its loop kernel once, K1 twice
# (the set-up's r0 and norm factor), no standalone smoother pass or K2n
AMG_LOOP_SOLVE_LAUNCHES = {
    "pMG": {"amg_cg_loop": 1, "amg_ir_loop": 0, "cg_k1": 2, "cg_k2n": 0, "amg_sweep": 0,
            "amg_resid": 0},
    "pGMG": {"amg_ir_loop": 1, "amg_cg_loop": 0, "cg_k1": 2, "cg_k2n": 0, "amg_sweep": 0,
             "amg_resid": 0}}
# GKOCG + Multigrid with cycle w keeps the host-launched cycle (kernels/
# amg_loop.py why_not): it drives the standalone sweep, residual and K2n
AMG_HOST_SOLVE = ("pMGw", {"solver": "GKOCG",
                           "preconditioner": {"preconditioner": "Multigrid", "cycle": "w"}})
AMG_ITERS = {"pMG": 16, "pGMG": 54}  # at 1M cells, as their plain twins take them
# the AMG loops' check and timing iterations (timed over 50 until phase 12
# joined, over 20 until phase 14 took the unstructured variants)
AMG_LOOP_CHECK, AMG_LOOP_TIMED = 10, 10
# x after AMG_LOOP_CHECK iterations against the twin: the restricting sums,
# the coarse product and the partial sums add in another order
AMG_LOOP_RTOL = 1e-4
# the Dia outer's variants (Dia levels only), which phases 3 and 7 run
AMG_LOOP_VARIANTS = {0: "CG f32", amg_loop.VARIANT_BF16: "CG bf16",
                     amg_loop.VARIANT_IR: "IR f32",
                     amg_loop.VARIANT_IR | amg_loop.VARIANT_BF16: "IR bf16"}


class PlainSteps:
    """K2, K2i and K2n as the plain PyTorch versions, on any device."""

    def k2(self, alpha, x, r, p, q, invd, z):
        return k2_plain(alpha, x, r, p, q, invd, z)

    def k2i(self, alpha, x, r, p, q):
        return k2i_plain(alpha, x, r, p, q)

    def k2n(self, alpha, x, r, p, q):
        return k2n_plain(alpha, x, r, p, q)


class PlainCgKernels(PlainSteps, CgKernels):
    """CgKernels whose steps are the plain PyTorch versions, on any device:
    the independent reference the main path's iteration count is held to."""

    def k1(self, data, z, p, beta):
        return k1_plain(data, self.offsets, z, p, beta)

    def ksweep(self, data, x, b, invd, relax, out=None):
        return ksweep_plain(data, self.offsets, x, b, invd, relax)

    def kresid(self, data, x, b, out=None):
        return kresid_plain(data, self.offsets, x, b)

    def ka(self, data, r, invd=None):
        return ka_plain(data, self.offsets, r, invd)

    def kb_pipe(self, w, p, s, x, r, alpha, beta, invd=None):
        return kb_pipe_plain(w, p, s, x, r, alpha, beta, invd)

    def k1b(self, data, a, b, c, rhat, ca, cb, out=None):
        return k1b_plain(data, self.offsets, a, b, c, rhat, ca, cb)

    def kb_update(self, x, p, s, t, rhat, alpha, omega, r):
        return kb_update_plain(x, p, s, t, rhat, alpha, omega, r)


class HostLoopCgKernels(CgKernels):
    """CgKernels that cg_fused (cg_pipelined_fused, bicgstab_fused) does not
    recognise as the Dia plan itself, so its solves keep the host loop over
    the K1 and K2 (K2i; KA and KB_pipe; K1B and KB_update) kernels."""


class HostLoopGdiaCgKernels(GdiaCgKernels):
    """The same for a Gdia plan: the host loop over the Gdia K1 and K2
    (K2i) kernels."""


class HostLoopXellCgKernels(xell.XellCgKernels):
    """The same for an Xell plan: the host loop over the band K1 and K2
    (K2i) kernels."""


class PlainGdiaCgKernels(PlainSteps, GdiaCgKernels):
    def k1(self, data, z, p, beta):
        return gdia.gdia_k1_plain(*data, self.plane_offsets, z, p, beta)


class PlainXellCgKernels(PlainSteps, xell.XellCgKernels):
    def k1(self, data, z, p, beta):
        return xell.xell_k1_plain(self.plan, *data, z, p, beta)


def plain_plan(mat):
    """The merged-CG plan over the plain twins for a Gdia or Xell matrix."""
    if isinstance(mat, gdia.Gdia):
        return PlainGdiaCgKernels(mat.shape[0], mat.plane_offsets, mat.vals.device)
    return PlainXellCgKernels(xell.XellPlan.of(mat))


def poisson_dia(dims, device):
    """The Dia data of testing.poisson_ldu(dims) (3-D, Dirichlet), built
    analytically on the device: -1 to each existing neighbour, 6 on the
    diagonal (neighbours + boundary faces)."""
    nx, ny, nz = dims
    n = nx * ny * nz
    i = torch.arange(n, device=device)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    one = torch.ones(n, device=device)
    nb = [iz > 0, iy > 0, ix > 0, None, ix < nx - 1, iy < ny - 1, iz < nz - 1]
    data = torch.stack([6.0 * one if m is None else torch.where(m, -one, 0 * one)
                        for m in nb])
    return data.contiguous(), (-nx * ny, -nx, -1, 0, 1, nx, nx * ny)


def time_turns(fns, reps=20, warmup=3):
    """Median ms of each function of the dict `fns`, CUDA events, warmed up
    (`warmup` calls each), timed in turns: the functions in order, then in
    reverse order."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    samples = {tag: [] for tag in fns}
    for tag in [*fns, *reversed(fns)]:
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        for s, e in events:
            s.record()
            fns[tag]()
            e.record()
        torch.cuda.synchronize()
        samples[tag] += [s.elapsed_time(e) for s, e in events]
    return {tag: statistics.median(v) for tag, v in samples.items()}


def time_pair(kernel_fn, plain_fn, reps=20, warmup=3):
    """Median ms of kernel and plain version, timed in turns (plain, kernel,
    kernel, plain)."""
    t = time_turns({"p": plain_fn, "k": kernel_fn}, reps, warmup)
    return t["k"], t["p"]


def device_ms_per_launch(fn, reps=25):
    """The device time of one call of `fn` from the profiler's timeline: the
    summed durations of its kernels over `reps` calls (25; 50 until phase 15
    joined), over reps (None, not measured, when two profiles record no
    kernel).  Beside the CUDA-event
    time it says whether the call is bound by the host's launch or by the
    device."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # the profiler has come back empty now and then: once more
        _, events = device_time.device_events(lambda: [fn() for _ in range(reps)])
        kern = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
        if kern:
            return sum(e.time_range.elapsed_us() for e in kern) / reps / 1e3
    print("  torch.profiler recorded no kernel twice: device time not measured")
    return None


def check_loop_solve_launches(what, before, want=LOOP_SOLVE_LAUNCHES):
    """A `none` or `BJ` solve on Dia (Gdia: want=GDIA_LOOP_SOLVE_LAUNCHES)
    runs its whole loop as one launch of the loop kernel: `want` between
    `before` and now."""
    got = {k: kernels.launches[k] - before[k] for k in want}
    print(f"  {what}: launches in this solve {got}")
    if got != want:
        raise RuntimeError(f"{what}: launched {got} in one solve, not {want}")


def check_host_cycle_launches(what, before):
    """A solve on the host-launched AMG cycle (cycle w): the standalone
    sweep, residual and K2n between `before` and now, no loop launch."""
    got = {k: kernels.launches[k] - before[k] for k in AMG_KERNELS}
    print(f"  {what}: launches in this solve {got}")
    if got["amg_cg_loop"] or not (got["amg_sweep"] and got["amg_resid"] and got["cg_k2n"]):
        raise RuntimeError(f"{what}: did not run the host-launched cycle: {got}")


def loop_ptxas(log, variant, kernel="cg_loop_kernel"):
    """nvcc's -Xptxas -v lines (registers, spills) of kernel<variant>, whose
    mangled name holds <kernel>ILi<variant>E (variant None: the kernel is
    not a template)."""
    lines = log.splitlines()
    tag = kernel if variant is None else f"{kernel}ILi{variant}E"
    for i, line in enumerate(lines):
        if "Compiling entry" in line and tag in line:
            return [ln.split(":", 1)[-1].strip() for ln in lines[i + 1:i + 4]
                    if "registers" in ln or "spill" in ln]
    return ["not in the build log"]


def phase_done(label, since):
    now = time.perf_counter()
    print(f"-- {label} wall {now - since:.1f} s")
    return now


def vec_err(got, want):
    err = float((got - want).abs().max())
    tol = VEC_RTOL * max(1.0, float(want.abs().max()))
    return err, tol


def rel_err(got, want):
    """vec_err with no floor of 1: the tolerance scales with the compared
    vector's own largest entry."""
    err = float((got - want).abs().max())
    return err, VEC_RTOL * float(want.abs().max())


def sum_err(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def check_kernels(dims, device, report):
    data, offsets = poisson_dia(dims, device)
    nd, n = data.shape
    g = torch.Generator(device=device).manual_seed(0)
    vec = {k: torch.randn(n, device=device, generator=g)
           for k in ("x", "r", "p", "z", "q", "s", "t")}
    invd = 1.0 / data[offsets.index(0)]
    kern = CgKernels(n, offsets, device)
    plan = DiaPlan(n, offsets, device)
    alpha = torch.tensor(1e-3, device=device)
    beta = torch.tensor(0.37, device=device)
    omega = torch.tensor(-0.61, device=device)
    label = "x".join(map(str, dims))

    def run_k2(k2fn, jacobi):
        x, r, z = vec["x"].clone(), vec["r"].clone(), torch.empty(n, device=device)
        if jacobi:
            s = k2fn(alpha, x, r, vec["p"], vec["q"], invd, z)
            return (x, r, z), s
        return (x, r), k2fn(alpha, x, r, vec["p"], vec["q"])

    def run_k2n(k2nfn):
        x, r = vec["x"].clone(), vec["r"].clone()
        return (x, r), (k2nfn(alpha, x, r, vec["p"], vec["q"]),)

    def run_kb_pipe(fn, iv):  # on copies: p, s, x, r are updated in place
        p, s, x, r = (vec[k].clone() for k in ("p", "s", "x", "r"))
        fn(vec["q"], p, s, x, r, alpha, beta, iv)
        return (p, s, x, r), ()

    def run_kb_update(fn):
        x, r = vec["x"].clone(), torch.empty(n, device=device)
        sums = fn(x, vec["p"], vec["s"], vec["t"], vec["r"], alpha, omega, r)
        return (x, r), sums

    def split(o, k):  # (vectors, sums) of a kernel's output tuple
        return o[:k], o[k:]

    # name -> (kernel, plain version, minimum bytes, operations)
    cases = {
        "dia_spmv": (lambda: ((dia_spmv(plan, data, vec["x"]),), ()),
                     lambda: ((dia_spmv_plain(data, offsets, vec["x"]),), ()),
                     (nd + 2) * n * 4, 2 * nd * n),
        "cg_k1": (lambda: split(kern.k1(data, vec["z"], vec["p"], beta), 2),
                  lambda: split(k1_plain(data, offsets, vec["z"], vec["p"], beta), 2),
                  (nd + 4) * n * 4, (2 * nd + 4) * n),
        "cg_k2": (lambda: run_k2(kern.k2, True), lambda: run_k2(k2_plain, True), 8 * n * 4,
                  9 * n),
        "cg_k2i": (lambda: run_k2(kern.k2i, False), lambda: run_k2(k2i_plain, False),
                   6 * n * 4, 8 * n),
        "cg_k2n": (lambda: run_k2n(kern.k2n), lambda: run_k2n(k2n_plain), 6 * n * 4, 6 * n),
    }
    # the smoother passes, on float32 and on bfloat16 coefficients; the plain
    # versions read the same coefficients widened to float32
    for tag, d in (("f32", data), ("bf16", data.to(torch.bfloat16))):
        coef = nd * n * d.element_size()
        cases[f"amg_sweep[{tag}]"] = (
            lambda d=d: ((kern.ksweep(d, vec["x"], vec["r"], invd, RELAX),), ()),
            lambda d=d: ((ksweep_plain(d, offsets, vec["x"], vec["r"], invd, RELAX),), ()),
            coef + 4 * n * 4, (2 * nd + 4) * n)
        cases[f"amg_resid[{tag}]"] = (
            lambda d=d: ((kern.kresid(d, vec["x"], vec["r"]),), ()),
            lambda d=d: ((kresid_plain(d, offsets, vec["x"], vec["r"]),), ()),
            coef + 3 * n * 4, (2 * nd + 1) * n)
    # slice 4: KA and KB_pipe with identity and Jacobi, K1B with distinct b
    # and c and with b = c (the second K1B of an iteration), KB_update
    for tag, iv in (("none", None), ("BJ", invd)):
        jac = iv is not None
        cases[f"cg_ka[{tag}]"] = (
            lambda iv=iv: split(kern.ka(data, vec["r"], iv), 1),
            lambda iv=iv: split(ka_plain(data, offsets, vec["r"], iv), 1),
            (nd + 2 + jac) * n * 4, (2 * nd + 6 + jac) * n)
        cases[f"cg_kb_pipe[{tag}]"] = (
            lambda iv=iv: run_kb_pipe(kern.kb_pipe, iv),
            lambda iv=iv: run_kb_pipe(kb_pipe_plain, iv),
            (9 + jac) * n * 4, (8 + jac) * n)
    for tag, c in (("", vec["t"]), ("[b is c]", vec["s"])):
        cases[f"bicgstab_k1b{tag}"] = (
            lambda c=c: split(kern.k1b(data, vec["x"], vec["s"], c, vec["r"], beta, omega), 2),
            lambda c=c: split(k1b_plain(data, offsets, vec["x"], vec["s"], c, vec["r"], beta,
                                        omega), 2),
            (nd + 6 - (c is vec["s"])) * n * 4, (2 * nd + 10) * n)
    cases["bicgstab_kb_update"] = (lambda: run_kb_update(kern.kb_update),
                                   lambda: run_kb_update(kb_update_plain), 7 * n * 4, 10 * n)
    # the in-place updates are timed on fixed buffers (no copies in the loop)
    x, r, z = vec["x"].clone(), vec["r"].clone(), torch.empty(n, device=device)
    p, s = vec["p"].clone(), vec["s"].clone()
    timed = {
        "cg_k2": (lambda: kern.k2(alpha, x, r, vec["p"], vec["q"], invd, z),
                  lambda: k2_plain(alpha, x, r, vec["p"], vec["q"], invd, z)),
        "cg_k2i": (lambda: kern.k2i(alpha, x, r, vec["p"], vec["q"]),
                   lambda: k2i_plain(alpha, x, r, vec["p"], vec["q"])),
        "cg_k2n": (lambda: kern.k2n(alpha, x, r, vec["p"], vec["q"]),
                   lambda: k2n_plain(alpha, x, r, vec["p"], vec["q"])),
        "bicgstab_kb_update": (
            lambda: kern.kb_update(x, vec["p"], vec["s"], vec["t"], vec["r"], alpha, omega, z),
            lambda: kb_update_plain(x, vec["p"], vec["s"], vec["t"], vec["r"], alpha, omega,
                                    z)),
    }
    for tag, iv in (("none", None), ("BJ", invd)):
        timed[f"cg_kb_pipe[{tag}]"] = (
            lambda iv=iv: kern.kb_pipe(vec["q"], p, s, x, r, alpha, beta, iv),
            lambda iv=iv: kb_pipe_plain(vec["q"], p, s, x, r, alpha, beta, iv))
    for name, (kfn, pfn, nbytes, nflops) in cases.items():
        compare(name, label, kfn, pfn, nbytes, nflops, report, *timed.get(name, ()))
    csr = csr_of_coo(*dia_coo(data, offsets), n)
    library_beside("dia_spmv", label, csr, lambda v: dia_spmv(plan, data, v), vec["x"], report)
    # the float32 residual b - A x as one torch call, where the card's torch
    # takes a CUDA CSR matrix in addmv
    def addmv():
        return torch.addmv(vec["r"], csr, vec["x"], alpha=-1)

    try:
        addmv()
    except (RuntimeError, NotImplementedError) as e:
        print(f"  torch.addmv(b, A_csr, x, alpha=-1) refused on the card ({type(e).__name__}: "
              f"{e}): amg_resid[f32] has no single library call")
    else:
        library_call("amg_resid[f32]", label, "torch.addmv(b, A_csr, x, alpha=-1)", addmv,
                     lambda: kern.kresid(data, vec["x"], vec["r"]), "the same matrix", report)
    del vec, invd, cases, timed, x, r, z, p, s, csr
    check_dia_loops(data, offsets, label, report)
    del data
    torch.cuda.empty_cache()


def gather_spmv_bytes(kern, data):
    """The least bytes of one SpMV over a gather plan's matrix, bar x and y:
    each entry's value and column once (8 B; the padding is the format's
    cost, not the function's), and the index arrays the format cannot do
    without — a Hybrid tail's row offsets, Csr's row offsets, Sell's row
    permutation (gather_bytes_flops)."""
    if isinstance(kern, CsrCgKernels):
        return kern.mat.nnz * 8 + 4 * (kern.n + 1)
    if isinstance(kern, SellCgKernels):
        m = kern.mat  # a real entry is not (column 0, value 0), bar a stored zero there
        return int(((m.cols != 0) | (data[0] != 0)).sum()) * 8 + 4 * kern.n
    rows = torch.arange(kern.n, device=kern.device)
    nnz = int(((kern.cols != rows) | (data[0] != 0)).sum()) + kern.n_tail
    return nnz * 8 + (4 * (kern.n + 1) if kern.n_tail else 0)


def loop_bytes(data, n, jacobi, kern=None):
    """Minimum bytes per iteration of the loop kernel: K1 (the coefficients,
    z (r) and p in, p' and q out) and K2i (x, r, p', q in; x, r out), with
    Jacobi also invd in and z out."""
    if isinstance(kern, GatherCgKernels):
        k1 = gather_spmv_bytes(kern, data) + 16 * n
    elif isinstance(data, tuple) and len(data) == 4:  # Xell: K slots of 7 B, the spill
        vals, spill = data[0], data[3].numel()
        k1 = (vals.shape[1] * 7 + 16 + (4 if spill else 0)) * n + 12 * spill
    elif isinstance(data, tuple):  # Gdia: np values (4 B) and lanes (1 B) per row
        k1 = (data[0].shape[0] * 5 + 16) * n
    else:
        k1 = (data.shape[0] + 4) * 4 * n
    return k1 + (32 if jacobi else 24) * n


def checked_iterations(k):
    """Stopping parameters of exactly k iterations, each checked: tolerance 0
    never stops the loop before maxIter, and frequency 1 checks at every
    iteration, as in a solve with frequency 1 (the host loop reads one bool
    per iteration)."""
    return stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=k,
                                   frequency=1)


def loop_row(case, label, run, host_solve, host_what, nbytes, n, report,
             check=LOOP_ITERS[0], iters=LOOP_ITERS[1], vec_rtol=VEC_RTOL, res_atol=0.0):
    """A loop kernel against its plain twin from one set-up: `run(k, plain)`
    runs k checked iterations of the kernel (plain=False) or of the twin and
    returns (x, iterations, normalised residual); after `check` iterations x
    is held to the vector tolerance (`vec_rtol`) and the residual to
    PINNED_RTOL, or to within `res_atol` of the twin's (0: no such floor);
    then both are timed in turns over `iters` with `host_solve(k)`, the host
    loop over the standalone kernels (the twin's and the host loop's ms per
    iteration hold the set-up's applies and the record's read), and the
    kernel also over LOOP_TIMED_LONG iterations: its ms per iteration is the
    difference of its two launches over the difference of their iterations,
    the set-up and the record's read subtracted.  The bound is per iteration
    (`nbytes` over the memory rate)."""
    (xk, ik, rk), (xp, ip, rp) = run(check, False), run(check, True)
    err = float((xk - xp).abs().max())
    tol = vec_rtol * max(1.0, float(xp.abs().max()))
    rel = sum_err(rk, rp)
    k = iters
    k_long = run(LOOP_TIMED_LONG, False)[1]  # a breakdown may stop it early
    # one warm-up each: the check above has run the kernel and the twin
    t = time_turns({"plain": lambda: run(k, True), "kernel": lambda: run(k, False),
                    "kernel long": lambda: run(LOOP_TIMED_LONG, False),
                    "host loop": lambda: host_solve(k)}, reps=5, warmup=1)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    ms = {tag: v / k for tag, v in t.items()}
    setup_ms, timed = ms["kernel"], k
    if k_long > k:
        ms["kernel"], timed = (t["kernel long"] - t["kernel"]) / (k_long - k), k_long - k
    ok = (err <= tol and (rel <= PINNED_RTOL or abs(float(rk) - float(rp)) <= res_atol)
          and ik == ip == check)
    floor = f" or {res_atol:.1e} apart: {float(rk):.4e} vs {float(rp):.4e}" if res_atol else ""
    print(f"  {case:22s} {label:20s} max_abs_err {err:.3e} (tol {tol:.1e}), residual rel err "
          f"{rel:.1e} (tol {PINNED_RTOL:.0e}{floor}) after "
          f"{ik} / {ip} iterations; per iteration (checked at each): kernel "
          f"{ms['kernel']:.4f} ms {nbytes / ms['kernel'] / 1e6:.1f} GB/s (over {timed}: launches "
          f"of {k_long} less {k} iterations; over {k} with the set-up {setup_ms:.4f} ms), plain "
          f"{ms['plain']:.4f} ms, host loop over {host_what} {ms['host loop']:.4f} ms (over "
          f"{k}), bound {bound:.4f} ms ({nbytes / n:.0f} B/row)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{case} at {label} disagrees with its plain version")
    report.setdefault(case, {})[label] = {
        "max_abs_err": err, "ms": ms["kernel"], "plain_ms": ms["plain"],
        "host_loop_ms": ms["host loop"], "gbps": nbytes / ms["kernel"] / 1e6,
        "bound_ms": bound, "bound_by": "bytes", "per": "iteration", "iterations": timed,
        "ms_with_setup": setup_ms, "plain_iterations": k}


def check_loop(kern, data, plain_k1, label, report, invd=None, case="cg_loop",
               iters=LOOP_ITERS):
    """The loop kernel against its plain twin (over `plain_k1`) from the same
    set-up (b random, x0 = 0), timed in turns with the host loop over the
    standalone kernels (cg_fused with a plan that keeps the host loop):
    loop_row over `iters` (check, timing).  invd: the Jacobi variant (the K2
    phase).  kern: a Dia, Gdia, Xell (the Xell loop kernel) or gather plan
    (Ell, Csr, Sell: the format's variant, against the host loop of
    solve/cg.py over the SpMV kernel)."""
    n, dev = kern.n, kern.device
    b = torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    x0 = torch.zeros_like(b)
    r0 = b - kern.apply(data, x0)
    z0 = None if invd is None else invd * r0
    state = (torch.sum(r0 * (r0 if z0 is None else z0)), torch.sum(torch.abs(r0)),
             merged_norm_factor(kern, data, r0, x0, b))
    host_what = "K1 + " + ("K2" if invd is not None else "K2i")
    if isinstance(kern, GatherCgKernels):
        ops = krylov.single_device_ops(functools.partial(kern.spmv, data), n,
                                       precond=None if invd is None else (lambda r: invd * r))
        host_solve, host_what = (lambda k: cg(ops, b, x0, checked_iterations(k)),
                                 "the SpMV kernel + torch ops")
    else:
        if isinstance(kern, xell.XellCgKernels):
            host = HostLoopXellCgKernels(kern.plan)
        elif isinstance(kern, GdiaCgKernels):
            host = HostLoopGdiaCgKernels(n, kern.plane_offsets, dev)
        else:
            host = HostLoopCgKernels(n, kern.offsets, dev)
        host_solve = lambda k: cg_fused(host, data, b, x0, checked_iterations(k), invd=invd)

    def run(k, plain):
        x, r = x0.clone(), r0.clone()
        z = None if z0 is None else z0.clone()
        rec = (cg_loop_plain(plain_k1, x, r, *state, checked_iterations(k), invd, z) if plain
               else kern.cg_loop(data, x, r, *state, checked_iterations(k), invd=invd, z=z))
        return x, rec[0], rec[1]

    loop_row(case, label, run, host_solve, host_what, loop_bytes(data, n, invd is not None, kern),
             n, report, check=iters[0], iters=iters[1])


def check_pipe_loop(kern, data, label, report, invd=None):
    """The pipelined loop kernel against its plain twin (over ka_plain and
    kb_pipe_plain) from the same set-up (b random, x0 = 0), timed in turns
    with the host loop over the KA and KB_pipe kernels (cg_pipelined_fused
    with a plan that keeps the host loop): loop_row.  Minimum bytes per
    iteration and row: KA the coefficients, r in and w out; KB_pipe 9
    streams; invd once in each phase with Jacobi."""
    n, dev = kern.n, kern.device
    b = torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    x0 = torch.zeros_like(b)
    r0 = b - kern.apply(data, x0)
    nf = merged_norm_factor(kern, data, r0, x0, b)
    host = HostLoopCgKernels(n, kern.offsets, dev)
    plain_ka = functools.partial(ka_plain, data, kern.offsets)

    def run(k, plain):
        x, r = x0.clone(), r0.clone()
        rec = (cg_pipe_loop_plain(plain_ka, kb_pipe_plain, x, r, nf, checked_iterations(k), invd)
               if plain else kern.cg_pipe_loop(data, x, r, nf, checked_iterations(k), invd))
        return x, rec[0], rec[1]

    jacobi = invd is not None
    loop_row(f"cg_pipe_loop[{'BJ' if jacobi else 'none'}]", label, run,
             lambda k: cg_pipelined_fused(host, data, b, x0, checked_iterations(k), invd=invd),
             "KA + KB_pipe", ((data.shape[0] + 2) * 4 + 36 + 8 * jacobi) * n, n, report)


def check_bicgstab_loop(kern, data, label, report):
    """The merged-BiCGStab loop kernel against its plain twin (over
    k1b_plain and kb_update_plain) from the same set-up (b random, x0 = 0),
    timed in turns with the host loop over the K1B and KB_update kernels
    (bicgstab_fused with a plan that keeps the host loop): loop_row, x held
    to the twin after BICGSTAB_LOOP_CHECK iterations; the gap after
    LOOP_ITERS[0] is printed, not gated.  Minimum bytes per iteration and
    row: the first K1B the coefficients, r, p, v and r̂ in, p' and v' out;
    the second the coefficients, r and v' in, s and t out; KB_update x, p',
    s, t and r̂ in, x and r out — 8·nd + 68 (124 at 7 diagonals)."""
    n, dev = kern.n, kern.device
    b = torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    x0 = torch.zeros_like(b)
    r0 = b - kern.apply(data, x0)  # also r̂, never written
    state = (torch.sum(r0 * r0), torch.sum(torch.abs(r0)),
             merged_norm_factor(kern, data, r0, x0, b))
    host = HostLoopCgKernels(n, kern.offsets, dev)
    plain_k1b = functools.partial(k1b_plain, data, kern.offsets)

    def run(k, plain):
        x, r = x0.clone(), r0.clone()
        rec = (bicgstab_loop_plain(plain_k1b, kb_update_plain, x, r, r0, *state,
                                   checked_iterations(k)) if plain
               else kern.bicgstab_loop(data, x, r, r0, *state, checked_iterations(k)))
        return x, rec[0], rec[1]

    (xk, _, rk), (xp, _, rp) = run(LOOP_ITERS[0], False), run(LOOP_ITERS[0], True)
    err, tol = vec_err(xk, xp)
    print(f"  bicgstab_loop          {label:20s} after {LOOP_ITERS[0]} iterations (not gated): "
          f"max_abs_err {err:.3e} (vector tol {tol:.1e}), residual {float(rk):.4e} against the "
          f"twin's {float(rp):.4e}")
    loop_row("bicgstab_loop", label, run,
             lambda k: bicgstab_fused(host, data, b, x0, checked_iterations(k)),
             "K1B + K1B + KB_update", (8 * data.shape[0] + 68) * n, n, report,
             check=BICGSTAB_LOOP_CHECK)


def gen_loop_bytes(data, n, jacobi, kern=None, bs=0):
    """Minimum bytes per iteration of the general-BiCGStab loop kernel:
    SpMV A (the coefficients — Dia nd x 4 B, Gdia np x 5 B of values and
    lanes, Xell K x 7 B of slots and the spill —, r, p, v and r̂ in; p' and
    v' out), SpMV B (the coefficients, r and v' in; s and t out) and the
    update (x, p', s, t and r̂ in; x and r out): 2 x the coefficients + 68 B
    per row (124 at 7 Dia diagonals); with Jacobi invd once in each phase
    (+ 12).  With block Jacobi of bs rows (bs > 0): P (r, p, v, a row of
    inverses in; p', y out), A (the coefficients, y, r̂ in; v' out), S (r, v',
    a row of inverses in; s, z out), B (the coefficients, z, s in; t out),
    the update (x, y, z, s, t, r̂ in; x, r out): 2 x the coefficients + 8 bs
    + 92 B per row (180 at 7 diagonals and bs 4).  Ell, Csr, Sell: the least
    bytes of their SpMV (gather_spmv_bytes)."""
    per_row = 8 * bs + 92 if bs else 68 + 12 * jacobi
    if isinstance(kern, GatherCgKernels):
        return 2 * gather_spmv_bytes(kern, data) + per_row * n
    if isinstance(data, tuple) and len(data) == 4:  # Xell
        spill = data[3].numel()
        coef_bytes = (data[0].shape[1] * 7 + (4 if spill else 0)) * n + 12 * spill
        return 2 * coef_bytes + per_row * n
    coef = data[0].shape[0] * 5 if isinstance(data, tuple) else data.shape[0] * 4
    return (2 * coef + per_row) * n


def check_gen_loop(kern, data, label, report, invd=None, iters=LOOP_ITERS[1], inv_t=None,
                   res_atol=0.0):
    """The general-BiCGStab loop kernel (one variant: the plan's format,
    identity, Jacobi or, with inv_t, block Jacobi) against its plain twin
    (the host loop's operations over the plain SpMV and block_jacobi_plain)
    from the same set-up as solve/bicgstab.py (b random, x0 = 0; r0 and the
    norm factor through the format's SpMV kernel), timed in turns with the
    host loop over the standalone SpMV kernel (and the block-Jacobi kernel;
    solve/bicgstab.py without the loop): loop_row, x held to the twin within
    GEN_LOOP_RTOL after BICGSTAB_LOOP_CHECK pinned iterations (its
    normalised residual to PINNED_RTOL or within `res_atol` times the initial
    one), timed over `iters`."""
    n, dev = kern.n, kern.device
    gdia_v = isinstance(kern, GdiaCgKernels)
    xell_v = isinstance(kern, xell.XellCgKernels)
    gather_v = isinstance(kern, GatherCgKernels)
    b = torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    x0 = torch.zeros_like(b)
    pc = None if invd is None else (lambda r: invd * r)
    plain_pc = pc
    if inv_t is not None:
        pc = functools.partial(block_jacobi, inv_t)
        plain_pc = functools.partial(block_jacobi_plain, inv_t)
    ops = krylov.single_device_ops(functools.partial(kern.spmv, data), n, precond=pc)
    r0 = b - ops.matvec(x0)  # also r̂, never written
    state = (torch.sum(r0 * r0), torch.sum(torch.abs(r0)),
             stopping.initial_norm_factor(ops, r0, x0, b))
    if gather_v:
        plain_mv = functools.partial(spmv.spmv, kern.container(data))
    elif xell_v:
        plain_mv = functools.partial(xell.xell_spmv_plain, kern.plan, *data)
    elif gdia_v:
        plain_mv = functools.partial(gdia.gdia_spmv_plain, *data, kern.plane_offsets)
    else:
        plain_mv = functools.partial(dia_spmv_plain, data, kern.offsets)
    plain_ops = krylov.single_device_ops(plain_mv, n, precond=plain_pc)

    def run(k, plain):
        x, r = x0.clone(), r0.clone()
        cfg = checked_iterations(k)
        rec = (bicgstab_gen_loop_plain(plain_ops, x, r, r0, *state, cfg) if plain
               else kern.bicgstab_gen_loop(data, x, r, r0, *state, cfg, invd, inv_t))
        return x, rec[0], rec[1]

    if gather_v:
        case = f"{kern.NAME}_bicgstab_gen_loop[{formats.format_name(kern.container(data))}"
    else:
        case = f"bicgstab_gen_loop[{'Xell' if xell_v else 'Gdia' if gdia_v else 'Dia'}"
    bs = 0 if inv_t is None else inv_t.shape[1]
    pc_name = f"BJ{bs}" if bs else "none" if invd is None else "BJ"
    loop_row(f"{case} {pc_name}]", label, run,
             lambda k: bicgstab(ops, b, x0, checked_iterations(k)),
             "the SpMV kernel + " + ("the block-Jacobi kernel + " if bs else "") + "torch ops",
             gen_loop_bytes(data, n, invd is not None, kern, bs), n,
             report, check=BICGSTAB_LOOP_CHECK, iters=iters, vec_rtol=GEN_LOOP_RTOL,
             res_atol=res_atol * float(state[1] / state[2]))


def check_amg_loops(grid, device, report, dtypes=(torch.bfloat16, torch.float32)):
    """The AMG loop kernel's CG and IR variants against their plain twins
    (amg_cg_loop_plain, amg_ir_loop_plain over the plain K1 or SpMV and
    vcycle_plain) from the same set-up (b random, x0 = 0), on the
    hierarchy of testing.poisson_ldu(grid) (auto aggregation, dense coarse
    inverse), with `dtypes` smoother coefficients: x after AMG_LOOP_CHECK
    iterations, then per iteration over AMG_LOOP_TIMED checked ones in turns
    with the twin and the host-launched cycle over the standalone kernels
    (cg_fused / ir_fused with a plan that keeps the host loop): loop_row."""
    label = "x".join(map(str, grid))
    coo = ldu.ldu_to_coo_host(testing.poisson_ldu(grid), dtype=np.float32)
    mat = formats.coo_to_dia(coo, device)
    n, offs = mat.shape[0], mat.offsets
    kern = CgKernels(n, offs, device)
    host = HostLoopCgKernels(n, offs, device)
    data = kern.pack_values(mat)
    b = torch.randn(n, device=device, generator=torch.Generator(device=device).manual_seed(1))
    x0 = torch.zeros_like(b)
    r0 = b - kern.apply(data, x0)
    state = (torch.sum(torch.abs(r0)), merged_norm_factor(kern, data, r0, x0, b))
    for dtype in dtypes:
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        t0 = time.perf_counter()
        op = amg.amg(coo, device, aggregation="auto", smoother_dtype=dtype)
        print(f"  [{label}: hierarchy {[lv.n for lv in op.state]} built in "
              f"{time.perf_counter() - t0:.2f} s; {tag} smoother coefficients]")
        cycle = functools.partial(amg_loop.vcycle_plain, op.state, relax=op.relax,
                                  sweeps=op.smooth_iters)
        for name in ("cg", "ir"):
            ir_loop = name == "ir"

            def run(k, plain, ir_loop=ir_loop, op=op, cycle=cycle):
                x, r = x0.clone(), r0.clone()
                cfg = checked_iterations(k)
                if not plain:
                    loop = amg_loop.amg_ir_loop if ir_loop else amg_loop.amg_cg_loop
                    rec = loop(kern, data, op, x, r, *state, cfg)
                elif ir_loop:
                    rec = amg_loop.amg_ir_loop_plain(
                        functools.partial(dia_spmv_plain, data, offs), x, r, *state, cfg, cycle)
                else:
                    rec = amg_loop.amg_cg_loop_plain(functools.partial(k1_plain, data, offs), x,
                                                     r, *state, cfg, cycle)
                return x, rec[0], rec[1]

            def host_solve(k, ir_loop=ir_loop, op=op):
                if ir_loop:
                    return ir_fused(host, data, b, x0, checked_iterations(k), op)
                return cg_fused(host, data, b, x0, checked_iterations(k), precond=op)

            loop_row(f"amg_{name}_loop[{tag}]", label, run, host_solve,
                     "the host cycle" + ("" if ir_loop else " + K1 + K2n"),
                     amg_loop_bytes(op, data.numel() * 4, n, ir_loop), n, report,
                     check=AMG_LOOP_CHECK,
                     iters=AMG_LOOP_TIMED, vec_rtol=AMG_LOOP_RTOL)
        del op, cycle
    del mat, data, kern, host
    torch.cuda.empty_cache()


def check_dia_loops(data, offsets, label, report):
    """check_loop for the two Dia variants (identity and Jacobi), then
    check_pipe_loop for the pipelined loop's two, then check_bicgstab_loop,
    then check_gen_loop for the general-BiCGStab loop's two Dia variants."""
    kern = CgKernels(data.shape[1], offsets, data.device)
    plain_k1 = functools.partial(k1_plain, data, offsets)
    invd = 1.0 / data[offsets.index(0)]
    check_loop(kern, data, plain_k1, label, report)
    check_loop(kern, data, plain_k1, label, report, invd=invd, case="cg_loop[Dia BJ]")
    check_pipe_loop(kern, data, label, report)
    check_pipe_loop(kern, data, label, report, invd=invd)
    check_bicgstab_loop(kern, data, label, report)
    check_gen_loop(kern, data, label, report)
    check_gen_loop(kern, data, label, report, invd=invd)


def check_gdia(grids, device, report):
    """Phase 3's Gdia checks on the shuffled grid built on the device at
    each size: the SpMV and the row-quad K1 against their plain versions
    (check_unstructured_kernels), then the two Gdia variants of the CG loop
    and of the general-BiCGStab loop."""
    for dims in grids:
        mat = gdia_on_device(*shuffled_poisson_coo_on_device(dims, 0, device))
        label = "shuffled " + "x".join(map(str, dims))
        check_unstructured_kernels([(label, mat)], report)
        kern = GdiaCgKernels(mat.shape[0], mat.plane_offsets, device)
        data = kern.pack_values(mat)
        plain_k1 = functools.partial(gdia.gdia_k1_plain, *data, mat.plane_offsets)
        check_loop(kern, data, plain_k1, label, report, case="cg_loop[Gdia none]")
        invd = torch.full((mat.shape[0],), 1.0 / 6.0, device=device)  # the stencil's diagonal
        check_loop(kern, data, plain_k1, label, report, invd=invd, case="cg_loop[Gdia BJ]")
        check_gen_loop(kern, data, label, report)
        check_gen_loop(kern, data, label, report, invd=invd)
        del mat, kern, data
        torch.cuda.empty_cache()


def compare(name, label, kfn, pfn, nbytes, nflops, report, kt=None, pt=None, err=vec_err,
            reps=20, warmup=3):
    """Run kernel and plain version once on the same inputs (each returns
    (vectors, sums)), hold them to the tolerances (`err` for the vectors),
    time them (`kt`/`pt` when the timed call differs; `warmup` calls, then
    `reps` calls a turn) and record the row in `report`, with the least time the card could
    take: the larger of the minimum bytes over the memory rate and the
    operations over the float32 rate."""
    (kv, ks), (pv, ps) = kfn(), pfn()
    torch.cuda.synchronize()
    errs = [err(a, b) for a, b in zip(kv, pv)]
    max_err = max(e for e, _ in errs)
    sums = [sum_err(a, b) for a, b in zip(ks, ps)]
    ok = all(e <= t for e, t in errs) and all(s <= SUM_RTOL for s in sums)
    ms, plain_ms = time_pair(kt or kfn, pt or pfn, reps, warmup)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nflops / PEAK_F32_FLOPS * 1e3
    print(f"  {name:22s} {label:12s} max_abs_err {max_err:.3e} (tol "
          f"{max(t for _, t in errs):.1e}) sum_rel_err "
          f"{max(sums, default=0.0):.1e} (tol {SUM_RTOL:.0e})  kernel {ms:.4f} ms "
          f"{nbytes / ms / 1e6:.1f} GB/s  plain {plain_ms:.4f} ms "
          f"{nbytes / plain_ms / 1e6:.1f} GB/s  bound {max(bytes_ms, ops_ms):.4f} ms  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{name} at {label} disagrees with its plain version")
    report.setdefault(name, {})[label] = {
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "gbps": nbytes / ms / 1e6,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def dia_coo(data, offsets):
    """The nonzero entries of a Dia matrix as device COO triplets."""
    nd, n = data.shape
    i = torch.arange(n, device=data.device)
    rows, cols, vals = [], [], []
    for k, off in enumerate(offsets):
        keep = (i + off >= 0) & (i + off < n) & (data[k] != 0)
        rows.append(i[keep])
        cols.append(i[keep] + off)
        vals.append(data[k][keep])
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def csr_of_coo(rows, cols, vals, n):
    """torch's CSR tensor of COO triplets (device tensors), for library_ms."""
    order = torch.argsort(rows * n + cols)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, cols[order], vals[order], size=(n, n),
                                   check_invariants=True)


def library_beside(name, label, csr, mv, x, report, earlier=None):
    """For the record (never on the path): torch's own CSR SpMV (cuSPARSE
    behind `sparse_csr_tensor @ x`) on the same matrix beside the kernel."""
    library_call(name, label, "torch CSR SpMV (sparse_csr_tensor @ x)", lambda: csr @ x,
                 lambda: mv(x), f"the same matrix, nnz {csr.values().numel()}", report,
                 earlier and (earlier[0], lambda: earlier[1](x)))


def library_call(name, label, what, lib_fn, kern_fn, on, report, earlier=None):
    """One torch call that computes the kernel's function on the same
    inputs, held to the kernel's result and timed beside it in turns; its
    median is the kernel row's library_ms (for the record: the port never
    calls it).  `earlier`: (description, function) of the kernel's earlier
    design on the same inputs, held to the same result and timed in the
    same turns."""
    want = kern_fn()
    fns = {"library": lib_fn, "kernel": kern_fn}
    if earlier:
        fns["earlier"] = earlier[1]
    errs = {tag: vec_err(fn(), want) for tag, fn in fns.items() if tag != "kernel"}
    t = time_turns(fns)
    row = report[name][label]
    row.update(library_ms=t["library"], kernel_ms_beside_library=t["kernel"])
    line = (f"  {what} {t['library']:.4f} ms beside {name} {t['kernel']:.4f} ms")
    if earlier:
        row["earlier_design_ms"] = t["earlier"]
        line += f" and its earlier design ({earlier[0]}) {t['earlier']:.4f} ms"
    print(f"{line} on {on} ({label}); max abs difference "
          + ", ".join(f"{tag} {e:.1e} (tol {tol:.1e})" for tag, (e, tol) in errs.items()))
    bad = [tag for tag, (e, tol) in errs.items() if e > tol]
    if bad:
        raise RuntimeError(f"{name} and its {bad} disagree")


def chain_ms(fn, reps=50):
    """CUDA-event ms per call over `reps` calls enqueued back to back: the
    device's time per call when the host keeps ahead of it, the host's when
    it does not."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_beside(name, label, kern_fn, lib_fn, report):
    """For the kernel and its library call: the profiler's device time per
    launch and the time per call of a back-to-back chain, beside the
    CUDA-event times of the check (timed around each call)."""
    row = report[name][label]
    for tag, fn in (("", kern_fn), ("library_", lib_fn)):
        row[f"{tag}device_ms"] = device_ms_per_launch(fn)
        row[f"{tag}chain_ms"] = chain_ms(fn)
    dev = {k: "not measured" if row[k] is None else f"{row[k]:.4f} ms"
           for k in ("device_ms", "library_device_ms")}
    print(f"  {name} ({label}): device time per launch {dev['device_ms']} (profiler), "
          f"chained {row['chain_ms']:.4f} ms, around each call {row['ms']:.4f} ms; the library "
          f"call: device {dev['library_device_ms']}, chained "
          f"{row['library_chain_ms']:.4f} ms, around each call {row['library_ms']:.4f} ms")


def true_residual(data, offsets, x, b):
    """‖b − A x‖₁ / normfactor in float64 on the card for a Dia matrix."""
    a64 = data.double()
    return true_residual_mv(lambda v: dia_spmv_plain(a64, offsets, v), x, b)


def true_residual_mv(mv64, x, b):
    """‖b − A x‖₁ / normfactor in float64 on the card, `mv64` a float64
    product with A, with the OpenFOAM norm factor of the zero initial
    guess."""
    x64, b64 = x.double(), b.double()
    r = b64 - mv64(x64)
    b_sub = b64 - mv64(torch.zeros_like(b64))
    nf = float(torch.sum((b64 - b_sub).abs() + b_sub.abs())) + stopping.small_of(torch.float64)
    return float(r.abs().sum()) / nf


def profile_step(solve_fn):
    """Run one foam step under torch.profiler; print the step's wall time,
    the device's busy time (the union of its event intervals) by kernel and
    its idle share of the step."""
    def step():
        t0 = time.perf_counter()
        _, perf = solve_fn()
        torch.cuda.synchronize()
        return perf, (time.perf_counter() - t0) * 1e6

    (perf, wall_us), dev = device_time.device_events(step)
    if not dev:
        print("profiler recorded no device activity: device busy time not measured")
        return
    by_name: dict = {}
    for e in dev:
        c = by_name.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us()
    busy = device_time.busy_seconds(dev) * 1e6
    it = max(perf.n_iterations, 1)
    launched = sum(c for name, (c, _) in by_name.items() if not name.startswith("Memcpy"))
    print(f"step wall {wall_us / 1e3:.3f} ms, {perf.n_iterations} iterations: device busy "
          f"{busy / 1e3:.3f} ms ({busy / it:.2f} us/iteration), idle share "
          f"{1 - busy / wall_us:.3f}; wall/iteration {wall_us / it:.2f} us; "
          f"{launched} device kernels per solve ({launched / it:.2f} per iteration)")
    for name, (count, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {total:10.1f} us  x{count:5d}  {total / count:8.2f} us/launch  {name[:90]}")


def host_costs(op, device) -> None:
    """Host µs per call of each kind of launch of the host-launched AMG
    cycle, on its 16,384-row level (device work far below the host's), and
    of one whole host cycle at the fine level: 200 calls (50 cycles)
    between two syncs."""
    lv = next(lv for lv in op.state if lv.n <= 16384)
    print(f"host cost per call (host clock; kernels on the {lv.n}-row level):")
    g = torch.Generator(device=device).manual_seed(1)
    x, b = (torch.randn(lv.n, device=device, generator=g) for _ in range(2))
    x2, r2 = x.clone(), b.clone()
    r_fine = torch.randn(op.state[0].n, device=device, generator=g)
    alpha = torch.tensor(1e-3, device=device)
    calls = {
        "amg_sweep (ctypes)": lambda: lv.kern.ksweep(lv.data_s, x, b, lv.inv_diag, RELAX),
        "cg_k1 (ctypes)": lambda: lv.kern.k1(lv.mat.data, x, b, alpha),
        "cg_k2n (ctypes)": lambda: lv.kern.k2n(alpha, x2, r2, x, b),
        "x + b (torch eager)": lambda: x + b,
        "torch.sum(x) (torch eager)": lambda: torch.sum(x),
        "V-cycle at the fine level": lambda: op(r_fine),
    }
    for name, fn in calls.items():
        k = 50 if name.startswith("V-cycle") else 200
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
        print(f"  {name:28s} {(time.perf_counter() - t0) / k * 1e6:8.1f} us per call")


def describe_hierarchy(levels) -> None:
    for i, lv in enumerate(levels):
        if lv.nc:
            what = f"smoother coefficients {str(lv.data_s.dtype).removeprefix('torch.')}"
        else:
            what = "dense inverse" if lv.coarse_inv is not None else "fixed-iteration CG"
        print(f"  level {i}: {level_text(lv)}, {what}")


def level_text(lv) -> str:
    """A level's format, rows and structure: Dia offsets, Gdia planes, Ell
    width."""
    m = lv.mat
    kind = type(m).__name__
    shape = (f"{len(m.plane_offsets)} planes" if kind == "Gdia" else
             f"K {m.row_width}" if kind == "Ell" else f"offsets {m.offsets}")
    return f"{kind} {lv.n} rows, {shape}"


def plain_cycle(op):
    """The same hierarchy and host-launched cycle, at the op's settings, with
    every kernel call replaced by its plain twin (`plain_level`): the
    independent reference of the host cycle on the card."""
    return amg.cycle_op([plain_level(lv) for lv in op.state], op.cycle, op.relax,
                        op.smooth_iters, op.coarse_solver_iters)


def plain_level(lv):
    """The level with every kernel call replaced by its plain twin on the
    card: the smoother (any level format), the pgm transfers and the coarse
    SpMV."""
    if isinstance(lv.kern, CgKernels):
        kern = PlainCgKernels(lv.n, lv.mat.offsets, lv.mat.data.device)
    else:
        kern = types.SimpleNamespace(
            sweep=lambda vals, x, b, invd, relax, k=lv.kern: k.twin(vals, x, b, invd, relax),
            resid=lambda vals, x, b, k=lv.kern: k.twin(vals, x, b, None, 0.0))
    transfer = None if lv.transfer is None else types.SimpleNamespace(
        agg=lv.transfer.agg,
        restrict=lambda r, t=lv.transfer: amg_level.pgm_restrict_plain(t.table, r),
        prolong_add=lambda x, ec, t=lv.transfer: amg_level.pgm_prolong_add_plain(
            t.agg.long(), x, ec))
    mv = None if lv.matvec is None else (lambda v, m=lv.mat: spmv.spmv(m, v))
    return dataclasses.replace(lv, kern=kern, transfer=transfer, matvec=mv)


def next_params(field, ctl):
    """The stopping parameters of `field`'s next foam.solve under `ctl`, as
    FoamSolver.solve takes them (adaptMinIter from the field's last solve)."""
    cfg = parse_controls(ctl)
    props = registry.global_registry.properties(field)
    return stopping.StoppingParams.of(cfg.stopping.adapted(
        props.prev_solve_iters, props.prev_rel_res_cost, cfg.export))


def amg_twin_iterations(kind, op, data, offsets, b, params):
    """The iterations of the AMG loop's plain twin (amg_cg_loop_plain for
    GKOCG + Multigrid, amg_ir_loop_plain for GKOMultigrid) over the plain
    K1 or SpMV and vcycle_plain on `op`'s hierarchy, on the card, from a
    zero guess under `params`."""
    n = data.shape[1]
    x = torch.zeros_like(b)
    r = b - dia_spmv_plain(data, offsets, x)
    nf = merged_norm_factor(PlainCgKernels(n, offsets, b.device), data, r, x, b)
    cycle = functools.partial(amg_loop.vcycle_plain, op.state, relax=op.relax,
                              sweeps=op.smooth_iters)
    state = (x, r, torch.sum(torch.abs(r)), nf, params, cycle)
    if kind == "pGMG":
        return amg_loop.amg_ir_loop_plain(functools.partial(dia_spmv_plain, data, offsets),
                                          *state)[0]
    return amg_loop.amg_cg_loop_plain(functools.partial(k1_plain, data, offsets), *state)[0]


def amg_path(m, b, device, ctl) -> dict:
    """Phase 7: GKOCG + Multigrid and GKOMultigrid through foam.solve, each
    one launch of the AMG loop kernel; GKOCG + Multigrid with cycle w on the
    host-launched cycle; two steady steps that rebuild the hierarchy; the
    checks, and a profiled step.  Returns the launch counts of the path."""
    print(f"== phase 7: the AMG path, foam.solve at {m.n} cells")
    kernels.reset_launches()
    solves = {}
    host_field, host_extra = AMG_HOST_SOLVE
    for field, extra in (*AMG_SOLVES.items(), (host_field, host_extra)):
        params = next_params(field, {**ctl, **extra})
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, m, b, {**ctl, **extra})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        slv = registry.global_registry.get(f"{field}_solver")
        lt = slv.last_timings
        print(f"{field}: first solve wall {wall:.3f} s; generate_preconditioner "
              f"{lt['generate_preconditioner'] * 1e3:.1f} ms; solve {lt['solve'] * 1e3:.3f} ms "
              f"= {lt['solve'] / max(perf.n_iterations, 1) * 1e6:.1f} us per iteration")
        describe_hierarchy(slv._precond_op.state)
        if field in AMG_LOOP_SOLVE_LAUNCHES:
            check_loop_solve_launches(field, before, AMG_LOOP_SOLVE_LAUNCHES[field])
        else:
            check_host_cycle_launches(field, before)
        solves[field] = (x, perf, slv._precond_op, slv.matrix.data.clone(), params)

    ctl_mg = {**ctl, **AMG_SOLVES["pMG"]}
    steps = []
    m_k, b_k = m, b
    for k in (2, 3):
        m_k = dataclasses.replace(m_k, diag=np.asarray(m_k.diag) * 1.01)
        b_k = (b_k * 1.01 + 0.1).astype(np.float32)
        op_before = registry.global_registry.get("pMG_solver")._precond_op
        params = next_params("pMG", ctl_mg)
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x_k, perf_k = foam.solve("pMG", m_k, b_k, ctl_mg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf_k.print()
        check_loop_solve_launches(f"pMG step {k}", before, AMG_LOOP_SOLVE_LAUNCHES["pMG"])
        slv = registry.global_registry.get("pMG_solver")
        lt = slv.last_timings
        print(f"pMG step {k}: wall {wall * 1e3:.3f} ms, of which update "
              f"{lt.get('update_device_values', 0.0) * 1e3:.3f} ms, generate_preconditioner "
              f"{lt.get('generate_preconditioner', 0.0) * 1e3:.3f} ms and solve "
              f"{lt.get('solve', 0.0) * 1e3:.3f} ms; blocks uploaded {slv.last_blocks_uploaded}")
        fine = slv._precond_op.state[0]
        want = 1.0 / slv.matrix.data[slv.matrix.offsets.index(0)]
        if slv._precond_op is op_before or not torch.allclose(fine.inv_diag, want, rtol=1e-6):
            raise RuntimeError(f"pMG step {k}: the hierarchy was not rebuilt from the "
                               "current coefficients")
        if device.type == "cuda" and (slv._precond_op.loop_table is None
                                      or slv._precond_op.loop_table is op_before.loop_table):
            raise RuntimeError(f"pMG step {k}: the loop did not build the new hierarchy's table")
        steps.append((f"pMG step {k}", x_k, perf_k, torch.tensor(b_k, device=device),
                      slv.matrix.data.clone(), slv._precond_op, params))
    launches = {k: kernels.launches[k] for k in AMG_KERNELS}
    print(f"launch counts over the AMG path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"the AMG path never launched {missing}")

    b_dev = torch.tensor(b, device=device)
    offsets = slv.matrix.offsets
    checks = [(f, x, perf, b_dev, data, op, params)
              for f, (x, perf, op, data, params) in solves.items()]
    checks += steps
    for name, x, perf, bb, dd, op, params in checks:
        if not (perf.converged and perf.final_residual < TOL):
            raise RuntimeError(f"{name}: did not converge: {perf}")
        if x.shape != (m.n,) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{name}: solution not finite of shape ({m.n},)")
        tr = true_residual(dd, offsets, x, bb)
        line = (f"{name}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} "
                f"(limit {TRUE_RESIDUAL_MARGIN:g} x {TOL:g})")
        if name == host_field:  # the host cycle over the plain kernels
            plain = cg_fused(PlainCgKernels(m.n, offsets, device), dd, bb, torch.zeros_like(bb),
                             params, precond=plain_cycle(op)).iters
            line += f"; the host cycle over the plain twins on the card: {plain} iterations"
        else:
            plain = amg_twin_iterations(name.split()[0], op, dd, offsets, bb, params)
            line += f"; the loop's plain twin on the card: {plain} iterations"
        if abs(plain - perf.n_iterations) > 1:
            raise RuntimeError(f"{name}: {perf.n_iterations} iterations vs {plain} over the "
                               "plain twins")
        if name in AMG_ITERS and abs(perf.n_iterations - AMG_ITERS[name]) > 1:
            raise RuntimeError(f"{name}: {perf.n_iterations} iterations, not "
                               f"{AMG_ITERS[name]} +- 1")
        print(line)
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{name}: true residual {tr:.3e} above the limit")

    host_costs(solves["pMG"][2], device)
    for field in AMG_SOLVES:  # on resident state: no upload, no host set-up
        slv = registry.global_registry.get(f"{field}_solver")
        sec = slv.time_device_solve()
        it = solves[field][1].n_iterations
        print(f"{field} on resident state (time_device_solve, best of 3): {sec * 1e3:.3f} ms "
              f"for {it} iterations = {sec / it * 1e6:.1f} us per iteration")
    # a new b on the same operator: the hierarchy stays, the step is the solve
    print("torch.profiler over one more pMG step (new b, same operator):")
    b_k = (b_k * 1.01 + 0.1).astype(np.float32)
    profile_step(lambda: foam.solve("pMG", m_k, b_k, ctl_mg))
    return launches


# ---- phase 8: the unstructured path -----------------------------------------


def gdia_on_device(rows, cols, vals, n):
    """Gdia packing of a row-major sorted COO on the device — the layout of
    kernels/gdia.py `gdia_layout` (planes by block-row offset q ascending;
    within q, the k-th entry of a row goes to the q's k-th plane), which
    the host packing takes seconds to build at 8.4M rows."""
    dev = rows.device
    r = -(-n // 128)
    q = cols // 128 - rows // 128
    planes_v, planes_l, offsets = [], [], []
    for qv in torch.unique(q).tolist():
        sel = torch.nonzero(q == qv).squeeze(1)
        dst = rows[sel]
        _, inverse, counts = torch.unique_consecutive(dst, return_inverse=True,
                                                      return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        plane_of = torch.arange(len(dst), device=dev) - starts[inverse]
        for k in range(int(plane_of.max()) + 1):
            on = plane_of == k
            v = torch.zeros(r * 128, dtype=torch.float32, device=dev)
            ll = torch.zeros(r * 128, dtype=torch.int8, device=dev)
            v[dst[on]] = vals[sel[on]]
            ll[dst[on]] = (cols[sel[on]] % 128).to(torch.int8)
            planes_v.append(v.view(r, 128))
            planes_l.append(ll.view(r, 128))
            offsets.append(int(qv))
    return gdia.Gdia(vals=torch.stack(planes_v), lidx=torch.stack(planes_l),
                     plane_offsets=tuple(offsets), shape=(n, n))


def shuffled_poisson_coo_on_device(dims, seed, device):
    """testing.shuffled_poisson_ldu(dims) built on the device (torch's
    generator, so another permutation than numpy's): the 7-point Poisson
    COO with its cells renumbered inside each 128-cell run, row-major."""
    nx, ny, nz = dims
    n = nx * ny * nz
    g = torch.Generator(device=device).manual_seed(seed)
    runs = n // 128
    inv = (torch.arange(runs, device=device)[:, None] * 128 + torch.argsort(
        torch.rand(runs, 128, generator=g, device=device), dim=1)).reshape(-1)
    i = torch.arange(n, device=device)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    rows, cols, vals = [inv], [inv], [torch.full((n,), 6.0, device=device)]
    for d, mask in ((-nx * ny, iz > 0), (-nx, iy > 0), (-1, ix > 0), (1, ix < nx - 1),
                    (nx, iy < ny - 1), (nx * ny, iz < nz - 1)):
        src = i[mask]
        rows.append(inv[src])
        cols.append(inv[src + d])
        vals.append(torch.full((len(src),), -1.0, device=device))
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(rows * n + cols)
    return rows[order], cols[order], vals[order], n


def check_unstructured_kernels(cases, report):
    """Phase 8's kernel checks: each (label, matrix) against the plain
    versions, on random vectors; bytes are the minimum each kernel moves."""
    for label, mat in cases:
        n = mat.shape[0]
        dev = mat.vals.device
        g = torch.Generator(device=dev).manual_seed(0)
        x, z, p = (torch.randn(n, device=dev, generator=g) for _ in range(3))
        beta = torch.tensor(0.37, device=dev)

        def k1_out(o):
            return o[:2], o[2:]

        if isinstance(mat, gdia.Gdia):
            plan, nps = gdia.GdiaPlan.of(mat), len(mat.plane_offsets)
            data = (mat.vals, mat.lidx)
            print(f"  [{label}: {n} rows, Gdia, {nps} planes {mat.plane_offsets}]")
            compare("gdia_spmv", label, lambda: ((gdia.gdia_spmv(plan, *data, x),), ()),
                    lambda: ((gdia.gdia_spmv_plain(*data, mat.plane_offsets, x),), ()),
                    (nps * 5 + 8) * n, 2 * nps * n, report)
            compare("gdia_k1", label, lambda: k1_out(gdia.gdia_k1(plan, *data, z, p, beta)),
                    lambda: k1_out(gdia.gdia_k1_plain(*data, mat.plane_offsets, z, p, beta)),
                    (nps * 5 + 16) * n, (2 * nps + 4) * n, report)
        else:
            plan = xell.XellPlan.of(mat)
            data = (mat.vals, mat.ll, mat.bbT, mat.spill.vals)
            spill = plan.n_spill * 12 + (4 * n if plan.n_spill else 0)
            flops = 2 * (mat.n_slots * n + plan.n_spill)
            print(f"  [{label}: {n} rows, Xell, K {mat.n_slots}, c_left {mat.c_left}, c_chunks "
                  f"{mat.c_chunks}, spill {plan.n_spill}]")
            compare("xell_spmv", label, lambda: ((xell.xell_spmv(plan, *data, x),), ()),
                    lambda: ((xell.xell_spmv_plain(plan, *data, x),), ()),
                    (mat.n_slots * 7 + 8) * n + spill, flops, report)
            compare("xell_k1", label, lambda: k1_out(xell.xell_k1(plan, *data, z, p, beta)),
                    lambda: k1_out(xell.xell_k1_plain(plan, *data, z, p, beta)),
                    (mat.n_slots * 7 + 16) * n + spill, flops + 4 * n, report)
            xell_exact_on_cpu(label, plan, data, x, z, p, beta)


def xell_exact_on_cpu(label, plan, data, x, z, p, beta):
    """The Xell SpMV and K1 against their plain twins run on CPU copies of
    the same tensors: y, p' and q bit-equal (the band body rounds every
    product and sum as the twins' ops do, and the CPU's index_add adds the
    spill in row order; on the card it adds with atomics)."""
    sp = plan.spill
    cpu = xell.XellPlan(plan.n, plan.n_tiles, plan.n_slots, plan.c_left,
                        xell.SpillCsr(*(t.cpu() for t in (sp.row_ptr, sp.rows, sp.cols,
                                                          sp.gidx))))
    host = tuple(t.cpu() for t in data)
    y = xell.xell_spmv(plan, *data, x).cpu()
    pw, q, _ = xell.xell_k1(plan, *data, z, p, beta)
    pw2, q2, _ = xell.xell_k1_plain(cpu, *host, z.cpu(), p.cpu(), beta.cpu())
    diff = {"y": int((y != xell.xell_spmv_plain(cpu, *host, x.cpu())).sum()),
            "p'": int((pw.cpu() != pw2).sum()), "q": int((q.cpu() != q2).sum())}
    print(f"  xell_spmv, xell_k1 {label:12s} against their twins on CPU copies: rows that "
          f"differ {diff} (bit-equal required)")
    if any(diff.values()):
        raise RuntimeError(f"the Xell kernels at {label} are not bit-equal to their CPU twins")


def check_xell_loops(mat, coo, label, report, gen=False):
    """Both variants of the Xell loop kernel on `mat` (check_loop), Jacobi
    with 1/diag of its host COO `coo` (None: the 7-point stencil's 6); with
    `gen` also the general-BiCGStab loop's two Xell variants
    (check_gen_loop)."""
    kern = xell.XellCgKernels.for_matrix(mat)
    data = kern.pack_values(mat)
    dev = mat.vals.device
    if coo is None:
        invd = torch.full((kern.n,), 1.0 / 6.0, device=dev)
    else:
        on = coo.rows == coo.cols
        diag = np.zeros(kern.n, np.float32)
        diag[coo.rows[on]] = coo.vals[on]
        invd = torch.tensor(1.0 / diag, device=dev)
    plain_k1 = functools.partial(xell.xell_k1_plain, kern.plan, *data)
    for variant, what in XELL_LOOP_VARIANTS.items():
        check_loop(kern, data, plain_k1, label, report, invd=invd if variant else None,
                   case=f"xell_cg_loop[{what}]", iters=XELL_LOOP_ITERS)
        if gen:
            check_gen_loop(kern, data, label, report, invd=invd if variant else None,
                           iters=XELL_LOOP_ITERS[1])


def xell_beside(label, csr, mat, x, report):
    """library_beside and device_beside for the Xell SpMV."""
    mv = spmv.matvec(mat)
    library_beside("xell_spmv", label, csr, mv, x, report)
    device_beside("xell_spmv", label, lambda: mv(x), lambda: csr @ x, report)


def library_of(coo, mat, label, report):
    """library_beside (xell_beside) for a solver's host COO and its Gdia
    (Xell) matrix."""
    dev = mat.vals.device
    csr = csr_of_coo(torch.tensor(coo.rows.astype(np.int64), device=dev),
                     torch.tensor(coo.cols.astype(np.int64), device=dev),
                     torch.tensor(coo.vals, device=dev), coo.shape[0])
    x = torch.randn(coo.shape[0], device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    if isinstance(mat, gdia.Gdia):
        library_beside("gdia_spmv", label, csr, spmv.matvec(mat), x, report)
    else:
        xell_beside(label, csr, mat, x, report)


def unstructured_path(device, knn_n, grid, grid_big, ctl) -> tuple:
    """Phase 8.  Returns the launch counts of the path, its kernel report and
    the kNN-6 system (RCM-numbered) and its b, which phase 11 solves again."""
    print(f"== phase 8: the unstructured path, foam.solve at {knn_n} (kNN-6) and "
          f"{int(np.prod(grid))} (shuffled grid) cells")
    t0 = time.perf_counter()
    m_orig, perm = testing.knn_ldu(knn_n)
    t1 = time.perf_counter()
    m_knn = testing.renumber_ldu(m_orig, np.argsort(perm))
    t2 = time.perf_counter()
    m_shuf = testing.shuffled_poisson_ldu(grid)
    t3 = time.perf_counter()
    print(f"host set-up: kNN-6 graph ({m_orig.n_faces} faces) {t1 - t0:.2f} s, its RCM "
          f"renumbering {t2 - t1:.2f} s; shuffled grid {t3 - t2:.2f} s")
    b_knn = np.random.default_rng(0).normal(size=m_knn.n).astype(np.float32)
    b_shuf = np.random.default_rng(0).normal(size=m_shuf.n).astype(np.float32)
    b_orig = np.empty_like(b_knn)
    b_orig[perm] = b_knn  # the same system in the points' numbering
    meshes = {"pK": (m_knn, b_knn, "Xell"), "pS": (m_shuf, b_shuf, "Gdia")}
    pcs = {"": "none", "BJ": {"preconditioner": "BJ"}}

    kernels.reset_launches()
    solves = {}
    for mesh, (m, b, fmt) in meshes.items():
        for tag, pc in pcs.items():
            field = mesh + tag
            before = dict(kernels.launches)
            t0 = time.perf_counter()
            x, perf = foam.solve(field, m, b, {**ctl, "preconditioner": pc})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            perf.print()
            check_loop_solve_launches(field, before, GDIA_LOOP_SOLVE_LAUNCHES
                                      if fmt == "Gdia" else XELL_LOOP_SOLVE_LAUNCHES)
            slv = registry.global_registry.get(f"{field}_solver")
            lt = slv.last_timings
            print(f"{field}: first solve wall {wall:.3f} s; init_host_sparsity "
                  f"{lt['init_host_sparsity'] * 1e3:.1f} ms, convert_format "
                  f"{lt['convert_format'] * 1e3:.1f} ms, solve {lt['solve'] * 1e3:.3f} ms = "
                  f"{lt['solve'] / max(perf.n_iterations, 1) * 1e6:.1f} us per iteration; on "
                  f"resident state {slv.time_device_solve() / max(perf.n_iterations, 1) * 1e6:.2f}"
                  " us per iteration")
            if perf.solver_name != f"GKOCG_{fmt}":
                raise RuntimeError(f"{field} routed to {perf.solver_name}, not GKOCG_{fmt}")
            invd = torch.tensor(1.0 / np.asarray(m.diag, np.float32), device=device) \
                if tag else None
            solves[field] = (x, perf, slv.matrix, torch.tensor(b, device=device), invd)

    steps = {}
    for mesh, (m, b, fmt) in meshes.items():
        m2 = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
        b2 = (b * 1.01 + 0.1).astype(np.float32)
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x2, perf2 = foam.solve(mesh, m2, b2, {**ctl, "preconditioner": "none"})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf2.print()
        check_loop_solve_launches(f"{mesh} steady step", before, GDIA_LOOP_SOLVE_LAUNCHES
                                  if fmt == "Gdia" else XELL_LOOP_SOLVE_LAUNCHES)
        slv = registry.global_registry.get(f"{mesh}_solver")
        lt = slv.last_timings
        print(f"{mesh} steady step: wall {wall * 1e3:.3f} ms, of which update "
              f"{lt.get('update_device_values', 0.0) * 1e3:.3f} ms and solve "
              f"{lt.get('solve', 0.0) * 1e3:.3f} ms; blocks uploaded "
              f"{slv.last_blocks_uploaded}, rhs uploaded {slv.last_rhs_uploaded}")
        if slv.last_blocks_uploaded != (1, 2) or not slv.last_rhs_uploaded:
            raise RuntimeError(f"{mesh} steady step uploaded more than the diag block + RHS")
        steps[mesh] = (x2, perf2, slv.matrix, torch.tensor(b2, device=device), m2, b2)

    t0 = time.perf_counter()
    before = dict(kernels.launches)
    x_r, perf_r = foam.solve("pKrcm", m_orig, b_orig,
                             {**ctl, "preconditioner": "none", "reorder": "rcm"})
    torch.cuda.synchronize()
    perf_r.print()
    check_loop_solve_launches("pKrcm", before, XELL_LOOP_SOLVE_LAUNCHES)
    lt = registry.global_registry.get("pKrcm_solver").last_timings
    print(f"pKrcm (points' numbering, reorder rcm): first solve wall "
          f"{time.perf_counter() - t0:.3f} s; reorder {lt['reorder'] * 1e3:.1f} ms, "
          f"convert_format {lt['convert_format'] * 1e3:.1f} ms")
    gen_solves = {}
    for field, pc in XELL_GEN_SOLVES.items():
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, m_knn, b_knn,
                             {**ctl, "solver": "GKOBiCGStab", "preconditioner": pc})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        check_loop_solve_launches(field, before, XELL_GEN_LOOP_SOLVE_LAUNCHES)
        slv = registry.global_registry.get(f"{field}_solver")
        it = max(perf.n_iterations, 1)
        print(f"{field} (kNN-6, route {slv.route}): first solve wall {wall:.3f} s; solve "
              f"{slv.last_timings['solve'] * 1e3:.3f} ms = "
              f"{slv.last_timings['solve'] / it * 1e6:.1f} us per iteration; on resident state "
              f"{slv.time_device_solve() / it * 1e6:.2f} us per iteration")
        gen_solves[field] = (x, perf, snapshot(slv), torch.tensor(b_knn, device=device))
    launches = {k: kernels.launches[k] for k in UNSTRUCTURED_KERNELS}
    print(f"launch counts over the unstructured path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"the unstructured path never launched {missing}")
    if perf_r.solver_name != "GKOCG_Xell":
        raise RuntimeError(f"pKrcm routed to {perf_r.solver_name}, not GKOCG_Xell")
    if abs(perf_r.n_iterations - solves["pK"][1].n_iterations) > 1:
        raise RuntimeError(f"pKrcm: {perf_r.n_iterations} iterations vs "
                           f"{solves['pK'][1].n_iterations} on the pre-renumbered mesh")

    # ---- checks of the path ------------------------------------------------
    params = stopping.StoppingParams(tolerance=TOL, rel_tol=0.0, min_iter=0,
                                     max_iter=1000, frequency=1)
    checks = [(f, x, perf, mat, bb, invd) for f, (x, perf, mat, bb, invd) in solves.items()]
    checks += [(f"{mesh} step", x, perf, mat, bb, None)
               for mesh, (x, perf, mat, bb, _, _) in steps.items()]
    perm_dev = torch.tensor(perm, device=device)
    checks.append(("pKrcm", x_r[perm_dev], perf_r, solves["pK"][2], solves["pK"][3], None))
    for field, (x, perf, snap, bb) in gen_solves.items():
        check_route_solve(field, x, perf, snap, bb, False)
    for name, x, perf, mat, bb, invd in checks:
        if not (perf.converged and perf.final_residual < TOL):
            raise RuntimeError(f"{name}: did not converge: {perf}")
        if x.shape != (mat.shape[0],) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{name}: solution not finite of shape ({mat.shape[0]},)")
        tr = true_residual_mv(lambda v, mat=mat: spmv.spmv(mat, v), x, bb)
        line = (f"{name}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} "
                f"(limit {TRUE_RESIDUAL_MARGIN:g} x {TOL:g})")
        if name in solves:
            kern = plain_plan(mat)
            plain = cg_fused(kern, kern.pack_values(mat), bb, torch.zeros_like(bb), params,
                             invd=invd)
            line += f"; plain-twin merged CG on the card: {plain.iters} iterations"
            if abs(plain.iters - perf.n_iterations) > 1:
                raise RuntimeError(f"{name}: {perf.n_iterations} iterations vs "
                                   f"{plain.iters} with the plain twins")
        print(line)
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{name}: true residual {tr:.3e} above the limit")

    # ---- the kernels against their plain versions (launches not counted) ---
    print("kernels vs plain versions "
          f"(vector tol {VEC_RTOL:.0e}*max(1,max|plain|), sum rtol {SUM_RTOL:.0e}):")
    # the solvers' current containers and host COOs (after the steady step)
    knn_mat, shuf_mat = steps["pK"][2], steps["pS"][2]
    coo_knn = registry.global_registry.get("pK_solver").coo_host()
    coo_shuf = registry.global_registry.get("pS_solver").coo_host()
    t0 = time.perf_counter()
    extra = [("knn nospill", xell.xell_from_coo(coo_knn, spill_frac=0.0, device=device)),
             ("shuffled", xell.xell_from_coo(coo_shuf, device=device))]
    print(f"  host packing of the two extra Xell containers: {time.perf_counter() - t0:.2f} s")
    dev_rows = torch.tensor(coo_shuf.rows.astype(np.int64), device=device)
    dev_cols = torch.tensor(coo_shuf.cols.astype(np.int64), device=device)
    on_dev = gdia_on_device(dev_rows, dev_cols, torch.tensor(coo_shuf.vals, device=device),
                            coo_shuf.shape[0])
    if (on_dev.plane_offsets != shuf_mat.plane_offsets
            or not torch.equal(on_dev.vals, shuf_mat.vals)
            or not torch.equal(on_dev.lidx, shuf_mat.lidx)):
        raise RuntimeError("the device Gdia packing differs from the host packing")
    del on_dev, dev_rows, dev_cols
    t0 = time.perf_counter()
    big_coo = shuffled_poisson_coo_on_device(grid_big, 0, device)
    big_csr = csr_of_coo(*big_coo)
    big = gdia_on_device(*big_coo)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rows, cols, vals, n_big = big_coo
    big_xell = xell.xell_from_coo(
        formats.Coo(rows=rows.cpu().numpy().astype(np.int32),
                    cols=cols.cpu().numpy().astype(np.int32), vals=vals.cpu().numpy(),
                    shape=(n_big, n_big)),
        c_max=9, device=device)  # the kernels read c_left only; the window spans 9 chunks
    torch.cuda.synchronize()
    print(f"  shuffled grid {'x'.join(map(str, grid_big))} = {n_big} rows: Gdia built on "
          f"the device in {t1 - t0:.2f} s; Xell packed on the host in "
          f"{time.perf_counter() - t1:.2f} s")
    del big_coo, rows, cols, vals
    rows64, cols64 = coo_knn.rows.astype(np.int64), coo_knn.cols.astype(np.int64)
    q = cols64 // 128 - rows64 // 128
    print(f"  Gdia kernels on the kNN mesh: skipped — its RCM'd bandwidth of "
          f"{int(np.abs(rows64 - cols64).max())} rows spans "
          f"{int(np.count_nonzero(np.bincount(q - q.min())))} block-row offsets (at "
          "least one plane each, 5 bytes per row and plane); the ladder found it past "
          "Gdia's 48-plane budget and routed it to Xell")
    report: dict = {}
    check_unstructured_kernels([("knn", knn_mat), extra[0], ("shuffled", shuf_mat),
                                extra[1], ("shuffled big", big), ("shuffled big", big_xell)],
                               report)
    print("the Xell loop kernel vs its plain twin (x after "
          f"{XELL_LOOP_ITERS[0]} iterations; per iteration over {XELL_LOOP_ITERS[1]}):")
    for label, mat, coo in (("knn", knn_mat, coo_knn), (*extra[0], coo_knn),
                            (*extra[1], coo_shuf), ("shuffled big", big_xell, None)):
        check_xell_loops(mat, coo, label, report, gen=label in ("knn", "shuffled big"))
    del extra
    torch.cuda.empty_cache()
    library_of(coo_knn, knn_mat, "knn", report)
    library_of(coo_shuf, shuf_mat, "shuffled", report)
    x_big = torch.randn(n_big, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    library_beside("gdia_spmv", "shuffled big", big_csr, spmv.matvec(big), x_big, report)
    xell_beside("shuffled big", big_csr, big_xell, x_big, report)
    del big, big_xell, big_csr, x_big
    torch.cuda.empty_cache()

    for mesh, (x2, perf2, mat, bb, m2, b2) in steps.items():
        print(f"torch.profiler over one more {mesh} step ({type(mat).__name__}; new b):")
        b3 = (b2 * 1.01 + 0.1).astype(np.float32)
        profile_step(lambda m2=m2, b3=b3, mesh=mesh: foam.solve(
            mesh, m2, b3, {**ctl, "preconditioner": "none"}))
    return launches, report, (m_knn, b_knn)


# ---- phase 9: slice 4, the pipelined CG and GKOBiCGStab ----------------------

# field -> (controls, system, free-running count gated at ±1 against the
# plain-twin route).  GKOCG pipelinedCG on the Poisson grid, then
# GKOBiCGStab as the reference bench ran it there (bench.py:799-806), on the
# asymmetric convection-diffusion system and on the shuffled grid (Gdia).
# BiCGStab's float32 residual history on a Poisson system is erratic: two
# routes whose sums round differently agree over the first iterations and
# then part, and stop apart by more than one iteration near the tolerance —
# so there the routes are held to each other pinned at PINNED_ITERS, and
# their free-running counts are printed side by side.
SLICE4_SOLVES = {
    "pP": ({"solver": "GKOCG", "pipelinedCG": True, "preconditioner": "none"}, "poisson", True),
    "pPBJ": ({"solver": "GKOCG", "pipelinedCG": True,
              "preconditioner": {"preconditioner": "BJ"}}, "poisson", True),
    "uBJ": ({"solver": "GKOBiCGStab", "preconditioner": {"preconditioner": "BJ"}}, "poisson",
            False),
    "u": ({"solver": "GKOBiCGStab", "preconditioner": "none"}, "poisson", False),
    "uF": ({"solver": "GKOBiCGStab", "preconditioner": "none", "fusedBiCGStab": True},
           "poisson", False),
    "uCD": ({"solver": "GKOBiCGStab", "preconditioner": {"preconditioner": "BJ"}},
            "convection-diffusion", True),
    "uCDF": ({"solver": "GKOBiCGStab", "preconditioner": "none", "fusedBiCGStab": True},
             "convection-diffusion", True),
    "uS": ({"solver": "GKOBiCGStab", "preconditioner": "none"}, "shuffled", False),
}
PINNED_ITERS = (10, 25)  # gated at the first: normalised residuals within PINNED_RTOL
PINNED_RTOL = 1e-4


def route_solve(snap, b, params, plain):
    """Solve again from a zero guess on the route a foam solve took
    (`snap`: route, matrix, merged plan, invd), with the kernels or
    (plain=True) over the plain twins on the card."""
    route, mat, kern, invd = snap
    n = mat.shape[0]
    x0 = torch.zeros_like(b)
    if route in ("cg_pipe_fused", "bicgstab_fused"):
        kern = PlainCgKernels(n, mat.offsets, b.device) if plain else kern
        if route == "cg_pipe_fused":
            return cg_pipelined_fused(kern, mat.data, b, x0, params, invd=invd)
        return bicgstab_fused(kern, mat.data, b, x0, params)
    if route != "bicgstab":
        raise RuntimeError(f"phase 9 has no check for route {route}")
    mv = (lambda v: spmv.spmv(mat, v)) if plain else spmv.matvec(mat)
    pc = (lambda r: invd * r) if invd is not None else None
    # the kernel route: the general-BiCGStab loop kernel where the solve took it
    kern = None if plain else kern
    return bicgstab(krylov.single_device_ops(mv, n, precond=pc), b, x0, params, kern,
                    None if kern is None else kern.pack_values(mat), invd)


def check_route_solve(field, x, perf, snap, bb, gated):
    """A phase-9 (or phase-8 BiCGStab) solve of `field` on the route it took
    (`snap`, from `snapshot`): converged, finite, the true float64 residual
    within its limit, the same route over the plain twins on the card held
    to it pinned at PINNED_ITERS[0] (and, when `gated`, free-running at ±1),
    and the kernel route repeating its own count (printed beside the count
    with b nudged by one ulp)."""
    mat = snap[1]
    n = mat.shape[0]
    if not (perf.converged and perf.final_residual < TOL):
        raise RuntimeError(f"{field}: did not converge: {perf}")
    if x.shape != (n,) or not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"{field}: solution not finite of shape ({n},)")
    tr = true_residual_mv(lambda v: spmv.spmv(mat, v), x, bb)
    params = stopping.StoppingParams.of(
        registry.global_registry.get(f"{field}_solver").cfg.stopping)
    plain = route_solve(snap, bb, params, plain=True)
    line = (f"{field}: iterations {perf.n_iterations}, final residual "
            f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} (limit "
            f"{TRUE_RESIDUAL_MARGIN:g} x {TOL:g}); the route over the plain twins on the "
            f"card: {plain.iters} iterations ({'gated at ±1' if gated else 'not gated'})")
    for k in PINNED_ITERS:
        pin = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=k, max_iter=k,
                                      frequency=1)
        rk, rp = (float(route_solve(snap, bb, pin, twins).final_res_norm)
                  for twins in (False, True))
        rel = abs(rk - rp) / rp
        line += f"; pinned {k}: residual {rk:.4e} vs {rp:.4e} (rel {rel:.1e})"
        if k == PINNED_ITERS[0] and rel > PINNED_RTOL:
            raise RuntimeError(f"{field}: after {k} iterations the kernels' residual "
                               f"{rk:.4e} differs from the plain twins' {rp:.4e}")
    # the kernels are deterministic (no float atomics): the same inputs give
    # the same count; b nudged by one ulp shows how far rounding alone moves
    # the stop
    again = route_solve(snap, bb, params, plain=False).iters
    nudged = route_solve(snap, bb * (1 + 2.0 ** -23), params, plain=False).iters
    line += (f"; the kernel route again: {again} iterations, with b x (1 + 2^-23): "
             f"{nudged}")
    print(line)
    if again != perf.n_iterations:
        raise RuntimeError(f"{field}: the kernel route took {again} iterations from the "
                           f"inputs that took {perf.n_iterations}")
    if gated and abs(plain.iters - perf.n_iterations) > 1:
        raise RuntimeError(f"{field}: {perf.n_iterations} iterations vs {plain.iters} "
                           "over the plain twins")
    if tr > TRUE_RESIDUAL_MARGIN * TOL:
        raise RuntimeError(f"{field}: true residual {tr:.3e} above the limit")


def snapshot(slv):
    """What route_solve needs of a solver, the matrix values copied (later
    steady steps overwrite them)."""
    mat = slv.matrix
    mat = dataclasses.replace(mat, data=mat.data.clone()) if isinstance(mat, formats.Dia) else mat
    invd = slv._precond_op.state.clone() if slv.cfg.precond.name == "BJ" else None
    return slv.route, mat, slv.kern, invd


def slice4_path(m, b, grid, device, ctl, cg_iters) -> dict:
    """Phase 9.  Returns the launch counts of the path."""
    n = m.n
    print(f"== phase 9: slice 4, the pipelined CG and GKOBiCGStab, foam.solve at {n} cells")
    t0 = time.perf_counter()
    systems = {"poisson": (m, b), "convection-diffusion": (
        testing.convection_diffusion_ldu(grid), b), "shuffled": (
        testing.shuffled_poisson_ldu(grid), b)}
    print(f"host set-up: convection-diffusion and shuffled systems {time.perf_counter() - t0:.2f} s")
    ctl = {**ctl, "verbose": 0}
    kernels.reset_launches()
    solves = {}
    for field, (spec, system, _) in SLICE4_SOLVES.items():
        mk, bk = systems[system]
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, mk, bk, {**ctl, **spec})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        slv = registry.global_registry.get(f"{field}_solver")
        if field in ("pP", "pPBJ"):  # the whole loop is one launch
            check_loop_solve_launches(field, before, PIPE_LOOP_SOLVE_LAUNCHES)
        if field in ("uF", "uCDF"):
            check_loop_solve_launches(field, before, BICGSTAB_LOOP_SOLVE_LAUNCHES)
        if field in ("u", "uBJ", "uCD", "uS"):  # the general BiCGStab: one loop launch
            check_loop_solve_launches(field, before, GDIA_GEN_LOOP_SOLVE_LAUNCHES
                                      if system == "shuffled" else GEN_LOOP_SOLVE_LAUNCHES)
        it = max(perf.n_iterations, 1)
        used = {k: round((v - before[k]) / it, 2) for k, v in kernels.launches.items()
                if v > before[k]}
        print(f"{field} ({system}, route {slv.route}): first solve wall {wall:.3f} s; solve "
              f"{slv.last_timings['solve'] * 1e3:.3f} ms = "
              f"{slv.last_timings['solve'] / it * 1e6:.1f} us per iteration; launches per "
              f"iteration {used}")
        solves[field] = (x, perf, snapshot(slv), mk, torch.tensor(bk, device=device))
    print(f"pipelined CG iterations {solves['pP'][1].n_iterations} (none), "
          f"{solves['pPBJ'][1].n_iterations} (BJ) beside the classical merged CG's "
          f"{cg_iters['p']} and {cg_iters['pBJ']} (phase 4); GKOBiCGStab none unfused "
          f"{solves['u'][1].n_iterations}, fused {solves['uF'][1].n_iterations}")
    # GKOBiCGStab `none` on the Poisson grid: the general route and the fused
    # loop, each re-run on its resident state (no upload, no host set-up;
    # best of three)
    line = []
    for field in ("u", "uF", "uBJ", "uCD"):
        slv = registry.global_registry.get(f"{field}_solver")
        sec = slv.time_device_solve()
        it = max(solves[field][1].n_iterations, 1)
        line.append(f"{field} (route {slv.route}) {sec * 1e3:.3f} ms = "
                    f"{sec / it * 1e6:.2f} us per iteration over {it}")
    print("GKOBiCGStab none, BJ and convection-diffusion BJ, device solve: "
          + " against ".join(line))

    # the asymmetric system's steady steps: diag only, then every block
    m_cd = systems["convection-diffusion"][0]
    steps = []
    for tag, mk, bk, want in (
            ("diag-only", dataclasses.replace(m_cd, diag=np.asarray(m_cd.diag) * 1.01),
             b * 1.01 + 0.1, (1, 3)),
            ("all blocks", dataclasses.replace(
                m_cd, diag=np.asarray(m_cd.diag) * 1.02, upper=np.asarray(m_cd.upper) * 0.98,
                lower=np.asarray(m_cd.lower) * 0.97), b * 0.9 - 0.1, (3, 3))):
        bk = bk.astype(np.float32)
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve("uCD", mk, bk, {**ctl, **SLICE4_SOLVES["uCD"][0]})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        slv = registry.global_registry.get("uCD_solver")
        lt = slv.last_timings
        print(f"uCD {tag} step: wall {wall * 1e3:.3f} ms, of which update "
              f"{lt.get('update_device_values', 0.0) * 1e3:.3f} ms and solve "
              f"{lt.get('solve', 0.0) * 1e3:.3f} ms; blocks uploaded "
              f"{slv.last_blocks_uploaded}, rhs uploaded {slv.last_rhs_uploaded}")
        if slv.last_blocks_uploaded != want or not slv.last_rhs_uploaded:
            raise RuntimeError(f"uCD {tag} step uploaded {slv.last_blocks_uploaded} blocks, "
                               f"not {want}, and the RHS")
        check_loop_solve_launches(f"uCD {tag} step", before, GEN_LOOP_SOLVE_LAUNCHES)
        steps.append((f"uCD {tag} step", x, perf, slv.matrix.data.clone(), slv.matrix.offsets,
                      torch.tensor(bk, device=device)))
    launches = {k: kernels.launches[k] for k in SLICE4_KERNELS}
    print(f"launch counts over slice 4's path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"slice 4's path never launched {missing}")

    # ---- checks of the path ------------------------------------------------
    for name, x, perf, dd, offs, bb in steps:
        if not (perf.converged and perf.final_residual < TOL):
            raise RuntimeError(f"{name}: did not converge: {perf}")
        tr = true_residual(dd, offs, x, bb)
        print(f"{name}: iterations {perf.n_iterations}, true float64 residual {tr:.3e}")
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{name}: true residual {tr:.3e} above the limit")
    for field, (x, perf, snap, mk, bb) in solves.items():
        check_route_solve(field, x, perf, snap, bb, SLICE4_SOLVES[field][2])
        if field == "pP" and abs(perf.n_iterations - P_ITERS) > 1:
            raise RuntimeError(f"pP: {perf.n_iterations} iterations, not {P_ITERS} +- 1")

    for field in ("uF", "pP"):
        spec = SLICE4_SOLVES[field][0]
        print(f"torch.profiler over one steady step of {field} (diag x1.01, new b):")
        m2 = dataclasses.replace(m, diag=np.asarray(m.diag) * 1.01)
        b2 = (b * 1.01 + 0.1).astype(np.float32)
        profile_step(lambda field=field, spec=spec, m2=m2, b2=b2: foam.solve(
            field, m2, b2, {**ctl, **spec}))
    return launches


# ---- phase 10: slice 5, the bench's headline lanes ---------------------------


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def check_read_peak(grids, device, report) -> None:
    """The plane-sum kernel against its plain version on READ_PLANES planes
    of each grid's rows, with c = 1 (the bench's carry), and torch.sum(d, 0)
    — the same function at c = 1 — beside it."""
    one = torch.ones((), device=device)
    g = torch.Generator(device=device).manual_seed(0)
    for dims in grids:
        n = int(np.prod(dims))
        label = "x".join(map(str, dims))
        d = torch.randn((READ_PLANES, n), device=device, generator=g)
        print(f"  [{label}: {READ_PLANES} planes of {n} rows]")
        compare("read_peak", label, lambda: ((roofline.plane_sum(one, d),), ()),
                lambda: ((roofline.plane_sum_plain(one, d),), ()),
                (READ_PLANES + 1) * n * 4, READ_PLANES * n, report)
        if report["read_peak"][label]["max_abs_err"] != 0.0:
            raise RuntimeError(f"read_peak at {label} is not bit-equal to its plain version")
        library_call("read_peak", label, "torch.sum(d, 0)", lambda: torch.sum(d, 0),
                     lambda: roofline.plane_sum(one, d), "the same planes", report)
        device_beside("read_peak", label, lambda: roofline.plane_sum(one, d),
                      lambda: torch.sum(d, 0), report)
        del d
    torch.cuda.empty_cache()


def bench_path(device, grid_main, grid_big, report) -> tuple:
    """Phase 10.  Returns the launch counts of the path and the bench's
    peaks."""
    print("== phase 10: slice 5, the bench's headline lanes (ogl_tpu_torch.bench.run) at "
          f"{int(np.prod(grid_main))} and {int(np.prod(grid_big))} rows")
    print("read-peak kernel vs plain version "
          f"(vector tol {VEC_RTOL:.0e}*max(1,max|plain|)):")
    check_read_peak((grid_main, grid_big), device, report)
    print(card_line())
    print(f"published memory rate of {torch.cuda.get_device_name(0)}: "
          f"{roofline.hbm_peak_gbps(device):.0f} GB/s")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = bench.run(device, grid_main, grid_big)
    launches = {k: kernels.launches[k] for k in BENCH_KERNELS}
    print(f"bench lanes {time.perf_counter() - t0:.1f} s; launch counts over the bench path "
          f"(a graph-replayed chain counts the launches of its capture): "
          f"{dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"the bench path never launched {missing}")
    for key in ("cg", "cg_big"):
        lane = res[key]
        busy = lane.get("device_ms")
        idle = ("not measured" if busy is None else
                f"device busy {busy * 1e3 / lane['iters']:.2f} us per iteration, idle share "
                f"{max(0.0, 1 - busy / lane['solve_ms']):.3f}")
        print(f"bench CG lane {key} (n={lane['n']}): {lane['us_per_iter']:.2f} us per iteration "
              f"over {lane['iters']} iterations; {idle}")
    return launches, res["peaks"]


# ---- phase 11: slice 14, the reference-parity formats ------------------------

# matrixFormat -> the kernel its SpMV launches (a device Coo runs the CSR
# kernel over its row_ptr)
GATHER_FORMATS = {"Coo": "csr_spmv", "Csr": "csr_spmv", "Ell": "ell_spmv",
                  "Sell": "sell_spmv", "Hybrid": "hybrid_spmv"}
GATHER_KERNELS = ("csr_spmv", "ell_spmv", "sell_spmv", "hybrid_spmv")
# the SpMVs of a general route's solve, (set-up, per iteration); the
# criterion's residual-eval timing adds RES_EVAL_SPMVS
GENERAL_ROUTE_SPMVS = {"cg": (2, 1), "cg_pipe": (3, 1), "bicgstab": (2, 2)}
# the loop kernels: a GKOCG (GKOBiCGStab) `none` or `BJ` solve on a gather
# format runs its format's variant of the CG (general-BiCGStab) loop kernel
# once (Ell and Hybrid the Ell one, Coo and Csr the Csr one), counted as
# <plan NAME>_<ROUTE_LOOPS[route]>; the pipelined CG none
ROUTE_LOOPS = {"cg": "cg_loop", "bicgstab": "bicgstab_gen_loop"}
GATHER_LOOPS = tuple(f"{fmt}_{loop}" for fmt in ("ell", "csr", "sell")
                     for loop in ROUTE_LOOPS.values())
LOOP_KERNELS = ("cg_loop", "cg_pipe_loop", "bicgstab_loop", "bicgstab_gen_loop",
                "xell_cg_loop", "amg_cg_loop", "amg_ir_loop", *GATHER_LOOPS)
# the plan of each gather format's loops (foam/solver.py picks the same)
GATHER_PLANS = {formats.Ell: EllCgKernels, formats.Hybrid: EllCgKernels,
                formats.Csr: CsrCgKernels, formats.DeviceCoo: CsrCgKernels,
                formats.Sell: SellCgKernels}
# iterations gated at ±1 at the slices' size: GKOCG `none` and `BJ` on the 1M
# kNN-6 mesh in every format (the Xell route's counts on the same system),
# GKOBiCGStab `none` and `BJ` there in every format (phase 8's uK, uKBJ on
# Xell), GKOCG on the Poisson grid as Csr (P_ITERS), GKOBiCGStab `BJ` on
# convection-diffusion as Csr (phase 9's uCD)
GATHER_ITERS = {"none": 28, "BJ": 23, "uK": 21, "uKBJ": 17, "gP": 275, "gCD": 24}
# the gather loop rows' check and timing iterations (their plain twins take
# 2-12 ms per iteration at kNN 1M: three torch ops per slot or entry step of
# an SpMV; timed over 20, then 10, and 5 since phase 14 took the device
# V-cycle's unstructured variants, to keep the script within its time)
GATHER_LOOP_ITERS = (30, 5)
# every loop kernel's ms per iteration: a pinned launch of this many
# iterations less one of the timing's, so the set-up and the record's read
# (a run's fixed 0.3-0.4 ms) drop out of the row (30, not 50, keeps the
# script within its time)
LOOP_TIMED_LONG = 30
ELL_LANDING_CELLS = 20000  # the kNN-6 mesh in its points' numbering: lands on Ell
CSR_GROUPS = (1, 2, 4, 8, 16, 32)  # the CSR kernel's lanes per row


def csr_groups_beside(pick):
    """The lanes per row phase 11 times on a graph: csr_group's pick and the
    next one up (every size is in PERF.md §6, row 18)."""
    return tuple(g for g in CSR_GROUPS if g in (pick, 2 * pick))
# the converters of the formats whose kernels phase 11 times (the solver's own)
GATHER_CONVERTERS = {"Csr": formats.coo_to_csr, "Ell": formats.coo_to_ell,
                     "Sell": formats.coo_to_sell, "Hybrid": formats.coo_to_hybrid}


def gather_bytes_flops(m, nnz):
    """The least bytes and the flops of y = A x for a matrix of `nnz`
    entries in the format of `m`, whatever its padding: each value and
    column index once (nnz * 8), x once, y once, and the index arrays the
    format cannot do without — Csr its row offsets, Sell its row
    permutation, Hybrid its tail's rows (its row offsets or one row per
    tail entry, whichever is less); Ell needs none.  Beside them, the
    bytes the kernel moves over the format's storage, padding included:
    roofline.spmv_bytes (the reference's model) for Csr and Ell, plus the
    slot rows for Sell; for Hybrid, which has no model there, its Ell part,
    its tail and the tail's row offsets, x and y."""
    n = m.shape[0]
    least = nnz * 8 + 2 * n * 4
    if isinstance(m, formats.Csr):
        least += (n + 1) * 4
    elif isinstance(m, formats.Sell):
        least += n * 4
    elif isinstance(m, formats.Hybrid):
        least += min(m.tail.nnz, n + 1) * 4
    if isinstance(m, formats.Hybrid):
        stored = n * m.ell.row_width * 8 + m.tail.nnz * 8 + (n + 1) * 4 + 2 * n * 4
    elif isinstance(m, formats.Sell):
        stored = roofline.spmv_bytes(m) + m.slot_rows.numel() * 4
    else:
        stored = roofline.spmv_bytes(m)
    return least, 2 * nnz, stored


def check_gather_kernels(mats, label, x, csr, report):
    """Each gather kernel against its twin on the card (bit-equal: the twin
    repeats the kernel's order), timed in turns, with its bound from the
    function's least bytes and the bytes its format stores beside it, and
    torch's CSR SpMV on the same matrix beside it (library_ms); the lanes
    the Sell slices read."""
    nnz = csr.values().numel()
    for fmt, m in mats.items():
        name = GATHER_FORMATS[fmt]
        mv = spmv.matvec(m)
        nbytes, flops, stored = gather_bytes_flops(m, nnz)
        compare(name, label, lambda: ((mv(x),), ()), lambda: ((spmv.spmv(m, x),), ()),
                nbytes, flops, report)
        y, want = mv(x), spmv.spmv(m, x)
        differ = int((y != want).sum())
        n = m.shape[0]
        print(f"  {name:22s} {label:12s} rows that differ from the twin on the card: {differ} "
              f"(bit-equal required); least {nbytes / n:.1f} bytes per row (the bound's), "
              f"the format's {stored / n:.1f} ({stored / nbytes:.2f}x)")
        if differ:
            raise RuntimeError(f"{name} at {label} is not bit-equal to its twin")
        if fmt in ("Ell", "Hybrid"):  # the slots its warps read (csrc/ell_rows.cuh)
            ell = m.ell if fmt == "Hybrid" else m
            print(f"  {name:22s} {label:12s} its warps stop at "
                  f"{float(ell.warp_slots.float().mean()):.2f} of {ell.row_width} slots on mean")
        if fmt == "Sell":  # the lanes its slices read (csrc/sell_rows.cuh)
            bucket_w = torch.tensor(m.widths, device=x.device)[m.slice_buckets.long()]
            read = float(m.slice_widths.double().sum()) * m.slice_height * 8 / n
            print(f"  {name:22s} {label:12s} its slices stop at "
                  f"{float(m.slice_widths.float().mean()):.2f} lanes of their buckets' "
                  f"{float(bucket_w.float().mean()):.2f} on mean: {read:.1f} bytes of values "
                  f"and columns read per row of the {m.stored * 8 / n:.1f} stored")
            report[name][label]["read_bytes_per_row"] = read
        library_beside(name, label, csr, mv, x, report)
        report[name][label].update(bytes_per_row=nbytes / n, stored_bytes_per_row=stored / n)
        if fmt == "Csr":  # the CSR kernel at its group size and the next, in turns
            pick = gather_spmv.csr_group(m.shape[0], m.nnz)
            t = time_turns({g: functools.partial(gather_spmv.csr_spmv, m, x, g)
                            for g in csr_groups_beside(pick)})
            print(f"  csr_spmv {label}: ms at each number of lanes per row (csr_group picks "
                  f"{gather_spmv.csr_group(m.shape[0], m.nnz)}): "
                  + ", ".join(f"{g}: {v:.4f}" for g, v in t.items()))
            report[name][label]["ms_by_lanes_per_row"] = t


def csr_lanes_on_random_graphs(device, report, entries=1 << 24):
    """The CSR kernel at its number of lanes per row and the next, in turns,
    on random graphs of 16, 64 and 256 entries per row (`entries` each, columns
    uniform and sorted within a row): the rows longer than the meshes', on
    which csr_group takes G > 1."""
    g = torch.Generator(device=device).manual_seed(1)
    for width in (16, 64, 256):
        n = entries // width
        cols = torch.sort(torch.randint(0, n, (n, width), device=device, generator=g),
                          dim=1).values
        m = formats.Csr(row_ptr=(torch.arange(n + 1, device=device) * width).to(torch.int32),
                        cols=cols.reshape(-1).to(torch.int32),
                        vals=torch.randn(n * width, device=device, generator=g),
                        shape=(n, n))
        x = torch.randn(n, device=device, generator=g)
        pick = gather_spmv.csr_group(n, m.nnz)
        t = time_turns({lanes: functools.partial(gather_spmv.csr_spmv, m, x, lanes)
                        for lanes in csr_groups_beside(pick)})
        label = f"random {width} per row"
        print(f"  csr_spmv {label} ({n} rows): ms at each number of lanes per row (csr_group "
              f"picks {pick}): " + ", ".join(f"{lanes}: {v:.4f}" for lanes, v in t.items()))
        report.setdefault("csr_spmv", {})[label] = {"ms_by_lanes_per_row": t,
                                                    "csr_group": pick}
        del m, cols, x
    torch.cuda.empty_cache()


def general_route_solve(route, mat, b, params, invd, plain):
    """A general route's solve from a zero guess over the format's kernel
    (plain=False) or its plain twin (plain=True), on the card."""
    mv = (lambda v: spmv.spmv(mat, v)) if plain else spmv.matvec(mat)
    pc = (lambda r: invd * r) if invd is not None else None
    solver = {"cg": cg, "cg_pipe": cg_pipelined, "bicgstab": bicgstab}[route]
    return solver(krylov.single_device_ops(mv, mat.shape[0], precond=pc), b,
                  torch.zeros_like(b), params)


@contextlib.contextmanager
def twins_refused():
    """While the path's solves run, a plain twin of a gather kernel called on
    anything raises: on the card the solves must go through the kernels."""
    saved = {name: getattr(gather_spmv, name) for name in ("spmv_csr", "spmv_ell", "spmv_sell",
                                                          "spmv_hybrid")}

    def refuse(*args, **kw):
        raise RuntimeError("a plain twin of a gather kernel ran inside a solve")

    for name in saved:
        setattr(gather_spmv, name, refuse)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(gather_spmv, name, fn)


def loop_of(slv):
    """The loop kernel a solver's solve launches on the card (None: its
    route's host loop)."""
    return None if slv.kern is None else f"{slv.kern.NAME}_{ROUTE_LOOPS[slv.route]}"


def check_gather_launches(field, route, kernel, iters, before, loop=None):
    """Between `before` and now: one launch of the format's kernel per SpMV
    of the route and no loop kernel; or, where the solve ran the loop kernel
    `loop`, that kernel once, no other loop kernel, and the format's kernel
    for the set-up and the residual-eval timing only."""
    setup, per_iter = GENERAL_ROUTE_SPMVS[route]
    want = {kernel: setup + (0 if loop else per_iter * iters) + RES_EVAL_SPMVS,
            **{k: int(k == loop) for k in LOOP_KERNELS}}
    got = {k: kernels.launches[k] - before[k] for k in want}
    print(f"  {field}: launches in this solve {got}")
    if got != want:
        raise RuntimeError(f"{field}: launched {got} in one solve, not {want}")


def check_gather_loops(mat, invd, label, report, iters):
    """The format's variants of the CG loop kernel (check_loop) and of the
    general-BiCGStab loop kernel (check_gen_loop), `none` and `BJ` with the
    inverse diagonal `invd` (None: the 7-point stencil's 1/6), on the Ell,
    Hybrid, Csr or Sell matrix `mat`."""
    kern = GATHER_PLANS[type(mat)].for_matrix(mat)
    data = kern.pack_values(mat)
    if invd is None:
        invd = torch.full((kern.n,), 1.0 / 6.0, device=kern.device)
    fmt = formats.format_name(mat)
    for pc, iv in (("none", None), ("BJ", invd)):
        check_loop(kern, data, functools.partial(gather_k1_plain, mat), label, report, invd=iv,
                   case=f"{kern.NAME}_cg_loop[{fmt} {pc}]", iters=iters)
        check_gen_loop(kern, data, label, report, invd=iv, iters=iters[1])


def gather_path(device, m_knn, b_knn, m_grid, b_grid, grid, grid_big, ctl) -> tuple:
    """Phase 11.  Returns the launch counts of the path and its kernel
    report."""
    print(f"== phase 11: slices 14-16, the reference-parity formats, foam.solve at {m_knn.n} "
          f"(kNN-6) and {m_grid.n} (Poisson, convection-diffusion) cells")
    ctl = {**ctl, "verbose": 0}
    t0 = time.perf_counter()
    m_cd = testing.convection_diffusion_ldu(grid)
    m_land, _ = testing.knn_ldu(ELL_LANDING_CELLS)
    b_land = np.random.default_rng(0).normal(size=m_land.n).astype(np.float32)
    print(f"host set-up: convection-diffusion system and the {ELL_LANDING_CELLS}-cell kNN-6 "
          f"mesh {time.perf_counter() - t0:.2f} s")
    pcs = {"": "none", "BJ": {"preconditioner": "BJ"}}
    # field -> (system, b, controls, iterations gate key or None)
    solves = {f"g{fmt}{tag}": (m_knn, b_knn, {"matrixFormat": fmt, "preconditioner": pc},
                               "BJ" if tag else "none")
              for fmt in GATHER_FORMATS for tag, pc in pcs.items()}
    solves.update({f"u{fmt}{tag}": (m_knn, b_knn, {"solver": "GKOBiCGStab", "matrixFormat": fmt,
                                                  "preconditioner": pc}, f"uK{tag}")
                   for fmt in GATHER_FORMATS for tag, pc in pcs.items()})
    solves.update({
        "gPipe": (m_knn, b_knn, {"matrixFormat": "Csr", "pipelinedCG": True,
                                 "preconditioner": "none"}, None),
        "gP": (m_grid, b_grid, {"matrixFormat": "Csr", "preconditioner": "none"}, "gP"),
        "gCD": (m_cd, b_grid, {"solver": "GKOBiCGStab", "matrixFormat": "Csr",
                               "preconditioner": {"preconditioner": "BJ"}}, "gCD"),
        "gL": (m_land, b_land, {"preconditioner": "none"}, None),
    })
    records = {}
    kernels.reset_launches()
    with twins_refused():
        for field, (mk, bk, spec, gate) in solves.items():
            before = dict(kernels.launches)
            t0 = time.perf_counter()
            x, perf = foam.solve(field, mk, bk, {**ctl, **spec})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            perf.print()
            slv = registry.global_registry.get(f"{field}_solver")
            fmt = formats.format_name(slv.matrix)
            check_gather_launches(field, slv.route, GATHER_FORMATS[fmt], perf.n_iterations,
                                  before, loop_of(slv))
            it = max(perf.n_iterations, 1)
            lt = slv.last_timings
            print(f"{field} ({fmt}, route {slv.route}): first solve wall {wall:.3f} s; "
                  f"init_host_sparsity {lt['init_host_sparsity'] * 1e3:.1f} ms, convert_format "
                  f"{lt['convert_format'] * 1e3:.1f} ms, solve {lt['solve'] * 1e3:.3f} ms = "
                  f"{lt['solve'] / it * 1e6:.1f} us per iteration; on resident state "
                  f"{slv.time_device_solve() / it * 1e6:.2f} us per iteration")
            invd = slv._precond_op.state if slv.cfg.precond.name == "BJ" else None
            records[field] = (x, perf, slv.route, slv.matrix, torch.tensor(bk, device=device),
                              invd, stopping.StoppingParams.of(slv.cfg.stopping), gate)
        for field in ("gCsr", "gEll"):
            mk, bk = m_knn, b_knn
            m2 = dataclasses.replace(mk, diag=np.asarray(mk.diag) * 1.01)
            b2 = (bk * 1.01 + 0.1).astype(np.float32)
            step_ctl = {**ctl, **solves[field][2]}
            params = next_params(field, step_ctl)
            before = dict(kernels.launches)
            x2, perf2 = foam.solve(field, m2, b2, step_ctl)
            torch.cuda.synchronize()
            perf2.print()
            slv = registry.global_registry.get(f"{field}_solver")
            check_gather_launches(f"{field} steady step", slv.route,
                                  GATHER_FORMATS[formats.format_name(slv.matrix)],
                                  perf2.n_iterations, before, loop_of(slv))
            lt = slv.last_timings
            print(f"{field} steady step: update {lt.get('update_device_values', 0.0) * 1e3:.3f} "
                  f"ms, solve {lt.get('solve', 0.0) * 1e3:.3f} ms; blocks uploaded "
                  f"{slv.last_blocks_uploaded}, rhs uploaded {slv.last_rhs_uploaded}; adapted "
                  f"minIter {params.min_iter} frequency {params.frequency}")
            if slv.last_blocks_uploaded != (1, 2) or not slv.last_rhs_uploaded:
                raise RuntimeError(f"{field} steady step uploaded more than the diag block + RHS")
            records[f"{field} step"] = (x2, perf2, slv.route, slv.matrix,
                                        torch.tensor(b2, device=device), None, params, None)
    launches = {k: kernels.launches[k] for k in (*GATHER_KERNELS, *GATHER_LOOPS)}
    print(f"launch counts over the path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"the reference-parity formats' path never launched {missing}")
    if records["gL"][1].solver_name != "GKOCG_Ell":
        raise RuntimeError(f"gL routed to {records['gL'][1].solver_name}, not GKOCG_Ell")

    # ---- checks of the path ------------------------------------------------
    for field, (x, perf, route, mat, bb, invd, params, gate) in records.items():
        n = mat.shape[0]
        if not (perf.converged and perf.final_residual < TOL):
            raise RuntimeError(f"{field}: did not converge: {perf}")
        if x.shape != (n,) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{field}: solution not finite of shape ({n},)")
        mat64 = formats.cast_values(mat, torch.float64)
        tr = true_residual_mv(lambda v, mat64=mat64: spmv.spmv(mat64, v), x, bb)
        plain = general_route_solve(route, mat, bb, params, invd, plain=True)
        line = (f"{field}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} (limit "
                f"{TRUE_RESIDUAL_MARGIN:g} x {TOL:g}); the route over the plain twins on the "
                f"card: {plain.iters} iterations")
        want = GATHER_ITERS.get(gate)
        if want is not None:
            line += f" (gated at {want} ± 1)"
        print(line)
        if abs(plain.iters - perf.n_iterations) > 1:
            raise RuntimeError(f"{field}: {perf.n_iterations} iterations vs {plain.iters} over "
                               "the plain twins")
        if want is not None and abs(perf.n_iterations - want) > 1:
            raise RuntimeError(f"{field}: {perf.n_iterations} iterations, not {want} ± 1")
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{field}: true residual {tr:.3e} above the limit")

    # ---- the loops on the gather formats against their twins ---------------
    report: dict = {}
    print("the loop kernels' Ell, Csr and Sell variants vs their twins (x after the check's "
          f"iterations within {VEC_RTOL:.0e}*max(1,max|plain|), BiCGStab after "
          f"{BICGSTAB_LOOP_CHECK} pinned within {GEN_LOOP_RTOL:.0e}):")
    for fmt in ("Ell", "Hybrid", "Csr", "Sell"):
        mat = records[f"g{fmt}"][3]
        invd = records[f"g{fmt}BJ"][5]
        check_gather_loops(mat, invd, "knn", report, GATHER_LOOP_ITERS)
    coo = ldu.ldu_to_coo_host(testing.poisson_ldu(LOOP_FIXED_GRID), dtype=np.float32)
    check_gather_loops(formats.coo_to_ell(coo, device=device), None,
                       "x".join(map(str, LOOP_FIXED_GRID)), report, GATHER_LOOP_ITERS)

    # ---- the kernels against their twins (launches not counted) ------------
    print("gather kernels vs their twins (vector tol "
          f"{VEC_RTOL:.0e}*max(1,max|plain|), and bit-equal):")
    g = torch.Generator(device=device).manual_seed(0)

    def kernels_on(label, coo, rows, cols, vals):
        """The four formats of the host Coo `coo` (its device triplets rows,
        cols, vals give torch's CSR), each kernel against its twin."""
        t0 = time.perf_counter()
        mats = {fmt: conv(coo, device=device) for fmt, conv in GATHER_CONVERTERS.items()}
        csr = csr_of_coo(rows, cols, vals, coo.shape[0])
        torch.cuda.synchronize()
        print(f"  [{label}: {coo.shape[0]} rows, nnz {len(coo.vals)}; the four formats built "
              f"by core/formats.py in {time.perf_counter() - t0:.2f} s; Ell K "
              f"{mats['Ell'].row_width}, Sell widths {mats['Sell'].widths} stored "
              f"{mats['Sell'].stored}, Hybrid width {mats['Hybrid'].ell.row_width} tail "
              f"{mats['Hybrid'].tail.nnz}; the CSR kernel's lanes per row "
              f"{gather_spmv.csr_group(coo.shape[0], len(coo.vals))}]")
        x = torch.randn(coo.shape[0], device=device, generator=g)
        check_gather_kernels(mats, label, x, csr, report)
        return mats, csr, x

    coo = registry.global_registry.get("gCsr_solver").coo_host()
    mats, csr, x = kernels_on("knn", coo, *(torch.tensor(a, device=device) for a in (
        coo.rows.astype(np.int64), coo.cols.astype(np.int64), coo.vals)))
    for fmt, m in mats.items():
        device_beside(GATHER_FORMATS[fmt], "knn", lambda mv=spmv.matvec(m): mv(x),
                      lambda: csr @ x, report)
    del mats, csr, x
    torch.cuda.empty_cache()
    data, offsets = poisson_dia(grid_big, device)
    rows, cols, vals = dia_coo(data, offsets)
    n_big = data.shape[1]
    del data
    order = torch.argsort(rows * n_big + cols)
    rows, cols, vals = rows[order], cols[order], vals[order]
    del order
    big = formats.Coo(rows=rows.cpu().numpy().astype(np.int32),
                      cols=cols.cpu().numpy().astype(np.int32), vals=vals.cpu().numpy(),
                      shape=(n_big, n_big))
    kernels_on("x".join(map(str, grid_big)), big, rows, cols, vals)
    del rows, cols, vals, big
    torch.cuda.empty_cache()
    csr_lanes_on_random_graphs(device, report)
    return launches, report


# ---- phase 12: slice 17, blocked Jacobi, ISAI/GISAI and GKOGMRES ------------

# the kernels phase 12's path must launch: since slice 19 the
# general-BiCGStab loop kernel's block-Jacobi variants (Dia, Gdia and Xell
# count as bicgstab_gen_loop, the gather formats under their plans' names)
# take the GKOBiCGStab + blocked BJ solves, and the block-Jacobi kernel runs
# in GKOCG + blocked BJ's host loop
SLICE17_KERNELS = ("block_jacobi", "gmres_arnoldi", "gmres_combine", "bicgstab_gen_loop",
                   "csr_bicgstab_gen_loop", "ell_bicgstab_gen_loop", "sell_bicgstab_gen_loop")
BJ_SIZES = (4, 8)  # the block sizes phase 12 checks the block-Jacobi kernel at
GMRES_J = 99  # the Arnoldi step checked and timed: the last of a 100-row cycle
# the blocked loops' rows: timed over 10 checked iterations (their plain
# twins take 1.6-1.9 ms per iteration at 1M); after BICGSTAB_LOOP_CHECK
# pinned iterations the normalised residual is held to PINNED_RTOL or to
# within 1e-6 of the initial one, as tests/test_torch_cuda.py holds the
# pinned loops: on convection-diffusion it has fallen to about 1e-4 of the
# initial one there, so its float32 rounding at the initial residual's
# scale (about 1e-7) is a relative 1e-3 of what is left
BJ_LOOP_ITERS = 10
BJ_LOOP_RES_ATOL = 1e-6
# the fields that take such a row: config 2's (the other formats' blocked
# loops are held by their solves' gates, and timed on their own solves)
BJ_LOOP_ROWS = ("uBJ4", "uCDBJ4", "uCDBJ8", "uCDBJ4Csr")
COMBINE_J = 100  # the recombination of a full 100-row cycle
# the kNN-6 mesh of the Hybrid GKOGMRES solve and its steady step: the
# GISAI set-up at 1M (13 s, most of it the Xell packing of M) would take
# the script past its time once more
HYBRID_CELLS = 1 << 18
# field -> (system, controls, gate).  BASELINE config 2, GKOBiCGStab + BJ
# maxBlockSize 4 (and 8) on Dia and Csr, and since slice 19 on Gdia (4), and
# on the 262,144-cell kNN-6 mesh on Xell (8), Ell (32) and Sell (3: n =
# 262,144 is no multiple of 3): one launch of the general-BiCGStab loop
# kernel's block-Jacobi variant per solve, held ±1 to the host loop over the
# plain twins on convection-diffusion ("free"); on the Poisson grid and the
# kNN-6 mesh float32 BiCGStab parts from another summation order, so there
# the routes are held to each other pinned at PINNED_ITERS[0] ("pinned").
# GKOCG + BJ 4 on the Poisson grid keeps the host loop over the block-Jacobi
# kernel (the CG loop's phases are scalar).  Config 3, GKOGMRES + GISAI on
# the kNN-6 mesh as Ell and Hybrid, + ISAI on the Poisson grid (and with a
# bfloat16 basis, "true": held to its true residual; the twin route printed
# beside it).  adaptMinIter is on (the default): `wKH` takes a steady step at
# its adapted minIter and frequency.
BJ4 = {"preconditioner": "BJ", "maxBlockSize": 4}
SLICE17_SOLVES = {
    "uBJ4": ("poisson", {"solver": "GKOBiCGStab", "preconditioner": BJ4}, "pinned"),
    "uCDBJ4": ("cd", {"solver": "GKOBiCGStab", "preconditioner": BJ4}, "free"),
    "uCDBJ8": ("cd", {"solver": "GKOBiCGStab",
                      "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 8}}, "free"),
    "uCDBJ4Csr": ("cd", {"solver": "GKOBiCGStab", "preconditioner": BJ4,
                         "matrixFormat": "Csr"}, "free"),
    "uCDBJ4Gdia": ("cd", {"solver": "GKOBiCGStab", "preconditioner": BJ4,
                          "matrixFormat": "Gdia"}, "free"),
    **{f"uKHBJ{bs}{fmt}": ("knn hybrid", {"solver": "GKOBiCGStab", "matrixFormat": fmt,
                                          "preconditioner": {"preconditioner": "BJ",
                                                             "maxBlockSize": bs}}, "pinned")
       for bs, fmt in ((8, "Xell"), (32, "Ell"), (3, "Sell"))},
    "pBJ4": ("poisson", {"solver": "GKOCG", "preconditioner": BJ4}, "free"),
    "wK": ("knn", {"solver": "GKOGMRES", "preconditioner": "GISAI", "matrixFormat": "Ell"},
           "free"),
    "wKH": ("knn hybrid", {"solver": "GKOGMRES", "preconditioner": "GISAI",
                           "matrixFormat": "Hybrid"}, "free"),
    "wP": ("poisson", {"solver": "GKOGMRES", "preconditioner": "ISAI"}, "free"),
    "wPbf": ("poisson", {"solver": "GKOGMRES", "preconditioner": "ISAI",
                         "basisPrecision": "bfloat16"}, "true"),
}


def plain_precond(slv):
    """The plain twin of a solver's preconditioner apply: the block-Jacobi
    twin over its inverses, the ILU family's triangular twins over its
    factors, or the plain SpMV of M (and Mᵀ)."""
    op = slv._precond_op
    if slv.cfg.precond.name == "BJ":
        return lambda r: block_jacobi_plain(op.state, r)
    if isinstance(op.state, ilu.IluState):
        return ilu_plain(op.state)
    mats = op.state
    if len(mats) == 1:
        return lambda r: spmv.spmv(mats[0], r)
    return lambda r: 0.5 * (spmv.spmv(mats[0], r) + spmv.spmv(mats[1], r))


def slice17_route(slv, b, params, plain, host=False):
    """A solver's route from a zero guess: GKOBiCGStab's loop kernel (with a
    blocked BJ's inverses), or (host=True) its host loop over the kernels;
    GKOCG's host loop; GKOGMRES; or (plain=True) the host loop over the
    plain twins on the card."""
    mat = slv.matrix
    mv = (lambda v: spmv.spmv(mat, v)) if plain else spmv.matvec(mat)
    pc = plain_precond(slv) if plain else slv._precond_op
    ops = krylov.single_device_ops(mv, mat.shape[0], precond=pc)
    x0 = torch.zeros_like(b)
    if slv.route == "bicgstab":
        if plain or host or slv.kern is None:
            return bicgstab(ops, b, x0, params)
        return bicgstab(ops, b, x0, params, slv.kern, slv.kern.pack_values(mat), None,
                        slv._precond_op.state)
    if slv.route == "cg":
        return cg(ops, b, x0, params)
    basis = torch.bfloat16 if slv.cfg.basis_precision == "bfloat16" else None
    twins = {"arnoldi": gmres_arnoldi_plain, "combine": gmres_combine_plain} if plain else {}
    return gmres_solve(ops, b, x0, params, slv.cfg.krylov_dim, basis, **twins)


def snapshot17(slv):
    """What slice17_route and the checks need of a solver, its matrix values
    copied (a steady step replaces the matrix and the preconditioner)."""
    mat = formats.cast_values(formats.cast_values(slv.matrix, torch.float64), torch.float32)
    return types.SimpleNamespace(route=slv.route, matrix=mat, _precond_op=slv._precond_op,
                                 cfg=slv.cfg, kern=slv.kern)


# the SpMV kernel a format's solves launch for the set-up and the
# residual-eval timing
FORMAT_SPMV = {"Dia": "dia_spmv", "Gdia": "gdia_spmv", "Xell": "xell_spmv", **GATHER_FORMATS}


def gen_loop_of(kern):
    """The counter of the general-BiCGStab loop kernel's launches on a
    plan: bicgstab_gen_loop on Dia, Gdia and Xell, <NAME>_bicgstab_gen_loop
    on a gather format's plan."""
    return (f"{kern.NAME}_bicgstab_gen_loop" if isinstance(kern, GatherCgKernels)
            else "bicgstab_gen_loop")


def check_slice17_launches(field, slv, iters, before):
    """Between `before` and now: GKOBiCGStab + blocked BJ its format's
    general-BiCGStab loop kernel once, no block-Jacobi launch and no other
    loop kernel, the format's SpMV 2 + RES_EVAL_SPMVS times (the set-up and
    the residual-eval timing); otherwise no loop kernel, and GKOCG + blocked
    BJ one block-Jacobi launch per iteration, GKOGMRES one Arnoldi launch per
    Arnoldi step and the combine kernel at least once."""
    got = {k: kernels.launches[k] - before[k] for k in kernels.launches
           if kernels.launches[k] != before[k]}
    print(f"  {field}: launches in this solve {got}")
    loop = gen_loop_of(slv.kern) if slv.route == "bicgstab" else None
    loops = [k for k in got if k.endswith("loop") and k != loop]
    if loops:
        raise RuntimeError(f"{field}: a loop kernel ran on a host-loop route: {loops}")
    if slv.route == "bicgstab":
        want = {loop: 1, "block_jacobi": 0,
                FORMAT_SPMV[formats.format_name(slv.matrix)]: 2 + RES_EVAL_SPMVS}
    elif slv.route == "cg":
        want = {"block_jacobi": iters}
    else:
        want = {"gmres_arnoldi": iters}
        if not got.get("gmres_combine"):
            raise RuntimeError(f"{field}: the combine kernel never ran")
    bad = {k: got.get(k, 0) for k, v in want.items() if got.get(k, 0) != v}
    if bad:
        raise RuntimeError(f"{field}: launched {bad} in one solve, not {want}")


def arnoldi_inputs(j, n, dt, device, g):
    """A basis of orthonormal rows V[0..j+1] (the QR of seeded normals) in
    `dt`, and w = V[0..j]ᵀ c + e with c of norm about 3 and e of norm about
    1: h is of the order of ‖w‖, and leaving out the subtraction of any one
    block of rows moves v_{j+1} and ‖w‖ far past the tolerance."""
    q, _ = torch.linalg.qr(torch.randn((n, j + 2), device=device, generator=g))
    V = new_basis(j + 1, n, dt, device)
    V[:j + 2, :n] = q.t().to(dt)
    del q
    c = 0.3 * torch.randn(j + 1, device=device, generator=g)
    w = V[:j + 1, :n].float().t() @ c + torch.randn(n, device=device, generator=g) / n ** 0.5
    return V, w


def slice17_kernels(n, label, device, report):
    """The three kernels against their twins at n rows (launches not
    counted): bit-equal (block Jacobi, combine) or within the stated
    tolerance (Arnoldi), timed with their bound and torch's call."""
    g = torch.Generator(device=device).manual_seed(17)
    for bs in BJ_SIZES:
        nb = n // bs
        inv_t = torch.randn((nb, bs, bs), device=device, generator=g)
        r = torch.randn(n, device=device, generator=g)
        name, case = "block_jacobi", "block_jacobi" + ("" if bs == BJ_SIZES[0] else f"[bs {bs}]")
        compare(case, label, lambda: ([block_jacobi(inv_t, r)], []),
                lambda: ([block_jacobi_plain(inv_t, r)], []), (nb * bs * bs + 2 * n) * 4,
                2 * bs * n, report)
        if not torch.equal(block_jacobi(inv_t, r), block_jacobi_plain(inv_t, r)):
            raise RuntimeError(f"{case} at {label} is not bit-equal to its twin")
        inv = inv_t.transpose(1, 2).contiguous()
        library_call(case, label, "torch.bmm(inv, r.view(nb, bs, 1))",
                     lambda: torch.bmm(inv, r.view(nb, bs, 1)).view(-1),
                     lambda: block_jacobi(inv_t, r), f"bs {bs}", report)
        del inv_t, r, inv
    j = GMRES_J
    for dt, tag in ((torch.float32, ""), (torch.bfloat16, "[bf16]")):
        eb = 2 if dt == torch.bfloat16 else 4
        V, w = arnoldi_inputs(j, n, dt, device, g)
        V2 = V.clone()
        scale = float(torch.linalg.vector_norm(w))
        hk, hp = (torch.zeros(j + 2, device=device) for _ in range(2))
        wk, wp = w.clone(), w.clone()

        def kfn():
            v = gmres_arnoldi(V, w.clone(), j, hk)
            return [v, hk / scale], []

        def pfn():
            v = gmres_arnoldi_plain(V2, w.clone(), j, hp)
            return [v, hp / scale], []

        nbytes = (j + 2) * n * eb + 4 * n + (4 * n if eb == 2 else 0) + 4 * (j + 2)
        compare("gmres_arnoldi" + tag, label, kfn, pfn, nbytes, 4 * (j + 1) * n + 3 * n,
                report, kt=lambda: gmres_arnoldi(V, wk, j, hk),
                pt=lambda: gmres_arnoldi_plain(V2, wp, j, hp), err=rel_err)
        kfn()
        pfn()
        # the stored row: the vector tolerance, and with a bfloat16 basis one
        # bfloat16 ulp besides (a float32 difference can round either way)
        rk, rp = V[j + 1, :n].float(), V2[j + 1, :n].float()
        err, tol = rel_err(rk, rp)
        over = (rk - rp).abs() - (2.0 ** -7 * rp.abs() if eb == 2 else 0.0) - tol
        print(f"    the stored row V[{j + 1}] against the twin's: max abs difference {err:.1e} "
              f"(tol {tol:.1e}{' + one bfloat16 ulp' if eb == 2 else ''})")
        if float(over.max()) > 0:
            raise RuntimeError(f"gmres_arnoldi{tag} at {label}: the stored row disagrees")
        report["gmres_arnoldi" + tag][label]["library_ms"] = None  # no single call
        y = torch.randn(COMBINE_J, device=device, generator=g)
        case = "gmres_combine" + tag
        compare(case, label, lambda: ([gmres_combine(V, y, COMBINE_J, n)], []),
                lambda: ([gmres_combine_plain(V, y, COMBINE_J, n)], []),
                COMBINE_J * n * eb + 4 * n + 4 * COMBINE_J, 2 * COMBINE_J * n, report)
        if not torch.equal(gmres_combine(V, y, COMBINE_J, n),
                           gmres_combine_plain(V, y, COMBINE_J, n)):
            raise RuntimeError(f"{case} at {label} is not bit-equal to its twin")
        if eb == 4:
            Vt = V[:COMBINE_J, :n].t()
            library_call(case, label, "torch.mv(V[:j].T, y)", lambda: torch.mv(Vt, y),
                         lambda: gmres_combine(V, y, COMBINE_J, n), f"j {COMBINE_J}", report)
        else:
            report[case][label]["library_ms"] = None  # torch.mv takes no bfloat16 x float32
        del V, V2, w, wk, wp
        torch.cuda.empty_cache()


def slice17_path(device, m_knn, b_knn, m_grid, b_grid, grid, grid_big, ctl) -> tuple:
    """Phase 12.  Returns the launch counts of the path, its kernel report
    and the 262,144-cell kNN-6 system (its matrix and b), which phase 13
    solves again."""
    print(f"== phase 12: slice 17, blocked Jacobi, ISAI/GISAI and GKOGMRES (BASELINE configs "
          f"2 and 3), foam.solve at {m_grid.n} (Poisson, convection-diffusion) and {m_knn.n} "
          "(kNN-6) cells")
    if not native.available():
        raise RuntimeError("the native host runtime (ogl_tpu_torch/native) did not build")
    info = _build.build_info()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kern, what in (("block_jacobi_kernel", "block_jacobi"),
                       *((f"bicgstab_gen_loop_kernelILi{v}E", f"bicgstab_gen_loop {name}")
                         for v, name in GEN_LOOP_VARIANTS.items() if v & LOOP_BLOCK_JACOBI),
                       ("gmres_arnoldi_kernelILb0E", "gmres_arnoldi float32"),
                       ("gmres_arnoldi_kernelILb1E", "gmres_arnoldi bfloat16"),
                       ("gmres_combine_kernelILb0E", "gmres_combine float32"),
                       ("gmres_combine_kernelILb1E", "gmres_combine bfloat16")):
        print(f"{what}: ptxas: " + "; ".join(loop_ptxas(info["log"], None, kern)))
        if "arnoldi" in what:
            for dims in ((HYBRID_CELLS,), grid, grid_big):
                nn = int(np.prod(dims))
                p = gmres_kernels.launch_plan(nn, "bfloat16" in what, device)
                print(f"  plan at {nn} rows: {p.ctas} CTAs of {gmres_kernels.ARNOLDI_THREADS} "
                      f"threads on {sms} SMs, slices of {p.slice} rows ({p.chunks} steps of "
                      f"{p.chunk}), {p.resident} of 8 rows held per block, w held "
                      f"{p.w_resident}, {p.stages} stages, L2 hint {p.hint}, {p.smem} bytes "
                      "of shared memory")
    ctl = {**ctl, "verbose": 0}
    t0 = time.perf_counter()
    systems = {"poisson": (m_grid, b_grid), "knn": (m_knn, b_knn),
               "cd": (testing.convection_diffusion_ldu(grid), b_grid)}
    if HYBRID_CELLS == m_knn.n:
        systems["knn hybrid"] = systems["knn"]
    else:
        mh, perm = testing.knn_ldu(HYBRID_CELLS)
        systems["knn hybrid"] = (testing.renumber_ldu(mh, np.argsort(perm)),
                                 np.random.default_rng(0).normal(size=mh.n).astype(np.float32))
    hybrid_mesh = "" if HYBRID_CELLS == m_knn.n else f" and the {HYBRID_CELLS}-cell kNN-6 mesh"
    print(f"host set-up: convection-diffusion system{hybrid_mesh} "
          f"{time.perf_counter() - t0:.2f} s")
    records, report = {}, {}
    kernels.reset_launches()
    for field, (system, spec, gate) in SLICE17_SOLVES.items():
        mk, bk = systems[system]
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, mk, bk, {**ctl, **spec})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        slv = registry.global_registry.get(f"{field}_solver")
        check_slice17_launches(field, slv, perf.n_iterations, before)
        it = max(perf.n_iterations, 1)
        lt = slv.last_timings
        apply = ("the block-Jacobi kernel" if slv.cfg.precond.name == "BJ" else "M on " + "/".join(
            formats.format_name(mm) for mm in slv._precond_op.state))
        print(f"{field} ({formats.format_name(slv.matrix)}, route {slv.route}, {apply}): "
              f"first solve wall {wall:.3f} s; convert_format "
              f"{lt['convert_format'] * 1e3:.1f} ms, generate_preconditioner "
              f"{lt['generate_preconditioner'] * 1e3:.1f} ms, solve {lt['solve'] * 1e3:.3f} ms = "
              f"{lt['solve'] / it * 1e6:.1f} us per iteration; on resident state "
              f"{slv.time_device_solve() / it * 1e6:.2f} us per iteration")
        records[field] = (x, perf, snapshot17(slv), torch.tensor(bk, device=device),
                          stopping.StoppingParams.of(slv.cfg.stopping), gate)
    # a steady step of wKH (diag x1.01, new b) at its adapted minIter and frequency
    mk, bk = systems["knn hybrid"]
    m2 = dataclasses.replace(mk, diag=np.asarray(mk.diag) * 1.01)
    b2 = (bk * 1.01 + 0.1).astype(np.float32)
    step_ctl = {**ctl, **SLICE17_SOLVES["wKH"][1]}
    params = next_params("wKH", step_ctl)
    before = dict(kernels.launches)
    x2, perf2 = foam.solve("wKH", m2, b2, step_ctl)
    torch.cuda.synchronize()
    perf2.print()
    slv = registry.global_registry.get("wKH_solver")
    check_slice17_launches("wKH steady step", slv, perf2.n_iterations, before)
    lt = slv.last_timings
    print(f"wKH steady step: update {lt.get('update_device_values', 0.0) * 1e3:.3f} ms, "
          f"generate_preconditioner {lt.get('generate_preconditioner', 0.0) * 1e3:.1f} ms, solve "
          f"{lt.get('solve', 0.0) * 1e3:.3f} ms; adapted minIter {params.min_iter} frequency "
          f"{params.frequency}")
    records["wKH step"] = (x2, perf2, snapshot17(slv), torch.tensor(b2, device=device), params,
                           "free")
    launches = {k: kernels.launches[k] for k in SLICE17_KERNELS}
    print(f"launch counts over the path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"slice 17's path never launched {missing}")

    # ---- checks of the path (launches not counted) --------------------------
    for field, (x, perf, slv, bb, params, gate) in records.items():
        mat = slv.matrix
        n = mat.shape[0]
        if not perf.converged:
            raise RuntimeError(f"{field}: did not converge: {perf}")
        if x.shape != (n,) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{field}: solution not finite of shape ({n},)")
        mat64 = formats.cast_values(mat, torch.float64)
        tr = true_residual_mv(lambda v, mat64=mat64: spmv.spmv(mat64, v), x, bb)
        plain = slice17_route(slv, bb, params, plain=True)
        line = (f"{field}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} (limit "
                f"{TRUE_RESIDUAL_MARGIN:g} x {TOL:g}); the route over the plain twins on the "
                f"card: {plain.iters} iterations ({gate})")
        if gate == "pinned":
            pin = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0,
                                          min_iter=PINNED_ITERS[0], max_iter=PINNED_ITERS[0],
                                          frequency=1)
            rk, rp = (float(slice17_route(slv, bb, pin, twins).final_res_norm)
                      for twins in (False, True))
            rel = abs(rk - rp) / rp
            line += f"; pinned {PINNED_ITERS[0]}: residual {rk:.4e} vs {rp:.4e} (rel {rel:.1e})"
            if rel > PINNED_RTOL:
                raise RuntimeError(f"{field}: pinned, the kernels' residual {rk:.4e} differs "
                                   f"from the plain twins' {rp:.4e}")
        print(line)
        if gate == "free" and abs(plain.iters - perf.n_iterations) > 1:
            raise RuntimeError(f"{field}: {perf.n_iterations} iterations vs {plain.iters} over "
                               "the plain twins")
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{field}: true residual {tr:.3e} above the limit")
        if slv.route == "bicgstab":
            data, inv_t = slv.kern.pack_values(slv.matrix), slv._precond_op.state
            if field in BJ_LOOP_ROWS:  # the loop kernel against the twins at fixed work
                check_gen_loop(slv.kern, data, field, report, iters=BJ_LOOP_ITERS, inv_t=inv_t,
                               res_atol=BJ_LOOP_RES_ATOL)
            # and on its own solve, beside one run of the host loop over the
            # kernels (its time on the host's clock and its count)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = slice17_route(slv, bb, params, False, host=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            nbytes = gen_loop_bytes(data, n, False, slv.kern, inv_t.shape[1])
            print(f"  {field}: the host loop over the SpMV and block-Jacobi kernels on resident "
                  f"state {ms / max(host.iters, 1) * 1e3:.2f} us per iteration ({host.iters} "
                  f"iterations), the loop kernel above; its bound "
                  f"{nbytes / PEAK_BYTES_PER_S * 1e6:.2f} us per iteration "
                  f"({nbytes / n:.0f} B/row)")

    # ---- the kernels against their twins ------------------------------------
    print("slice 17's kernels vs their twins (vector tol "
          f"{VEC_RTOL:.0e}*max(1,max|plain|); block Jacobi and combine bit-equal; Arnoldi at "
          f"j = {GMRES_J} on orthonormal rows and w = V^T c + e: v and h/||w|| within "
          f"{VEC_RTOL:.0e}*max|plain|, no floor):")
    for dims in (grid, grid_big):
        slice17_kernels(int(np.prod(dims)), "x".join(map(str, dims)), device, report)
    return launches, report, systems["knn hybrid"]


# ---- phase 13: slice 20, the ILU family ---------------------------------------

# the kernels phase 13's path must launch: the sweeps on every approximate
# ILU-family apply, the levels on every `triSolve exact` one
SLICE20_KERNELS = ("tri_sweep", "tri_levels")
# field -> (system, controls, gate): GKOCG + IC (and exact) on the Poisson
# grid, GKOBiCGStab + ILU and IRILU and GKOGMRES + ILU exact on
# convection-diffusion ("free": ±1 against the route over the plain twins,
# as uCD* and wK* are held), GKOBiCGStab + ILUT and GKOCG + ICT on phase 12's
# 262,144-cell kNN-6 mesh as Csr (cut from 1M for the ILUT/ICT host
# factorisation; float32 BiCGStab there is held pinned, as phase 12's uKHBJ*)
ILU_EXACT = {"preconditioner": "ILU", "triSolve": "exact"}
SLICE20_SOLVES = {
    "pIC": ("poisson", {"solver": "GKOCG", "preconditioner": "IC"}, "free"),
    "pICx": ("poisson", {"solver": "GKOCG",
                         "preconditioner": {"preconditioner": "IC", "triSolve": "exact"}}, "free"),
    "uILU": ("cd", {"solver": "GKOBiCGStab", "preconditioner": "ILU"}, "free"),
    "uIRILU": ("cd", {"solver": "GKOBiCGStab", "preconditioner": "IRILU"}, "free"),
    "wILUx": ("cd", {"solver": "GKOGMRES", "preconditioner": ILU_EXACT}, "free"),
    "uKILUT": ("knn", {"solver": "GKOBiCGStab", "preconditioner": "ILUT", "matrixFormat": "Csr"},
               "pinned"),
    "pKICT": ("knn", {"solver": "GKOCG", "preconditioner": "ICT", "matrixFormat": "Csr"}, "free"),
}
# the rows of each factor of the chain probe: every row depends on the one
# before (lower) or after (upper), so kernel 2 walks 2 x (CHAIN_ROWS - 1)
# dependent hops one after another
CHAIN_ROWS = 4096
# kernel 2's twin walks ~640 (1M) or ~1,270 (8.4M) levels of torch ops per
# call (0.2-0.6 s): its row is timed after one warm-up call over 1 call a
# turn (2 until phase 15 joined), and torch.triangular_solve beside kernel 2
# over 2 (3 until then)
LEVEL_TWIN_REPS = 1
LEVEL_LIBRARY_REPS = 2


def ilu_plain(state):
    """The plain twin of an ILU-family apply over its state; the level twin
    on the card replayed from a CUDA graph (`graphed`)."""
    fn = tri_solve.tri_levels_plain if state.exact else tri_solve.tri_sweep_plain
    apply = lambda r: fn(state.lower, state.upper, r)  # noqa: E731
    vals = state.lower.mat.vals
    return graphed(apply, state.lower.n, vals.device) if state.exact and vals.is_cuda else apply


def graphed(fn, n, device):
    """`fn` of an (n,) float32 vector, captured once in a CUDA graph and
    replayed per call on a static copy of its input: the same kernels on the
    same data, so the same bits, without the host's launch of each of the
    thousands of torch ops that the level twin issues per call."""
    x = torch.zeros(n, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(x)  # builds the twin's tables (host reads) outside the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fn(x)

    def run(r):
        x.copy_(r)
        graph.replay()
        return y.clone()
    return run


def grid_coo(dims, device):
    """The Poisson grid's COO (poisson_dia's entries), row-major sorted on
    the device and brought to the host, as the factorisations take it."""
    data, offsets = poisson_dia(dims, device)
    n = data.shape[1]
    r, c, v = dia_coo(data, offsets)
    order = torch.argsort(r * n + c)
    return formats.Coo(rows=r[order].int().cpu().numpy(), cols=c[order].int().cpu().numpy(),
                       vals=v[order].cpu().numpy(), shape=(n, n))


def tri_bytes(st, ic: bool, blocks, capacity):
    """(least bytes of one apply, a model of the bytes kernel 1 moves from
    device memory over the approximate apply's passes on a grid of `blocks`
    CTAs with `capacity` bytes of shared memory each (`sweep_bytes_model`),
    operations of one approximate apply): the least bytes read each factor
    (row offsets, columns, values), r and each d once and write the result
    once.  IC's two triangles are L and Lᵀ with one d, so its least bytes
    count L and d once; the port's own copy of Lᵀ shows only in the model."""
    n = st.lower.n

    def factor(t):
        return 4 * (n + 1) + 8 * t.mat.nnz

    if ic:
        least = factor(st.lower) + 4 * n + 8 * n
    else:
        dvec = sum(4 * n for t in (st.lower, st.upper) if t.d is not None)
        least = factor(st.lower) + factor(st.upper) + 8 * n + dvec
    moved = sum(sweep_bytes_model(t, blocks, capacity) for t in (st.lower, st.upper))
    ops = sum(max(t.sweeps, 1) * (2 * t.mat.nnz + 2 * n) for t in (st.lower, st.upper))
    return least, moved, ops


def chain_hop_ms(device):
    """The cost of one dependent hop of kernel 2: a chain of CHAIN_ROWS rows
    per factor (each row's one source the row before it, or after it in the
    upper factor), through tri_levels, timed with CUDA events; ms per hop.
    Held to its twin's bits first."""
    g = np.random.default_rng(21)
    i = np.arange(1, CHAIN_ROWS)
    st = ilu.state_from_factors((i, i - 1, g.uniform(-0.9, 0.9, CHAIN_ROWS - 1)),
                                (i - 1, i, g.uniform(-0.9, 0.9, CHAIN_ROWS - 1)),
                                g.uniform(1.0, 2.0, CHAIN_ROWS), "lu", device, exact=True)
    r = torch.ones(CHAIN_ROWS, device=device)
    if not torch.equal(tri_solve.tri_levels(st.lower, st.upper, r),
                       tri_solve.tri_levels_plain(st.lower, st.upper, r)):
        raise RuntimeError("tri_levels on the chain probe is not bit-equal to its twin")
    ms = time_turns({"k": lambda: tri_solve.tri_levels(st.lower, st.upper, r)}, 10)["k"]
    return ms / (st.lower.depth + st.upper.depth)


def sweep_bytes_model(t, blocks, capacity):
    """A model of the bytes kernel 1 moves from device memory over one
    triangle's passes, as its plan lays the rows out (printed, not measured
    and not reported): the held rows' offsets and entries once, the rest of
    the factor every pass (none without a sweep), and per pass b and d, the
    sources read and the result written.  The kernel keeps b and d of a
    thread's first rows in registers, and at 1M rows a pass may find what
    it streams in L2, so it moves less."""
    n = t.n
    rp = t.mat.row_ptr.cpu().numpy().astype(np.int64)
    plan = tri_solve.sweep_plan(t, blocks, capacity, tri_solve.SWEEP_HOLD_SHARE)
    passes = max(t.sweeps, 1)
    factor = 4 * (n + 1) + 8 * t.mat.nnz
    held_bytes = 0
    if plan is not None:
        bounds, held = (a.cpu().numpy().astype(np.int64) for a in plan)
        r0 = bounds[:-1]
        held_bytes = int((4 * (held - r0 + (held > r0)) + 8 * (rp[held] - rp[r0])).sum())
    factor_bytes = held_bytes + (factor - held_bytes) * passes if t.sweeps > 0 else 0
    bd = 4 + (4 if t.d is not None else 0)
    return factor_bytes + (bd + 8) * n * passes


def library_trisolve(lo_full, up_full, unit_lower):
    """torch.triangular_solve with a sparse-CSR A on the card, once per
    triangle (the library's exact apply), or None where this torch refuses
    it."""
    def solve(r):
        y = torch.triangular_solve(r.view(-1, 1), lo_full, upper=False,
                                   unitriangular=unit_lower).solution
        return torch.triangular_solve(y, up_full, upper=True).solution.view(-1)
    return solve


def factor_csr(rows, cols, vals, diag, n, device):
    """torch's CSR tensor of a strict factor's host triples with `diag` on
    its diagonal (None: no diagonal stored), for library_ms."""
    if diag is not None:
        i = np.arange(n)
        rows, cols, vals = np.r_[rows, i], np.r_[cols, i], np.r_[vals, diag]
    return csr_of_coo(*(torch.tensor(np.asarray(a, t), device=device) for a, t in (
        (rows, np.int64), (cols, np.int64), (vals, np.float32))), n)


def slice20_kernels(dims, device, report, hop_ms):
    """Kernels 1 and 2 against their twins on the IC and ILU factors of the
    Poisson grid at `dims` (launches not counted): bit-equal, and within
    VEC_RTOL by compare's rule; kernel 2 bit-equal to kernel 1 run to each
    factor's depth; timed with the bound, the dependency depth times
    `hop_ms` (the chain probe's ms per dependent hop), and
    torch.triangular_solve beside kernel 2."""
    label = "x".join(map(str, dims))
    t0 = time.perf_counter()
    coo = grid_coo(dims, device)
    n = coo.shape[0]

    def ic():
        f = ilu.ic0_factor(coo)
        return f, ilu.state_from_factors(f[0], None, f[1], "ic", device)

    def lu():
        f = ilu.ilu0_factors(coo)
        return f, ilu.state_from_factors(*f, "lu", device)

    # the two host set-ups side by side (numpy and the native calls release
    # the interpreter's lock for most of their time)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {"IC": pool.submit(ic), "ILU": pool.submit(lu)}
        fac, states = {}, {}
        for kind, job in jobs.items():
            fac[kind], states[kind] = job.result()
    print(f"  {label}: the grid's COO, IC(0) and ILU(0) factors and their level schedules on "
          f"the host in {time.perf_counter() - t0:.2f} s (two threads)")
    g = torch.Generator(device=device).manual_seed(20)
    r = torch.randn(n, device=device, generator=g)
    blocks = tri_solve.sweep_blocks(n, device)
    capacity = tri_solve.sweep_grid(device.index or 0)[1]
    for kind, st in states.items():
        tag = "" if kind == "IC" else "[ILU]"
        lo, up = st.lower, st.upper
        least, moved, ops = tri_bytes(st, kind == "IC", blocks, capacity)
        got = tri_solve.tri_sweep(lo, up, r)
        want = tri_solve.tri_sweep_plain(lo, up, r)
        compare("tri_sweep" + tag, label, lambda: ([got], []), lambda: ([want], []), least, ops,
                report, kt=lambda: tri_solve.tri_sweep(lo, up, r),
                pt=lambda: tri_solve.tri_sweep_plain(lo, up, r))
        if not torch.equal(got, want):
            raise RuntimeError(f"tri_sweep{tag} at {label} is not bit-equal to its twin")
        row = report["tri_sweep" + tag][label]
        row["library_ms"] = None  # no single call computes k Jacobi sweeps
        held = [tri_solve.sweep_plan(t, blocks, capacity, tri_solve.SWEEP_HOLD_SHARE)
                for t in (lo, up)]
        share = [0.0 if p is None else float((p[1] - p[0][:-1]).sum()) / n for p in held]
        mode = (f"{blocks} CTAs with {capacity} bytes of shared memory hold "
                f"{share[0]:.3f} / {share[1]:.3f} of the rows"
                if any(p is not None for p in held) else f"{blocks} CTAs stream every row")
        print(f"    tri_sweep{tag}: {lo.sweeps} + {up.sweeps} sweeps, factors of {lo.mat.nnz} "
              f"and {up.mat.nnz} entries; {mode}; least bytes "
              f"{least / n:.1f} B/row (bound {least / PEAK_BYTES_PER_S * 1e3:.4f} ms); moved "
              f"from device memory over the passes, a model (b and d counted every pass) "
              f"{moved / n:.1f} B/row ({moved / PEAK_BYTES_PER_S * 1e3:.4f} ms)")
        got = tri_solve.tri_levels(lo, up, r)
        want = tri_solve.tri_levels_plain(lo, up, r)
        exact_ops = 2 * (lo.mat.nnz + up.mat.nnz) + 4 * n
        compare("tri_levels" + tag, label, lambda: ([got], []), lambda: ([want], []), least,
                exact_ops, report, kt=lambda: tri_solve.tri_levels(lo, up, r),
                pt=lambda: tri_solve.tri_levels_plain(lo, up, r), reps=LEVEL_TWIN_REPS,
                warmup=1)
        if not torch.equal(got, want):
            raise RuntimeError(f"tri_levels{tag} at {label} is not bit-equal to its twin")
        del want
        deep = tuple(dataclasses.replace(t, sweeps=t.depth, _tables={}) for t in (lo, up))
        if not torch.equal(got, tri_solve.tri_sweep(*deep, r)):
            raise RuntimeError(f"tri_levels{tag} at {label} is not bit-equal to tri_sweep run "
                               f"to the depths {lo.depth}, {up.depth}")
        row = report["tri_levels" + tag][label]
        row.update(levels=(lo.levels, up.levels), hop_ms=hop_ms,
                   depth_bound_ms=(lo.depth + up.depth) * hop_ms)
        print(f"    tri_levels{tag}: bit-equal to its twin and to tri_sweep run to the depths "
              f"{lo.depth} and {up.depth}; "
              f"{tri_solve.level_blocks(tri_solve.level_launch(lo, up), device)} blocks, "
              f"(block, threads, blocks per SM, nap ns) "
              f"{tri_solve.level_launch(lo, up)}; depth {lo.depth} + {up.depth} x "
              f"{hop_ms * 1e3:.3f} "
              f"us per dependent hop = depth bound {row['depth_bound_ms']:.4f} ms")
        # the library: one sparse triangular solve per triangle
        (lr, lc, lv) = fac[kind][0]
        if kind == "IC":
            lo_full = factor_csr(lr, lc, lv, fac[kind][1], n, device)
            up_full = factor_csr(lc, lr, lv, fac[kind][1], n, device)
        else:
            (ur, uc, uv), ud = fac[kind][1], fac[kind][2]
            lo_full = factor_csr(lr, lc, lv, None, n, device)
            up_full = factor_csr(ur, uc, uv, ud, n, device)
        lib = library_trisolve(lo_full, up_full, unit_lower=kind == "ILU")
        try:
            want = lib(r)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as exc:
            row["library_ms"] = None
            print(f"    torch.triangular_solve with a sparse CSR A: no single call on this torch "
                  f"({type(exc).__name__}: {str(exc).splitlines()[0][:120]})")
            continue
        t = time_turns({"library": lambda: lib(r), "kernel": lambda: tri_solve.tri_levels(
            lo, up, r)}, LEVEL_LIBRARY_REPS)
        err, tol = rel_err(got, want)
        row.update(library_ms=t["library"], kernel_ms_beside_library=t["kernel"])
        print(f"    torch.triangular_solve (sparse CSR, L then U) {t['library']:.4f} ms beside "
              f"tri_levels{tag} {t['kernel']:.4f} ms; max abs difference {err:.1e} (the "
              f"library solves with the float64 factors rounded to float32, kernel 2 with "
              f"1/diag rounded; printed, not gated)")
        del lo_full, up_full
    del states
    torch.cuda.empty_cache()


def check_slice20_launches(field, slv, before, applies):
    """Between `before` and now: the ILU family's kernel of the apply
    (tri_levels exact, else tri_sweep) once per preconditioner apply the
    host loop made (`applies`, counted by the apply itself), the other
    never, and no loop kernel; GKOGMRES also its Arnoldi kernel once per
    step."""
    got = {k: kernels.launches[k] - before[k] for k in kernels.launches
           if kernels.launches[k] != before[k]}
    print(f"  {field}: launches in this solve {got}; preconditioner applies {applies}")
    loops = [k for k in got if k.endswith("loop")]
    if loops:
        raise RuntimeError(f"{field}: a loop kernel ran on a host-loop route: {loops}")
    exact = slv._precond_op.state.exact
    want = {"tri_levels" if exact else "tri_sweep": applies,
            "tri_sweep" if exact else "tri_levels": 0}
    bad = {k: got.get(k, 0) for k, v in want.items() if got.get(k, 0) != v}
    if bad or applies < 1:
        raise RuntimeError(f"{field}: launched {bad} in one solve, not {want}")


def slice20_path(device, m_knn, b_knn, m_grid, b_grid, grid, grid_big, ctl) -> tuple:
    """Phase 13.  Returns the launch counts of the path and its kernel
    report."""
    print(f"== phase 13: slice 20, the ILU family (ILU, ILUT, IRILU, IC, ICT, triSolve exact), "
          f"foam.solve at {m_grid.n} (Poisson, convection-diffusion) and {m_knn.n} (kNN-6) "
          "cells")
    info = _build.build_info()
    blocks, capacity = tri_solve.sweep_grid(device.index or 0)
    print("tri_sweep: ptxas: " + "; ".join(loop_ptxas(info["log"], None, "tri_sweep_kernel"))
          + f"; dynamic shared memory {capacity} bytes per CTA, {blocks} co-resident CTAs of "
          f"{tri_solve.SWEEP_THREADS}; a factor held where {tri_solve.SWEEP_HOLD_SHARE} of its "
          f"bytes fit, else streamed")
    for block in tri_solve.LEVEL_BLOCKS:
        print(f"tri_levels (blocks of {block} entries): ptxas: " + "; ".join(loop_ptxas(
            info["log"], None, f"tri_levels_kernelILi{block}E")) + "; no dynamic shared "
            "memory; co-resident blocks: " + ", ".join(
                f"{tri_solve.level_grid(device.index or 0, t, block)} of {t}"
                for t in sorted({tri_solve.LEVEL_WIDE[0], tri_solve.LEVEL_NARROW[0]})))
    ctl = {**ctl, "verbose": 0}
    t0 = time.perf_counter()
    systems = {"poisson": (m_grid, b_grid), "knn": (m_knn, b_knn),
               "cd": (testing.convection_diffusion_ldu(grid), b_grid)}
    print(f"host set-up: convection-diffusion system {time.perf_counter() - t0:.2f} s")
    records, report = {}, {}
    kernels.reset_launches()
    for field, (system, spec, gate) in SLICE20_SOLVES.items():
        mk, bk = systems[system]
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, mk, bk, {**ctl, **spec})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        slv = registry.global_registry.get(f"{field}_solver")
        st = slv._precond_op.state
        check_slice20_launches(field, slv, before, st.applies)
        it = max(perf.n_iterations, 1)
        lt = slv.last_timings
        print(f"{field} ({formats.format_name(slv.matrix)}, route {slv.route}, "
              f"{'tri_levels' if st.exact else 'tri_sweep'} over Csr factors of "
              f"{st.lower.mat.nnz} + {st.upper.mat.nnz} entries, factor_depth "
              f"{st.lower.depth} / {st.upper.depth}, sweeps {st.lower.sweeps}): first solve wall "
              f"{wall:.3f} s; generate_preconditioner {lt['generate_preconditioner'] * 1e3:.1f} "
              f"ms, solve {lt['solve'] * 1e3:.3f} ms = {lt['solve'] / it * 1e6:.1f} us per "
              f"iteration; on resident state {slv.time_device_solve() / it * 1e6:.2f} us per "
              "iteration")
        records[field] = (x, perf, snapshot17(slv), torch.tensor(bk, device=device),
                          stopping.StoppingParams.of(slv.cfg.stopping), gate)
    launches = {k: kernels.launches[k] for k in SLICE20_KERNELS}
    print(f"launch counts over the path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"slice 20's path never launched {missing}")

    # ---- checks of the path (launches not counted) --------------------------
    for field, (x, perf, slv, bb, params, gate) in records.items():
        mat = slv.matrix
        n = mat.shape[0]
        if not perf.converged:
            raise RuntimeError(f"{field}: did not converge: {perf}")
        if x.shape != (n,) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{field}: solution not finite of shape ({n},)")
        mat64 = formats.cast_values(mat, torch.float64)
        tr = true_residual_mv(lambda v, mat64=mat64: spmv.spmv(mat64, v), x, bb)
        t0 = time.perf_counter()
        plain = slice17_route(slv, bb, params, plain=True)
        torch.cuda.synchronize()
        line = (f"{field}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} (limit "
                f"{TRUE_RESIDUAL_MARGIN:g} x {TOL:g}); the route over the plain twins on the "
                f"card: {plain.iters} iterations ({gate}; {time.perf_counter() - t0:.2f} s)")
        if gate == "pinned":
            pin = stopping.StoppingParams(tolerance=0.0, rel_tol=0.0,
                                          min_iter=PINNED_ITERS[0], max_iter=PINNED_ITERS[0],
                                          frequency=1)
            rk, rp = (float(slice17_route(slv, bb, pin, twins).final_res_norm)
                      for twins in (False, True))
            rel = abs(rk - rp) / rp
            line += f"; pinned {PINNED_ITERS[0]}: residual {rk:.4e} vs {rp:.4e} (rel {rel:.1e})"
            if rel > PINNED_RTOL:
                raise RuntimeError(f"{field}: pinned, the kernels' residual {rk:.4e} differs "
                                   f"from the plain twins' {rp:.4e}")
        print(line)
        if gate == "free" and abs(plain.iters - perf.n_iterations) > 1:
            raise RuntimeError(f"{field}: {perf.n_iterations} iterations vs {plain.iters} over "
                               "the plain twins")
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{field}: true residual {tr:.3e} above the limit")
    del records
    torch.cuda.empty_cache()

    # ---- the kernels against their twins ------------------------------------
    print("slice 20's kernels vs their twins on the Poisson grid's IC(0) and ILU(0) factors "
          f"(vector tol {VEC_RTOL:.0e}*max(1,max|plain|); both bit-equal required):")
    hop = chain_hop_ms(device)
    print(f"chain probe: {CHAIN_ROWS} + {CHAIN_ROWS} rows, each depending on the one before, "
          f"bit-equal to the twin; {hop * 1e3:.3f} us per dependent hop")
    for dims in (grid, grid_big):
        slice20_kernels(dims, device, report, hop)
    return launches, report


# ---- phase 14: slice 22, AMG on unstructured meshes -------------------------

# the kernels phase 14's path must launch: the Ell and Gdia level smoothers'
# sweep and residual, and the pgm transfers (on the host cycle of pKMGpgm,
# pKMGx and pSMGw), and the device V-cycle's Csr, Ell and Gdia outer
# variants (pKMG, gKMG, pSMG)
SLICE22_KERNELS = ("amg_ell_sweep", "amg_ell_resid", "amg_gdia_sweep", "amg_gdia_resid",
                   "pgm_restrict", "pgm_prolong", "amg_cg_loop_csr", "amg_ir_loop_ell",
                   "amg_cg_loop_gdia")
# the launch counter of each level format's sweep (its residual: _resid)
LEVEL_SMOOTHERS = {"Dia": "amg", "Gdia": "amg_gdia", "Ell": "amg_ell"}
MULTIGRID = {"preconditioner": "Multigrid", "maxLevels": 9, "minCoarseRows": 10}
# field -> (mesh, controls): BASELINE config 4, GKOCG + Multigrid on the
# kNN-6 mesh as Csr, with the default and the pgm aggregation; GKOMultigrid
# on it as Ell; GKOCG + Multigrid on the shuffled grid and on the kNN mesh
# through the format ladder (Gdia and Xell outer matrices); and, since the
# device V-cycle takes the Gdia hierarchy, GKOCG + Multigrid with cycle w on
# the shuffled grid of 262,144 cells (a Gdia fine level on the host cycle)
SLICE22_SOLVES = {
    "pKMG": ("knn", {"solver": "GKOCG", "matrixFormat": "Csr",
                     "preconditioner": {**MULTIGRID, "aggregation": "auto"}}),
    "pKMGpgm": ("knn", {"solver": "GKOCG", "matrixFormat": "Csr",
                        "preconditioner": {**MULTIGRID, "aggregation": "pgm"}}),
    "gKMG": ("knn", {"solver": "GKOMultigrid", "matrixFormat": "Ell",
                     "preconditioner": {**MULTIGRID, "preconditioner": "none",
                                        "aggregation": "auto"}}),
    "pSMG": ("shuffled", {"solver": "GKOCG",
                          "preconditioner": {**MULTIGRID, "aggregation": "auto"}}),
    "pKMGx": ("knn", {"solver": "GKOCG", "preconditioner": {**MULTIGRID, "aggregation": "auto"}}),
    "pSMGw": ("shuffled 262144", {"solver": "GKOCG",
                                  "preconditioner": {**MULTIGRID, "aggregation": "auto",
                                                     "cycle": "w"}}),
}
SLICE22_FORMATS = {"pKMG": "Csr", "pKMGpgm": "Csr", "gKMG": "Ell", "pSMG": "Gdia",
                   "pKMGx": "Xell", "pSMGw": "Gdia"}
SHUFFLED_SMALL = (64, 64, 64)
# the solves the device V-cycle takes (slice 23): field -> (its loop kernel,
# its row of the kernels line, the set-up's launches: the outer operator's
# apply twice (r0 and the norm factor), then the criterion's residual-eval
# timing)
SLICE23_LOOPS = {
    "pKMG": ("amg_cg_loop", "amg_cg_loop_csr", {"csr_spmv": 2 + RES_EVAL_SPMVS}),
    "gKMG": ("amg_ir_loop", "amg_ir_loop_ell", {"ell_spmv": 2 + RES_EVAL_SPMVS}),
    "pSMG": ("amg_cg_loop", "amg_cg_loop_gdia", {"gdia_k1": 2, "gdia_spmv": RES_EVAL_SPMVS}),
}
# the solves that keep the host cycle, and the reason kernels/amg_loop.py
# why_not names first
SLICE23_HOST = {"pKMGpgm": "aggregation pgm", "pKMGx": "the outer plan XellCgKernels",
                "pSMGw": "cycle w"}
# every standalone kernel of the host cycle: none of them in a loop solve
HOST_CYCLE_KERNELS = ("amg_sweep", "amg_resid", "amg_ell_sweep", "amg_ell_resid",
                      "amg_gdia_sweep", "amg_gdia_resid", "pgm_restrict", "pgm_prolong", "cg_k2n")
# the device V-cycle rows' check and timing iterations over their plain twins
# (the twin's cycle over the levels' twins takes 20-40 ms per iteration at 1M)
SLICE23_LOOP_ITERS = (5, 2)
PGM_PLAIN_CELLS = 1 << 18  # the pure-Python pgm loop is timed once, at this size


def slice22_route(slv, b, params):
    """A solver's route from a zero guess over the plain twins on the card:
    the merged CG's host loop (Gdia, Xell), the general CG (the gather
    formats) or Richardson (GKOMultigrid), with the plain cycle."""
    mat, pc = slv.matrix, plain_cycle(slv._precond_op)
    x0 = torch.zeros_like(b)
    if slv.route == "cg_fused":
        kern = plain_plan(mat)
        return cg_fused(kern, kern.pack_values(mat), b, x0, params, precond=pc)
    ops = krylov.single_device_ops(lambda v: spmv.spmv(mat, v), mat.shape[0], precond=pc)
    return (ir if slv.route == "ir" else cg)(ops, b, x0, params)


def check_slice22_launches(field, slv, before):
    """The launches between `before` and now, gated.  A solve the device
    V-cycle takes (SLICE23_LOOPS): its loop kernel once, the outer set-up's
    launches, no standalone level kernel, transfer kernel or K2n.  One that
    keeps the host cycle (SLICE23_HOST, kernels/amg_loop.py why_not naming
    its reason first): each smoothing level's format its sweep and residual
    kernels, the pgm transfer kernels exactly where the hierarchy aggregates
    by pgm, no AMG loop kernel.  Returns this solve's launches."""
    got = {k: kernels.launches[k] - before[k] for k in kernels.launches
           if kernels.launches[k] != before[k]}
    print(f"  {field}: launches in this solve {got}")
    levels = slv._precond_op.state
    why = amg_loop.why_not(slv._precond_op, slv.kern)
    print(f"  {field}: outer plan {type(slv.kern).__name__}; the device V-cycle "
          + ("takes the solve" if why is None else f"leaves it to the host cycle: {why}"))
    if field in SLICE23_LOOPS:
        loop, _, setup = SLICE23_LOOPS[field]
        want = {"amg_cg_loop": 0, "amg_ir_loop": 0, **dict.fromkeys(HOST_CYCLE_KERNELS, 0),
                **setup, loop: 1}
        have = {k: got.get(k, 0) for k in want}
        if why is not None or have != want:
            raise RuntimeError(f"{field}: launched {have}, not {want} (why_not: {why})")
        return got
    if why is None or not why.startswith(SLICE23_HOST[field]):
        raise RuntimeError(f"{field}: why_not says {why!r}, not {SLICE23_HOST[field]!r}")
    want_pos = {f"{LEVEL_SMOOTHERS[type(lv.mat).__name__]}_{step}"
                for lv in levels[:-1] for step in ("sweep", "resid")}
    pgm = any(lv.transfer is not None for lv in levels)
    bad = [k for k in want_pos if not got.get(k)]
    bad += [k for k in ("amg_cg_loop", "amg_ir_loop") if got.get(k)]
    bad += [k for k in ("pgm_restrict", "pgm_prolong") if bool(got.get(k)) != pgm]
    if bad:
        raise RuntimeError(f"{field}: launched {got}; wrong counts of {bad}")
    return got


def outer_plain(slv):
    """(K1, SpMV, set-up plan) of a loop solve's outer operator over plain
    twins on the card: the loop twin's K1 (CG) and SpMV (IR), and a plan
    whose `apply` is the plain SpMV (the set-up's r0 and norm factor)."""
    mat, kern = slv.matrix, slv.kern
    if isinstance(kern, GdiaCgKernels):
        vals, lidx = kern.pack_values(mat)
        k1 = functools.partial(gdia.gdia_k1_plain, vals, lidx, mat.plane_offsets)
        mv = functools.partial(gdia.gdia_spmv_plain, vals, lidx, mat.plane_offsets)
    else:
        k1 = functools.partial(gather_k1_plain, mat)
        mv = functools.partial(gather_spmv.spmv_csr if isinstance(mat, formats.Csr)
                               else gather_spmv.spmv_ell, mat)
    plan = types.SimpleNamespace(apply=lambda data, v: mv(v), n=mat.shape[0],
                                 dtype=torch.float32)
    return k1, mv, plan


def loop_twin_solve(field, slv, b, cfg):
    """The device V-cycle's plain twin on the card (amg_cg_loop_plain or
    amg_ir_loop_plain over the outer operator's plain K1 or SpMV and
    vcycle_plain), from the routes' set-up: (x, iterations, final
    residual)."""
    k1, mv, plan = outer_plain(slv)
    op = slv._precond_op
    x = torch.zeros_like(b)
    r = b - mv(x)
    nf = merged_norm_factor(plan, None, r, x, b)
    cycle = functools.partial(amg_loop.vcycle_plain, op.state, relax=op.relax,
                              sweeps=op.smooth_iters)
    if SLICE23_LOOPS[field][0] == "amg_ir_loop":
        rec = amg_loop.amg_ir_loop_plain(mv, x, r, torch.sum(torch.abs(r)), nf, cfg, cycle)
    else:
        rec = amg_loop.amg_cg_loop_plain(k1, x, r, torch.sum(torch.abs(r)), nf, cfg, cycle)
    return x, rec[0], rec[1]


def level_entry_bytes(m, value_bytes):
    """The least bytes of one pass over a level or outer operator's entries:
    each stored value (Dia: every diagonal slot; Gdia and Ell: the live
    entries, with their lane or column; Csr: values, columns and row
    offsets)."""
    if isinstance(m, formats.Dia):
        return len(m.offsets) * m.shape[0] * value_bytes
    if isinstance(m, gdia.Gdia):
        return int((m.vals != 0).sum()) * (value_bytes + 1)
    if isinstance(m, formats.Csr):
        return m.nnz * (value_bytes + 4) + (m.shape[0] + 1) * 4
    n = m.shape[0]
    live = (m.cols != torch.arange(n, device=m.cols.device)) | (m.vals != 0)
    return int(live.sum()) * (value_bytes + 4)


def amg_loop_bytes(op, outer_bytes, n, ir_loop):
    """Minimum bytes per iteration of the AMG loop kernel, phase by phase
    (csrc/amg_loop.cuh): on each smoothing level of n rows, E bytes of
    entries (level_entry_bytes: Dia diagonals, Gdia or Ell entries in the
    smoother's packing) and s sweeps, down the zero-guess sweep (E + b and
    invd in, x out: 12 B/row; with s = 1 folded into the restricting
    residual), s − 2 more sweeps (E + 16 B/row each), the restricting
    residual (E + x, b in: 8 B/row; the coarse b out); up the prolongation (x
    in and out: 8 B/row), s sweeps (E + 16 B/row each; level 0's last writes
    z and reads r for ρ, or adds z to x: + 8 B/row); the coarsest level's
    dense inverse and b once; the outer operator's `outer_bytes` with K1 +
    K2n (CG: z, p in, p', q out, then x, r, p', q in, x, r out: 40 B/row) or
    the residual r − A z (IR: z, r in, r out: 12 B/row) and x += z (8)."""
    s = op.smooth_iters
    total = 0
    for i, lv in enumerate(op.state[:-1]):
        e = level_entry_bytes(lv.mat, lv.data_s.element_size())
        down = (e + 12 * lv.n) if s == 1 else (
            (e + 12 * lv.n) + (s - 2) * (e + 16 * lv.n) + (e + 8 * lv.n))
        total += down + 8 * lv.n + s * (e + 16 * lv.n) + 4 * op.state[i + 1].n
    nc = op.state[-1].n
    total += 4 * nc * nc + 4 * nc
    return total + outer_bytes + n * (20 if ir_loop else 40)


def slice23_loop_rows(loops, report):
    """Each new loop variant (pKMG's Csr, gKMG's Ell, pSMG's Gdia outer) at
    its solve's size, against its plain twin on the card from one set-up
    (b random, x0 = 0; x after SLICE23_LOOP_ITERS[0] pinned iterations within
    AMG_LOOP_RTOL) and timed in turns with the host cycle over the
    standalone kernels (the route on the same plan: the general CG, Richardson
    over the plan's SpMV, or the merged CG with a plan that keeps the host
    loop): loop_row."""
    for field, slv in loops.items():
        _, row, _ = SLICE23_LOOPS[field]
        op, kern, mat = slv._precond_op, slv.kern, slv.matrix
        data = kern.pack_values(mat)
        n, dev = kern.n, kern.device
        ir_loop = SLICE23_LOOPS[field][0] == "amg_ir_loop"
        label = "shuffled" if isinstance(kern, GdiaCgKernels) else "knn"
        k1, mv, plan = outer_plain(slv)
        b = torch.randn(n, device=dev, generator=torch.Generator(device=dev).manual_seed(23))
        x0 = torch.zeros_like(b)
        r0 = b - kern.apply(data, x0)
        state = (torch.sum(torch.abs(r0)), merged_norm_factor(kern, data, r0, x0, b))
        cycle = functools.partial(amg_loop.vcycle_plain, op.state, relax=op.relax,
                                  sweeps=op.smooth_iters)

        def run(k, plain, kern=kern, data=data, op=op, state=state, r0=r0, mv=mv, k1=k1,
                cycle=cycle, ir_loop=ir_loop):
            x, r = torch.zeros_like(r0), r0.clone()
            cfg = checked_iterations(k)
            if not plain:
                rec = (amg_loop.amg_ir_loop if ir_loop else amg_loop.amg_cg_loop)(
                    kern, data, op, x, r, *state, cfg)
            elif ir_loop:
                rec = amg_loop.amg_ir_loop_plain(mv, x, r, *state, cfg, cycle)
            else:
                rec = amg_loop.amg_cg_loop_plain(k1, x, r, *state, cfg, cycle)
            return x, rec[0], rec[1]

        ops = krylov.single_device_ops(functools.partial(kern.spmv, data), n, precond=op)
        if ir_loop:
            host_solve = lambda k, ops=ops, b=b: ir(ops, b, torch.zeros_like(b),  # noqa: E731
                                                    checked_iterations(k))
        elif isinstance(kern, GdiaCgKernels):
            host = HostLoopGdiaCgKernels(n, kern.plane_offsets, dev)
            host_solve = lambda k, host=host, data=data, b=b, op=op: cg_fused(  # noqa: E731
                host, data, b, torch.zeros_like(b), checked_iterations(k), precond=op)
        else:
            host_solve = lambda k, ops=ops, b=b: cg(ops, b, torch.zeros_like(b),  # noqa: E731
                                                    checked_iterations(k))
        what = "the host cycle + " + ("the SpMV" if ir_loop else "K1 + K2n" if isinstance(
            kern, GdiaCgKernels) else "the SpMV + torch ops")
        tab = amg_loop.table_of(op)
        print(f"  [{row}: {field}'s hierarchy "
              f"{[f'{type(lv.mat).__name__} {lv.n}' for lv in op.state]}, stages "
              f"{tab.table[:, 22].tolist()}, {tab.smem} bytes of dynamic shared memory]")
        loop_row(f"{row}[bf16]", label, run, host_solve, what,
                 amg_loop_bytes(op, level_entry_bytes(mat, 4), n, ir_loop), n, report,
                 check=SLICE23_LOOP_ITERS[0], iters=SLICE23_LOOP_ITERS[1],
                 vec_rtol=AMG_LOOP_RTOL)


def bit_err(got, want):
    """Bit equality: the largest difference, held to 0."""
    return float((got - want).abs().max()), 0.0


def ell_csr(m):
    """torch's CSR tensor of an Ell level's entries (padding dropped), for
    library_ms."""
    k, n = m.cols.shape
    rows = torch.arange(n, device=m.cols.device).expand(k, n)
    live = (m.cols != rows) | (m.vals != 0)
    return csr_of_coo(rows[live], m.cols[live].long(), m.vals[live], n)


def gdia_csr(m):
    """torch's CSR tensor of a Gdia level's entries, for library_ms."""
    npl, r, lanes = m.vals.shape
    n = m.shape[0]
    q = torch.tensor(m.plane_offsets, device=m.vals.device)[:, None, None]
    i = torch.arange(r * lanes, device=m.vals.device).view(1, r, lanes)
    src = (i // lanes + q) * lanes + m.lidx.long()
    live = (m.vals != 0) & (i < n) & (src >= 0) & (src < n)
    return csr_of_coo(i.expand_as(m.vals)[live], src[live], m.vals[live], n)


def slice22_kernels(ops, report):
    """K-E on pKMG's fine level (Ell), K-G on pSMG's fine level (Gdia), in
    both value types, each against its twin on the card (bit-equal), with
    the profiler's device time per launch and the chained time of the
    path's cases beside the CUDA events around each call, torch.addmv beside
    the float32 residuals; and K-T on pKMGpgm's first level, index_add_
    beside the restriction (also by device and chained time)."""
    device = ops["pKMG"].state[0].inv_diag.device
    g = torch.Generator(device=device).manual_seed(22)
    for field, label in (("pKMG", "knn"), ("pSMG", "shuffled")):
        lv = ops[field].state[0]
        kind = type(lv.mat).__name__
        name = LEVEL_SMOOTHERS[kind]
        n = lv.n
        x, b = (torch.randn(n, device=device, generator=g) for _ in range(2))
        if kind == "Ell":
            nnz = int(((lv.mat.cols != torch.arange(n, device=x.device)) | (lv.mat.vals != 0))
                      .sum())
            lane = 4  # each entry's column
        else:
            nnz = int((lv.mat.vals != 0).sum())
            lane = 1  # each entry's source lane
        bf16 = lv.data_s.to(torch.bfloat16)
        for tag, vals in (("bf16", bf16), ("f32", lv.mat.vals)):
            entry = nnz * (vals.element_size() + lane)
            compare(f"{name}_sweep[{tag}]", label,
                    lambda v=vals: ((lv.kern.sweep(v, x, b, lv.inv_diag, RELAX),), ()),
                    lambda v=vals: ((lv.kern.twin(v, x, b, lv.inv_diag, RELAX),), ()),
                    entry + 4 * n * 4, 2 * nnz + 4 * n, report, err=bit_err)
            compare(f"{name}_resid[{tag}]", label,
                    lambda v=vals: ((lv.kern.resid(v, x, b),), ()),
                    lambda v=vals: ((lv.kern.twin(v, x, b, None, 0.0),), ()),
                    entry + 3 * n * 4, 2 * nnz + n, report, err=bit_err)
        csr = ell_csr(lv.mat) if kind == "Ell" else gdia_csr(lv.mat)
        f32 = lv.mat.vals
        addmv = lambda: torch.addmv(b, csr, x, alpha=-1)  # noqa: E731
        resid = lambda: lv.kern.resid(f32, x, b)  # noqa: E731
        library_call(f"{name}_resid[f32]", label, "torch.addmv(b, A_csr, x, alpha=-1)", addmv,
                     resid, f"{kind} level of {n} rows", report)
        device_beside(f"{name}_resid[f32]", label, resid, addmv, report)
        row = report[f"{name}_sweep[bf16]"][label]
        sweep = lambda: lv.kern.sweep(bf16, x, b, lv.inv_diag, RELAX)  # noqa: E731
        row["device_ms"], row["chain_ms"] = device_ms_per_launch(sweep), chain_ms(sweep)
        dev = "not measured" if row["device_ms"] is None else f"{row['device_ms']:.4f} ms"
        print(f"  {name}_sweep[bf16] ({label}): device time per launch {dev} (profiler), "
              f"chained {row['chain_ms']:.4f} ms, around each call {row['ms']:.4f} ms")
        del csr
    lv = ops["pKMGpgm"].state[0]
    tr = lv.transfer
    n, nc = tr.n, tr.nc
    r, x = (torch.randn(n, device=device, generator=g) for _ in range(2))
    ec = torch.randn(nc, device=device, generator=g)
    agg64 = tr.agg.long()
    compare("pgm_restrict", "knn", lambda: ((tr.restrict(r),), ()),
            lambda: ((amg_level.pgm_restrict_plain(tr.table, r),), ()),
            n * 8 + (nc + 1) * 4 + nc * 4, n, report, err=bit_err)
    if not torch.equal(tr.restrict(r), tr.restrict(r)):
        raise RuntimeError("pgm_restrict: two runs gave different bits")
    compare("pgm_prolong", "knn", lambda: ((tr.prolong_add(x, ec),), ()),
            lambda: ((amg_level.pgm_prolong_add_plain(agg64, x, ec),), ()),
            n * 12 + nc * 4, n, report, err=bit_err)
    index_add = lambda: torch.zeros(nc, device=device).index_add_(0, agg64, r)  # noqa: E731
    library_call("pgm_restrict", "knn", "torch.zeros(nc).index_add_(0, agg, r)", index_add,
                 lambda: tr.restrict(r), f"{n} fine rows into {nc} aggregates", report)
    device_beside("pgm_restrict", "knn", lambda: tr.restrict(r), index_add, report)
    print(f"  pgm_restrict: the same bits on two runs ({n} rows into {nc} aggregates)")


def slice22_path(device, m_knn, b_knn, knn_small, grid, ctl) -> tuple:
    """Phase 14.  Returns the launch counts of the path and its kernel
    report."""
    print(f"== phase 14: slices 22-23, AMG on unstructured meshes (Gdia and Ell levels; the "
          f"device V-cycle on Csr, Ell and Gdia outer operators; pgm transfers, the Xell outer "
          f"and cycle w on the host cycle), foam.solve at {m_knn.n} (kNN-6) and "
          f"{int(np.prod(grid))} (shuffled grid) cells")
    info = _build.build_info()
    for kernel in ("ell_smooth_kernel", "gdia_smooth_kernel", "restrict_kernel",
                   "prolong_kernel"):
        print(f"{kernel}: ptxas: " + "; ".join(loop_ptxas(info["log"], None, kernel)))
    t0 = time.perf_counter()
    m_shuf = testing.shuffled_poisson_ldu(grid)
    b_shuf = np.random.default_rng(0).normal(size=m_shuf.n).astype(np.float32)
    m_small = testing.shuffled_poisson_ldu(SHUFFLED_SMALL)
    b_small = np.random.default_rng(0).normal(size=m_small.n).astype(np.float32)
    print(f"host set-up: shuffled grids {time.perf_counter() - t0:.2f} s")
    systems = {"knn": (m_knn, b_knn), "shuffled": (m_shuf, b_shuf),
               "shuffled 262144": (m_small, b_small)}
    ctl = {**ctl, "verbose": 0, "adaptMinIter": False}
    records, ops, loops, launches = {}, {}, {}, {}
    kernels.reset_launches()
    for field, (mesh, spec) in SLICE22_SOLVES.items():
        mk, bk = systems[mesh]
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, mk, bk, {**ctl, **spec})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        slv = registry.global_registry.get(f"{field}_solver")
        got = check_slice22_launches(field, slv, before)
        if field in SLICE23_LOOPS:
            loop, row, _ = SLICE23_LOOPS[field]
            launches[row] = got[loop]
            loops[field] = snapshot17(slv)
        if perf.solver_name != f"{spec['solver']}_{SLICE22_FORMATS[field]}":
            raise RuntimeError(f"{field} ran as {perf.solver_name}")
        it = max(perf.n_iterations, 1)
        lt = slv.last_timings
        print(f"{field} (route {slv.route}): first solve wall {wall:.3f} s; "
              f"generate_preconditioner {lt['generate_preconditioner'] * 1e3:.1f} ms, solve "
              f"{lt['solve'] * 1e3:.3f} ms = {lt['solve'] / it * 1e6:.1f} us per iteration; on "
              f"resident state {slv.time_device_solve() / it * 1e6:.2f} us per iteration")
        describe_hierarchy(slv._precond_op.state)
        ops[field] = slv._precond_op
        records[field] = (x, perf, snapshot17(slv), torch.tensor(bk, device=device),
                          stopping.StoppingParams.of(slv.cfg.stopping))
    launches.update({k: kernels.launches[k] for k in SLICE22_KERNELS if k not in launches})
    print(f"launch counts over the path: {dict(kernels.launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"slices 22-23's path never launched {missing}")
    for variant in sorted({amg_loop.table_of(ops[f]).variant | amg_loop.OUTER_BITS[type(
            slv.kern)] | (amg_loop.VARIANT_IR if SLICE23_LOOPS[f][0] == "amg_ir_loop" else 0)
            for f, slv in loops.items()}):
        smem = max(amg_loop.table_of(ops[f]).smem for f in loops)
        blocks = amg_loop.loop_blocks(variant, device, smem)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"amg_loop grid, variant {variant} (amg_loop_kernel<{variant}>) at {smem} bytes "
              f"of dynamic shared memory: {blocks} co-resident blocks of 512 ({blocks // sms} "
              "per SM); ptxas: " + "; ".join(loop_ptxas(info["log"], variant,
                                                        "amg_loop_kernel")))

    # ---- checks of the path (launches not counted) --------------------------
    for field, (x, perf, slv, bb, params) in records.items():
        mat = slv.matrix
        n = mat.shape[0]
        if not perf.converged:
            raise RuntimeError(f"{field}: did not converge: {perf}")
        if x.shape != (n,) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{field}: solution not finite of shape ({n},)")
        mat64 = formats.cast_values(mat, torch.float64)
        tr = true_residual_mv(lambda v, mat64=mat64: spmv.spmv(mat64, v), x, bb)
        t0 = time.perf_counter()
        plain = slice22_route(slv, bb, params).iters
        torch.cuda.synchronize()
        bf16 = slv._precond_op.state[0].data_s.dtype == torch.bfloat16
        line = (f"{field}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} (limit "
                f"{TRUE_RESIDUAL_MARGIN:g} x {TOL:g}); the host cycle over the plain twins on "
                f"the card: {plain} iterations ({time.perf_counter() - t0:.2f} s)")
        if not -1 <= perf.n_iterations - plain <= (2 if bf16 else 1):
            raise RuntimeError(f"{field}: {perf.n_iterations} iterations vs {plain} over the "
                               "plain twins")
        if field in SLICE23_LOOPS:
            t0 = time.perf_counter()
            _, twin, _ = loop_twin_solve(field, slv, bb, params)
            line += (f"; the loop's plain twin on the card: {twin} iterations "
                     f"({time.perf_counter() - t0:.2f} s)")
            if abs(perf.n_iterations - twin) > 1:
                raise RuntimeError(f"{field}: {perf.n_iterations} iterations vs {twin} over "
                                   "the loop's plain twin")
        print(line)
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{field}: true residual {tr:.3e} above the limit")
    del records

    # the pgm aggregation: the native runtime against the pure-Python loop
    import scipy.sparse as sp

    c = ldu.ldu_to_coo_host(knn_small[0], dtype=np.float32)
    a = sp.csr_matrix((c.vals, (c.rows, c.cols)), shape=c.shape)
    t0 = time.perf_counter()
    agg = amg.pgm_aggregate(a)
    t1 = time.perf_counter()
    agg_plain = amg.pgm_aggregate_plain(a)
    t2 = time.perf_counter()
    if not np.array_equal(agg, agg_plain):
        raise RuntimeError("the native pgm aggregation differs from the pure-Python loop")
    print(f"pgm aggregation of the {a.shape[0]}-cell kNN-6 fine level (host): native "
          f"{(t1 - t0) * 1e3:.1f} ms, the pure-Python loop {(t2 - t1) * 1e3:.1f} ms, equal")

    # ---- the kernels against their twins ------------------------------------
    report = {}
    print("slice 23's device V-cycle variants vs their plain twins (x after "
          f"{SLICE23_LOOP_ITERS[0]} pinned iterations within {AMG_LOOP_RTOL:.0e}*max(1,max|plain|)"
          f"), per iteration over {SLICE23_LOOP_ITERS[1]} in turns with the host cycle:")
    slice23_loop_rows(loops, report)
    del loops
    print("slice 22's kernels vs their twins at 1M (bit-equal required; bound: the least "
          f"bytes over {PEAK_BYTES_PER_S / 1e12:.2f} TB/s):")
    slice22_kernels(ops, report)
    del ops
    torch.cuda.empty_cache()
    return launches, report


# ---- phase 15: slice 24, the transient steady step ----------------------------

# a step's relative change of the changed coefficients (the bench's steps):
# small enough for a bfloat16 delta under tolerance 1e-6 (error cap 1e-7)
STEP_REL = 1e-7
# each example's steps on the card in the smoke (cavity n 32, Karman 96x32),
# held to the same steps on the CPU
EXAMPLE_STEPS = 40
EXAMPLE_PSI_ATOL = 1e-4
SLICE24_KERNELS = ("value_update",)


def dup_faces_ldu(m):
    """`m` with a cyclic interface that couples every third x face's cells
    again: those entries share their faces' slots, so its value map sums
    several entries per slot (the accumulate plan).  Diagonally dominant."""
    lo, up = np.asarray(m.lower_addr), np.asarray(m.upper_addr)
    pick = np.flatnonzero(up - lo == 1)[::3]
    li = ldu.LocalInterface(rows=np.concatenate([lo[pick], up[pick]]),
                            cols=np.concatenate([up[pick], lo[pick]]),
                            coeffs=-np.linspace(0.1, 0.4, 2 * len(pick)).astype(np.float32))
    return dataclasses.replace(m, local_interfaces=(li,))


def cpu_write(w):
    """A value-update Write with its tables on the CPU."""
    c = (lambda t: None if t is None else t.cpu())
    return vu.Write(w.block, c(w.src), c(w.dest), c(w.seg), w.start, w.items, w.scale)


def check_step_values(what, slv, spent):
    """The container of the solver's last step against the full path (the
    kernel writing every block into zeros) and against the twin doing the
    same on CPU copies of the resident blocks: bit-equal, and the full path
    twice the same bits.  Launches of this check are not the path's: they
    are added to `spent`, which the path's count leaves out."""
    nb = len(slv._blocks_host)
    before = kernels.launches["value_update"]
    step = formats.values_flat(slv.matrix)
    full = [formats.values_flat(slv._apply_block_updates(range(nb), False)) for _ in range(2)]
    twin = torch.zeros(step.numel())
    vu.value_update_plain(twin, [(d.cpu(), None, None) for d in slv._blocks_dev],
                          [cpu_write(w) for w in slv.update_writes(range(nb))])
    same = (torch.equal(step, full[0]), torch.equal(full[0], full[1]),
            torch.equal(step.cpu().view(torch.int32), twin.view(torch.int32)))
    spent["value_update"] += kernels.launches["value_update"] - before
    print(f"  {what}: the step's container bit-equal to the full path {same[0]}, the full "
          f"path repeats its bits {same[1]}, bit-equal to the twin on CPU copies {same[2]}")
    if not all(same):
        raise RuntimeError(f"{what}: the value update's bits disagree: {same}")


def step_once(field, mk, bk, ctl, want_blocks, want_launches=1):
    """One steady step of `field` through foam.solve; the blocks it uploaded
    and its value_update launches gated.  Returns the solver."""
    before = kernels.launches["value_update"]
    t0 = time.perf_counter()
    _, perf = foam.solve(field, mk, bk, ctl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    slv = registry.global_registry.get(f"{field}_solver")
    got = kernels.launches["value_update"] - before
    lt = slv.last_timings
    print(f"  {field} step: wall {wall * 1e3:.3f} ms = " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in sorted(lt.items())) + f" ms; {perf.n_iterations} "
        f"iterations; blocks changed {slv.last_blocks_changed}, uploaded "
        f"{slv.last_blocks_uploaded} (bf16 {slv.last_blocks_bf16[0]}), "
        f"{slv.last_upload_bytes} bytes, rhs bf16 {slv.last_rhs_bf16}; value_update launches "
        f"{got}")
    if not perf.converged:
        raise RuntimeError(f"{field} step did not converge: {perf}")
    if slv.last_blocks_uploaded != want_blocks or got != want_launches:
        raise RuntimeError(f"{field} step: uploaded {slv.last_blocks_uploaded}, launched "
                           f"value_update {got} times; want {want_blocks}, {want_launches}")
    return slv


def nudged(m, rel, blocks):
    """`m` with the named coefficient blocks scaled by 1 + rel."""
    f = np.float32(1.0 + rel)
    return dataclasses.replace(m, **{k: np.asarray(getattr(m, k)) * f for k in blocks})


def run_examples(device):
    """Both example applications on the card for EXAMPLE_STEPS steps, ψ held
    to the same steps on the CPU.  Returns the value_update launches of the
    card's runs."""
    from ogl_tpu_torch.examples import cavity, karman

    before = kernels.launches["value_update"]
    out = {}
    for name, fn in (("cavity n 32", lambda ex: cavity.run(
            n=32, steps=EXAMPLE_STEPS, verbose=False, executor=ex)[0]),
                     ("karman 96x32", lambda ex: karman.run(
            nx=96, ny=32, d=6, steps=EXAMPLE_STEPS, verbose=False, executor=ex)[0])):
        registry.global_registry.clear()
        t0 = time.perf_counter()
        card = fn("cuda")
        wall = time.perf_counter() - t0
        registry.global_registry.clear()
        host = fn("cpu")
        err = float(np.abs(card.psi - host.psi).max())
        print(f"  example {name}: {EXAMPLE_STEPS} steps on the card in {wall:.2f} s, psi min "
              f"{float(card.psi.min()):.5f}, |psi - psi on the CPU| max {err:.2e} (tol "
              f"{EXAMPLE_PSI_ATOL:.0e})")
        if not np.all(np.isfinite(card.psi)) or err > EXAMPLE_PSI_ATOL:
            raise RuntimeError(f"example {name}: psi off the CPU run's by {err:.2e}")
        out[name] = wall
    registry.global_registry.clear()
    got = kernels.launches["value_update"] - before
    print(f"  the examples launched value_update {got} times on the card")
    if got < 2 * (EXAMPLE_STEPS - 1):  # the ω operator changes at every step after the first
        raise RuntimeError(f"the examples launched value_update {got} times")
    return got


def slice24_kernels(slv_dia, slv_knn, slv_acc, grid_main, grid_big, report):
    """value_update against its twin on the card (bit-equal) on the path's
    plans: the Dia diag block's affine plan at 1M (and an affine run of
    8.4M), the Csr diag block's scatter plan and upper block's gather +
    scatter plan and both blocks from zeros on the kNN mesh, a bfloat16
    delta decoded while the Dia diag plan writes, and the accumulate plan
    of the duplicated-faces grid; flat.index_copy_ beside the one-block
    identity-src plans."""
    label = "x".join(map(str, grid_main))
    dev = slv_dia.device
    g = torch.Generator(device=dev).manual_seed(24)

    def case(name, lab, flat, sources, writes, entries=None, lib=None):
        fk, fp = flat.clone(), flat.clone()
        outs = [(o, None if o is None else o.clone()) for _, _, o in sources]
        psrc = [(a, d, po) for (a, d, _), (_, po) in zip(sources, outs)]

        def kern():
            vu.value_update(fk, sources, writes)
            return (fk, *[o for o, _ in outs if o is not None]), ()

        def plain():
            vu.value_update_plain(fp, psrc, writes)
            return (fp, *[po for _, po in outs if po is not None]), ()

        compare(name, lab, kern, plain, vu.bytes_moved(sources, writes, entries), 0, report,
                err=bit_err)
        if lib is not None:
            library_call(name, lab, "flat.index_copy_(0, dest, v)", lib, lambda: kern()[0][0],
                         f"one block of {writes[0].items} entries", report)
            device_beside(name, lab, lambda: kern(), lib, report)

    def plan_case(name, lab, slv, indices, zeros=False, lib=False):
        sources = [(slv._blocks_dev[i], None, None) for i in indices]
        writes = slv.update_writes(indices)
        flat = (torch.zeros(formats.values_flat(slv.matrix).numel(), device=slv.device)
                if zeros else formats.fresh_values(slv.matrix))
        entries = (int(slv._acc_plan.seg[-1]) if slv._block_plans is None else None)
        call = None
        if lib:
            w = writes[0]
            dest = (w.dest.long() if w.dest is not None else
                    torch.arange(w.start, w.start + w.items, device=slv.device))
            v = sources[0][0] * torch.tensor(w.scale, device=slv.device)
            fl = flat.clone()
            call = lambda: fl.index_copy_(0, dest, v)  # noqa: E731
        case(name, lab, flat, sources, writes, entries, call)

    plan_case("value_update", label, slv_dia, [1], lib=True)
    n8 = int(np.prod(grid_big))
    blk8 = torch.randn(n8, device=dev, generator=g)
    dest8 = torch.arange(3 * n8, 4 * n8, device=dev)
    flat8 = torch.zeros(7 * n8, device=dev)
    case("value_update", "x".join(map(str, grid_big)), flat8, [(blk8, None, None)],
         [vu.Write(0, None, None, None, 3 * n8, n8, 1.0)],
         lib=lambda: flat8.index_copy_(0, dest8, blk8))
    del flat8, blk8, dest8
    plan_case("value_update[scatter]", "knn", slv_knn, [1], lib=True)
    plan_case("value_update[gather_scatter]", "knn", slv_knn, [0])
    plan_case("value_update[full]", "knn", slv_knn, [0, 1], zeros=True)
    nd = slv_dia._blocks_dev[1]
    delta = (STEP_REL * torch.randn(nd.numel(), device=dev, generator=g) * nd
             ).to(torch.bfloat16)
    case("value_update[bf16]", label, formats.fresh_values(slv_dia.matrix),
         [(nd, delta, torch.empty_like(nd))], slv_dia.update_writes([1]))
    plan_case("value_update[accumulate]", label, slv_acc, range(len(slv_acc._blocks_host)),
              zeros=True)


def slice24_path(device, m, b, m_knn, b_knn, grid_main, grid_big, ctl) -> tuple:
    """Phase 15.  Returns the launch counts of the path and its kernel
    report."""
    print(f"== phase 15: slice 24, the transient steady step (value_update), foam.solve at "
          f"{m.n} (Poisson, Dia) and {m_knn.n} (kNN-6, Csr) cells, and the examples")
    ctl = {**ctl, "verbose": 0, "solver": "GKOCG", "preconditioner": "none"}
    dia = {**ctl, "matrixFormat": "Dia"}
    csr = {**ctl, "matrixFormat": "Csr"}
    bf = {**dia, "uploadPrecision": "bfloat16"}
    m_acc = dup_faces_ldu(m)
    acc = {**dia, "solver": "GKOBiCGStab"}
    report: dict = {}
    spent = {k: 0 for k in SLICE24_KERNELS}  # the checks' launches
    kernels.reset_launches()
    for field, mm, bb, c in (("pVU", m, b, dia), ("pKVU", m_knn, b_knn, csr),
                             ("pVUbf", m, b, bf), ("pVUacc", m_acc, b, acc)):
        t0 = time.perf_counter()
        _, perf = foam.solve(field, mm, bb, c)
        torch.cuda.synchronize()
        print(f"  {field}: first solve {time.perf_counter() - t0:.2f} s, "
              f"{perf.n_iterations} iterations")
    # a diag-only step on Dia: one of two blocks staged, the affine plan, one launch
    m1 = nudged(m, STEP_REL, ("diag",))
    slv = step_once("pVU", m1, b, dia, (1, 2))
    if slv._block_plans[1].dest is not None or slv._block_plans[1].src is not None:
        raise RuntimeError("pVU: the diag block's plan is not affine")
    check_step_values("pVU diag-only", slv, spent)
    slv = step_once("pVU", nudged(m1, STEP_REL, ("diag", "upper")), b, dia, (2, 2))
    check_step_values("pVU all blocks", slv, spent)
    slv_dia = slv
    mk1 = nudged(m_knn, STEP_REL, ("diag",))
    slv = step_once("pKVU", mk1, b_knn, csr, (1, 2))
    check_step_values("pKVU diag-only", slv, spent)
    slv = step_once("pKVU", nudged(mk1, STEP_REL, ("diag", "upper")), b_knn, csr, (2, 2))
    check_step_values("pKVU all blocks", slv, spent)
    slv_knn = slv
    # bfloat16 deltas: the first steady step sends the diag at full width
    # (as the reference's), the next one as a delta of half the bytes, the
    # decoded copies the host mirrors' bits
    n = m.n
    slv = step_once("pVUbf", m1, b, bf, (1, 2))
    if slv.last_blocks_bf16 != (0, 2) or slv.last_upload_bytes != 4 * n:
        raise RuntimeError("pVUbf: the first steady step did not send the diag at full width")
    b1 = (b * np.float32(1.0 + STEP_REL)).astype(np.float32)
    slv = step_once("pVUbf", nudged(m1, STEP_REL, ("diag",)), b1, bf, (1, 2), want_launches=2)
    bits = (torch.equal(slv._blocks_dev[1].cpu(), torch.from_numpy(slv._blocks_mirror[1])),
            torch.equal(slv._b_dev.cpu(), torch.from_numpy(slv._b_mirror)))
    print(f"  pVUbf: {slv.last_upload_bytes} bytes for the {n}-entry diag block (float32: "
          f"{4 * n}); decoded diag and b bit-equal to the host mirrors {bits}")
    if (slv.last_blocks_bf16 != (1, 2) or not slv.last_rhs_bf16
            or slv.last_upload_bytes * 2 != 4 * n or not all(bits)):
        raise RuntimeError("pVUbf: the bfloat16 step did not halve the bytes or its decode "
                           "left the mirrors")
    check_step_values("pVUbf diag-only", slv, spent)
    # slots of several entries: the accumulate plan, the same bits every run
    slv = step_once("pVUacc", nudged(m_acc, STEP_REL, ("diag",)), b, acc, (1, 3))
    if slv._block_plans is not None:
        raise RuntimeError("pVUacc: the duplicated faces did not make an accumulate map")
    check_step_values("pVUacc diag-only (accumulate plan)", slv, spent)
    slv_acc = slv
    run_examples(device)
    launches = {k: kernels.launches[k] - spent[k] for k in SLICE24_KERNELS}
    print(f"launch counts over phase 15's path: {launches} (the checks' {spent} left out)")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"phase 15's path never launched {missing}")
    slice24_kernels(slv_dia, slv_knn, slv_acc, grid_main, grid_big, report)
    for field in ("pVU", "pKVU", "pVUbf", "pVUacc"):
        registry.global_registry.pop(f"{field}_solver", None)
    return launches, report


# one turn of `--turns`: phase 3's Dia kernels at 1M and 8.4M rows, then the
# Gdia SpMV and K1 on the shuffled grid built on the device at both sizes,
# then 200 checked iterations of the merged pipelined CG and of the merged
# BiCGStab on the Dia plan at both sizes (one launch of the loop kernel
# where a tree has it, else the host loop over KA and KB_pipe, over K1B and
# KB_update), then the pMG and pGMG solves through foam.solve at 1M cells,
# timed on resident state (one launch of the AMG loop kernel where a tree
# has it, else the host-launched cycle), the GKOBiCGStab solves the same
# way (and BASELINE config 2's GKOBiCGStab + blocked BJ solves of phase 12
# on the Poisson and convection-diffusion grids, three times the best of
# 3), then the Xell SpMV and K1 on the shuffled grid packed as Xell at 1M
# and 8.4M rows and GKOCG `none` and `BJ` on the kNN-6 mesh at 1M cells
# (pK, pKBJ; one launch of the Xell loop kernel where a tree has it, else
# the host loop over the K1 and K2i or K2 kernels) on resident state, then
# TURN_GATHER — only functions that this script's earlier versions have too
TURN_HEAD = "import numpy as np, torch, chip_smoke as s; d = torch.device('cuda'); r = {}\n"
# the kNN-6 mesh at 1M cells, RCM-numbered, and its b (as phase 8 makes them)
TURN_KNN = ("mo, perm = s.testing.knn_ldu(s.KNN_1M)\n"
            "mk = s.testing.renumber_ldu(mo, np.argsort(perm))\n"
            "bk = np.random.default_rng(0).normal(size=mk.n).astype(np.float32)\n")
# GKOCG and GKOBiCGStab `none` and `BJ` on the kNN-6 mesh as Ell, Hybrid,
# Csr and Sell on resident state (one launch of a loop kernel's variant of
# the format where a tree has it, else the host loops over the SpMV kernel),
# and the four SpMVs on the kNN-6 mesh and on the 256x256x128 Poisson grid
# against their twins, torch's CSR SpMV beside them, with the profiler's
# device time per launch (also alone: `--turns-gather`)
TURN_GATHER = (
    "bj = {'preconditioner': 'BJ'}\n"
    "for fmt in ('Ell', 'Hybrid', 'Csr', 'Sell'):\n"
    "  for f, ex in (('g', {}), ('gBJ', {'preconditioner': bj}), ('u', {'solver': "
    "'GKOBiCGStab'}), ('uBJ', {'solver': 'GKOBiCGStab', 'preconditioner': bj})):\n"
    "    f = f[0] + fmt + f[1:]\n"
    "    ctl = {'solver': 'GKOCG', 'executor': 'cuda', 'tolerance': s.TOL, 'relTol': 0, "
    "'matrixFormat': fmt, **ex}\n"
    "    _, perf = s.foam.solve(f, mk, bk, ctl)\n"
    "    sec = s.registry.global_registry.get(f + '_solver').time_device_solve()\n"
    "    print(f'  gather_solve {f} (kNN-6) {mk.n} cells: {perf.n_iterations} iterations, "
    "{sec * 1e3:.3f} ms on resident state (best of 3) = {sec / perf.n_iterations * 1e6:.2f} us "
    "per iteration')\n"
    "def gather_turn(label, coo, rows, cols, vals):\n"
    "    x = torch.randn(coo.shape[0], device=d, generator=torch.Generator(device=d)"
    ".manual_seed(0))\n"
    "    csr = s.csr_of_coo(rows, cols, vals, coo.shape[0])\n"
    "    mats = {'Ell': s.formats.coo_to_ell(coo, device=d), 'Hybrid': s.formats.coo_to_hybrid("
    "coo, device=d), 'Csr': s.formats.coo_to_csr(coo, device=d), 'Sell': s.formats.coo_to_sell("
    "coo, device=d)}\n"
    "    s.check_gather_kernels(mats, label, x, csr, r)\n"
    "    for fmt, mm in mats.items():\n"
    "        s.device_beside(s.GATHER_FORMATS[fmt], label, lambda mv=s.spmv.matvec(mm): mv(x), "
    "lambda: csr @ x, r)\n"
    "c = s.registry.global_registry.get('gEll_solver').coo_host()\n"
    "gather_turn('knn', c, *(torch.tensor(a, device=d) for a in (c.rows.astype(np.int64), "
    "c.cols.astype(np.int64), c.vals)))\n"
    "s.registry.global_registry.clear()\n"
    "data, offs = s.poisson_dia(s.GRID_8M, d)\n"
    "rows, cols, vals = s.dia_coo(data, offs)\n"
    "nb = data.shape[1]\n"
    "del data\n"
    "o = torch.argsort(rows * nb + cols)\n"
    "rows, cols, vals = rows[o], cols[o], vals[o]\n"
    "gather_turn('256x256x128', s.formats.Coo(rows=rows.cpu().numpy().astype(np.int32), "
    "cols=cols.cpu().numpy().astype(np.int32), vals=vals.cpu().numpy(), shape=(nb, nb)), rows, "
    "cols, vals)\n")
TURN_CODE = TURN_HEAD + (
    "for g in (s.GRID_1M, s.GRID_8M): s.check_kernels(g, d, r)\n"
    "for g in (s.GRID_1M, s.GRID_8M): s.check_unstructured_kernels([("
    "'shuffled ' + 'x'.join(map(str, g)), s.gdia_on_device(*s.shuffled_poisson_coo_on_device("
    "g, 0, d)))], r)\n"
    "pin = s.stopping.StoppingParams(tolerance=0.0, rel_tol=0.0, min_iter=0, max_iter=200, "
    "frequency=1)\n"
    "for g in (s.GRID_1M, s.GRID_8M):\n"
    "    data, offs = s.poisson_dia(g, d); n = data.shape[1]; k = s.CgKernels(n, offs, d)\n"
    "    b = torch.randn(n, device=d, generator=torch.Generator(device=d).manual_seed(1))\n"
    "    for tag, iv in (('none', None), ('BJ', 1.0 / data[offs.index(0)])):\n"
    "        ms = s.time_turns({0: lambda: s.cg_pipelined_fused(k, data, b, torch.zeros_like(b), "
    "pin, invd=iv)}, reps=3)[0] / 200\n"
    "        print(f'  cg_pipelined_fused[{tag}] {n} rows: {ms:.4f} ms per iteration over 200, "
    "checked at each (its set-up included)')\n"
    "    ms = s.time_turns({0: lambda: s.bicgstab_fused(k, data, b, torch.zeros_like(b), pin)}, "
    "reps=3)[0] / 200\n"
    "    print(f'  bicgstab_fused {n} rows: {ms:.4f} ms per iteration over 200, checked at each "
    "(its set-up included)')\n"
    "m = s.testing.poisson_ldu(s.GRID_1M)\n"
    "rhs = np.random.default_rng(0).normal(size=m.n).astype(np.float32)\n"
    "for f, ex in s.AMG_SOLVES.items():\n"
    "    _, perf = s.foam.solve(f, m, rhs, {'executor': 'cuda', 'tolerance': s.TOL, 'relTol': 0, "
    "**ex})\n"
    "    sec = s.registry.global_registry.get(f + '_solver').time_device_solve()\n"
    "    print(f'  amg_solve {f} {m.n} cells: {perf.n_iterations} iterations, {sec * 1e3:.3f} ms "
    "on resident state (best of 3) = {sec / perf.n_iterations * 1e6:.1f} us per iteration')\n"
    "systems = {'poisson': m, 'convection-diffusion': s.testing.convection_diffusion_ldu("
    "s.GRID_1M), 'shuffled': s.testing.shuffled_poisson_ldu(s.GRID_1M)}\n"
    "for f in ('u', 'uBJ', 'uCD', 'uS'):\n"
    "    ex, system, _ = s.SLICE4_SOLVES[f]\n"
    "    _, perf = s.foam.solve(f, systems[system], rhs, {'executor': 'cuda', 'tolerance': s.TOL, "
    "'relTol': 0, **ex})\n"
    "    sec = s.registry.global_registry.get(f + '_solver').time_device_solve()\n"
    "    print(f'  gen_solve {f} ({system}) {m.n} cells: {perf.n_iterations} iterations, "
    "{sec * 1e3:.3f} ms on resident state (best of 3) = {sec / perf.n_iterations * 1e6:.2f} us "
    "per iteration')\n"
    "systems['cd'] = systems['convection-diffusion']\n"
    "for f in ('uBJ4', 'uCDBJ4', 'uCDBJ8', 'uCDBJ4Csr'):\n"
    "    system, spec, _ = s.SLICE17_SOLVES[f]\n"
    "    _, perf = s.foam.solve(f, systems[system], rhs, {'executor': 'cuda', 'tolerance': s.TOL, "
    "'relTol': 0, **spec})\n"
    "    slv = s.registry.global_registry.get(f + '_solver')\n"
    "    us = sorted(slv.time_device_solve() / perf.n_iterations * 1e6 for _ in range(3))\n"
    "    print(f'  gen_solve {f} ({system}) {m.n} cells: {perf.n_iterations} iterations; on "
    "resident state (three times the best of 3) {us[0]:.2f}, {us[1]:.2f}, {us[2]:.2f} us per "
    "iteration')\n"
    "c = s.ldu.ldu_to_coo_host(s.testing.shuffled_poisson_ldu(s.GRID_1M), dtype=np.float32)\n"
    "rows, cols, vals, nb = s.shuffled_poisson_coo_on_device(s.GRID_8M, 0, d)\n"
    "big = s.formats.Coo(rows=rows.cpu().numpy().astype(np.int32), cols=cols.cpu().numpy()"
    ".astype(np.int32), vals=vals.cpu().numpy(), shape=(nb, nb))\n"
    "s.check_unstructured_kernels([('xell 128x128x64', s.xell.xell_from_coo(c, device=d)), "
    "('xell 256x256x128', s.xell.xell_from_coo(big, c_max=9, device=d))], r)\n") + TURN_KNN + (
    "for f, pc in (('pK', 'none'), ('pKBJ', {'preconditioner': 'BJ'})):\n"
    "    _, perf = s.foam.solve(f, mk, bk, {'solver': 'GKOCG', 'executor': 'cuda', "
    "'tolerance': s.TOL, 'relTol': 0, 'preconditioner': pc})\n"
    "    sec = s.registry.global_registry.get(f + '_solver').time_device_solve()\n"
    "    print(f'  xell_solve {f} (kNN-6) {mk.n} cells: {perf.n_iterations} iterations, "
    "{sec * 1e3:.3f} ms on resident state (best of 3) = {sec / perf.n_iterations * 1e6:.2f} us "
    "per iteration')\n") + TURN_GATHER
TURN_GATHER_CODE = TURN_HEAD + TURN_KNN + TURN_GATHER  # one turn of `--turns-gather`
# one turn of `--turns-gmres`: the Arnoldi step on orthonormal rows and
# w = Vᵀc + e (arnoldi_inputs), per launch in a chain of 50 after 5 warm
# ones (the device's time: the host enqueues faster than the kernel runs)
# and around each call (time_turns); the combine at j = 100 beside torch.mv
# at 1M in five rounds (float32), in three rounds at 1M bfloat16 and at
# 8.4M (torch.mv beside the float32 basis); wK, wP and wPbf on resident state
# (time_device_solve, itself the best of three solves, three times: the
# host loop's spread)
TURN_GMRES_CODE = TURN_HEAD + (
    "g = torch.Generator(device=d).manual_seed(18)\n"
    "def chained(fn, reps=50):\n"
    "    for _ in range(5): fn()\n"
    "    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)\n"
    "    a.record()\n"
    "    for _ in range(reps): fn()\n"
    "    b.record(); b.synchronize()\n"
    "    return a.elapsed_time(b) / reps\n"
    "for n, js in ((1 << 18, (0, 12, 49, 99)), (1 << 20, (0, 12, 49, 99)), (1 << 23, (99,))):\n"
    "    for dt in (torch.float32, torch.bfloat16):\n"
    "        V, w = s.arnoldi_inputs(max(js), n, dt, d, g)\n"
    "        h = torch.zeros(max(js) + 2, device=d)\n"
    "        for j in js:\n"
    "            wk = w.clone()\n"
    "            fn = lambda: s.gmres_arnoldi(V, wk, j, h)\n"
    "            ch = chained(fn)\n"
    "            ev = s.time_turns({0: fn}, reps=50)[0]\n"
    "            print(f'  arnoldi_step {n} rows {str(dt)[6:]} j {j}: {ch:.4f} ms per launch "
    "chained, {ev:.4f} ms around each call')\n"
    "        if n >= 1 << 20:\n"
    "            y = torch.randn(100, device=d, generator=g)\n"
    "            vt = V[:100, :n].t()\n"
    "            f32 = dt == torch.float32\n"
    "            fns = {'k': lambda: s.gmres_combine(V, y, 100, n), **({'mv': lambda: torch.mv(vt, "
    "y)} if f32 else {})}\n"
    "            for rnd in range(5 if n == 1 << 20 and f32 else 3):\n"
    "                t = s.time_turns(fns)\n"
    "                mv = f', torch.mv {t[\"mv\"]:.4f} ms' if f32 else ''\n"
    "                print(f'  combine_turn {rnd} {n} rows {str(dt)[6:]} j 100: gmres_combine "
    "{t[\"k\"]:.4f} ms{mv}')\n"
    "        del V, w, wk, h\n"
    "        torch.cuda.empty_cache()\n"
    "m = s.testing.poisson_ldu(s.GRID_1M)\n"
    "rhs = np.random.default_rng(0).normal(size=m.n).astype(np.float32)\n") + TURN_KNN + (
    "for f, mm, bb in (('wK', mk, bk), ('wP', m, rhs), ('wPbf', m, rhs)):\n"
    "    _, spec, _ = s.SLICE17_SOLVES[f]\n"
    "    _, perf = s.foam.solve(f, mm, bb, {'executor': 'cuda', 'tolerance': s.TOL, "
    "'relTol': 0, **spec})\n"
    "    slv = s.registry.global_registry.get(f + '_solver')\n"
    "    us = sorted(slv.time_device_solve() / perf.n_iterations * 1e6 for _ in range(3))\n"
    "    print(f'  gmres_solve {f} {mm.n} cells: {perf.n_iterations} iterations; on resident state "
    "(three times the best of 3) {us[0]:.2f}, {us[1]:.2f}, {us[2]:.2f} us per iteration')\n")

# one turn of `--turns-tri`: kernels 1 and 2 on the Poisson grid's IC(0) and
# ILU(0) factors at 1M and 8.4M rows and on the 262,144-cell kNN-6 mesh's
# ILUT and ICT factors (RCM-numbered, as phase 12 makes it), each pair timed
# in turns (time_turns) in three rounds; then pIC, pICx, wILUx and pKICT on
# resident state (time_device_solve, itself the best of three solves, three
# times) — only what this script's earlier versions have too
TURN_TRI_CODE = TURN_HEAD + (
    "g = torch.Generator(device=d).manual_seed(21)\n"
    "def tri_rounds(label, st, r, rounds=3):\n"
    "    lo, up = st.lower, st.upper\n"
    "    fns = {'sweep': lambda: s.tri_solve.tri_sweep(lo, up, r), "
    "'levels': lambda: s.tri_solve.tri_levels(lo, up, r)}\n"
    "    for rnd in range(rounds):\n"
    "        t = s.time_turns(fns, reps=10)\n"
    "        print(f'  tri_turn {rnd} {label} {lo.n} rows (depth {lo.depth} + {up.depth}, "
    "{lo.sweeps} + {up.sweeps} sweeps): tri_sweep {t[\"sweep\"]:.4f} ms, tri_levels "
    "{t[\"levels\"]:.4f} ms')\n"
    "for dims in (s.GRID_1M, s.GRID_8M):\n"
    "    coo = s.grid_coo(dims, d)\n"
    "    r = torch.randn(coo.shape[0], device=d, generator=g)\n"
    "    f = s.ilu.ic0_factor(coo)\n"
    "    tri_rounds('IC(0)', s.ilu.state_from_factors(f[0], None, f[1], 'ic', d), r)\n"
    "    tri_rounds('ILU(0)', s.ilu.state_from_factors(*s.ilu.ilu0_factors(coo), 'lu', d), r)\n"
    "    del coo, f, r\n"
    "    torch.cuda.empty_cache()\n"
    "mo, perm = s.testing.knn_ldu(1 << 18)\n"
    "mk = s.testing.renumber_ldu(mo, np.argsort(perm))\n"
    "bk = np.random.default_rng(0).normal(size=mk.n).astype(np.float32)\n"
    "coo = s.ldu.ldu_to_coo_host(mk, dtype=np.float32)\n"
    "r = torch.randn(mk.n, device=d, generator=g)\n"
    "tri_rounds('kNN ILUT', s.ilu.state_from_factors(*s.ilu.ilut_factors(coo), 'lu', d), r)\n"
    "f = s.ilu.ict_factor(coo)\n"
    "tri_rounds('kNN ICT', s.ilu.state_from_factors(f[0], None, f[1], 'ic', d), r)\n"
    "m = s.testing.poisson_ldu(s.GRID_1M)\n"
    "rhs = np.random.default_rng(0).normal(size=m.n).astype(np.float32)\n"
    "systems = {'poisson': (m, rhs), 'cd': (s.testing.convection_diffusion_ldu(s.GRID_1M), "
    "rhs), 'knn': (mk, bk)}\n"
    "for f in ('pIC', 'pICx', 'wILUx', 'pKICT'):\n"
    "    system, spec, _ = s.SLICE20_SOLVES[f]\n"
    "    mm, bb = systems[system]\n"
    "    _, perf = s.foam.solve(f, mm, bb, {'executor': 'cuda', 'tolerance': s.TOL, "
    "'relTol': 0, **spec})\n"
    "    slv = s.registry.global_registry.get(f + '_solver')\n"
    "    us = sorted(slv.time_device_solve() / perf.n_iterations * 1e6 for _ in range(3))\n"
    "    print(f'  tri_solve {f} {mm.n} cells: {perf.n_iterations} iterations; on resident "
    "state (three times the best of 3) {us[0]:.2f}, {us[1]:.2f}, {us[2]:.2f} us per "
    "iteration')\n")

# one turn of `--turns-amg`: pKMG, gKMG and pSMG of phase 14 through
# foam.solve at 1M cells (the kNN-6 mesh RCM-numbered, the shuffled grid),
# and pMG and pGMG of phase 7 on the Poisson grid (the Dia device V-cycle),
# each on resident state (time_device_solve, itself the best of 3, three
# times) with its launches; then the Dia V-cycle's loop kernel alone on the
# Poisson grids of 1M cells and 64x64x48 (bfloat16 coefficients, CG and
# IR): the profiler's device time of pinned launches of 10 and 50
# iterations, three rounds, whose difference over 40 is its time per
# iteration; then the level smoothers of rows 27-28 on those
# solves' fine levels (the Ell sweep in bfloat16, the residual in float32,
# and the same on the Gdia level) by the profiler's device time per launch,
# the chained time and CUDA events around each call, in three rounds; then
# the pgm restriction of the kNN mesh's fine level (row 29) beside
# index_add_ the same ways — only what this script's earlier versions have
# too
TURN_AMG_CODE = TURN_HEAD + TURN_KNN + (
    "import scipy.sparse as sp\n"
    "m_shuf = s.testing.shuffled_poisson_ldu(s.GRID_1M)\n"
    "b_shuf = np.random.default_rng(0).normal(size=m_shuf.n).astype(np.float32)\n"
    "m_p = s.testing.poisson_ldu(s.GRID_1M)\n"
    "b_p = np.random.default_rng(0).normal(size=m_p.n).astype(np.float32)\n"
    "systems = {'knn': (mk, bk), 'shuffled': (m_shuf, b_shuf), 'poisson': (m_p, b_p)}\n"
    "solves = {**s.SLICE22_SOLVES, **{f: ('poisson', v) for f, v in s.AMG_SOLVES.items()}}\n"
    "ctl = {'executor': 'cuda', 'tolerance': s.TOL, 'relTol': 0, 'adaptMinIter': False}\n"
    "ops = {}\n"
    "for f in ('pMG', 'pGMG', 'pKMG', 'gKMG', 'pSMG'):\n"
    "    mesh, spec = solves[f]\n"
    "    mm, bb = systems[mesh]\n"
    "    s.kernels.reset_launches()\n"
    "    _, perf = s.foam.solve(f, mm, bb, {**ctl, **spec})\n"
    "    launched = {k: v for k, v in s.kernels.launches.items() if v}\n"
    "    slv = s.registry.global_registry.get(f + '_solver')\n"
    "    us = sorted(slv.time_device_solve() / perf.n_iterations * 1e6 for _ in range(3))\n"
    "    print(f'  amg_solve {f}: {perf.n_iterations} iterations; on resident state (three times "
    "the best of 3) {us[0]:.2f}, {us[1]:.2f}, {us[2]:.2f} us per iteration; the first solve '"
    "f'launched {launched}')\n"
    "    ops[f] = slv._precond_op\n"
    "for grid in (s.GRID_1M, s.LOOP_FIXED_GRID):\n"
    "    coo = s.ldu.ldu_to_coo_host(s.testing.poisson_ldu(grid), dtype=np.float32)\n"
    "    mat = s.formats.coo_to_dia(coo, d)\n"
    "    kern = s.CgKernels(mat.shape[0], mat.offsets, d)\n"
    "    data = kern.pack_values(mat)\n"
    "    op = s.amg.amg(coo, d, aggregation='auto', smoother_dtype=torch.bfloat16)\n"
    "    b = torch.randn(kern.n, device=d, generator=torch.Generator(device=d).manual_seed(1))\n"
    "    x0 = torch.zeros_like(b)\n"
    "    r0 = b - kern.apply(data, x0)\n"
    "    st = (torch.sum(torch.abs(r0)), s.merged_norm_factor(kern, data, r0, x0, b))\n"
    "    for name, loop in (('cg', s.amg_loop.amg_cg_loop), ('ir', s.amg_loop.amg_ir_loop)):\n"
    "        for rnd in range(3):\n"
    "            t = {k: s.device_ms_per_launch(lambda k=k: loop(kern, data, op, x0.clone(), "
    "r0.clone(), *st, s.checked_iterations(k)), reps=5) for k in (10, 50)}\n"
    "            per = 'not measured' if None in t.values() else f'{(t[50] - t[10]) / 40 * 1e3:.2f}'\n"
    "            print(f'  amg_dia_loop {rnd} {name} bf16 {kern.n} rows: device {per} us per "
    "iteration (launches of 10 and 50 pinned: {t[10]} / {t[50]} ms)')\n"
    "    del kern, data, op\n"
    "g = torch.Generator(device=d).manual_seed(23)\n"
    "def three(tag, fn):\n"
    "    for rnd in range(3):\n"
    "        dev, ch = s.device_ms_per_launch(fn), s.chain_ms(fn)\n"
    "        ev = s.time_turns({'k': fn})['k']\n"
    "        dev = 'not measured' if dev is None else f'{dev:.4f}'\n"
    "        print(f'  amg_kernel {rnd} {tag}: device {dev} ms, chained {ch:.4f} ms, around each "
    "call {ev:.4f} ms')\n"
    "for f, label in (('pKMG', 'Ell kNN 1M'), ('pSMG', 'Gdia shuffled 1M')):\n"
    "    lv = ops[f].state[0]\n"
    "    x, b = (torch.randn(lv.n, device=d, generator=g) for _ in range(2))\n"
    "    bf, f32 = lv.data_s.to(torch.bfloat16), lv.mat.vals\n"
    "    three(f'sweep[bf16] {label}', lambda: lv.kern.sweep(bf, x, b, lv.inv_diag, 0.9))\n"
    "    three(f'resid[f32] {label}', lambda: lv.kern.resid(f32, x, b))\n"
    "c = s.ldu.ldu_to_coo_host(mk, dtype=np.float32)\n"
    "agg = s.amg.pgm_aggregate(sp.csr_matrix((c.vals, (c.rows, c.cols)), shape=c.shape))\n"
    "tr = s.amg_level.PgmTransfer(agg, int(agg.max()) + 1, d)\n"
    "rr = torch.randn(tr.n, device=d, generator=g)\n"
    "agg64 = tr.agg.long()\n"
    "three(f'pgm_restrict kNN 1M into {tr.nc}', lambda: tr.restrict(rr))\n"
    "three(f'index_add_ kNN 1M into {tr.nc}', lambda: torch.zeros(tr.nc, device=d)"
    ".index_add_(0, agg64, rr))\n")

# one turn of `--turns-step`: the steady step at 1M through foam.solve, the
# Poisson grid as Dia and the kNN-6 mesh as Csr, three diag-only and three
# all-block steps each (b changed too), with `uploadPrecision bfloat16` where
# the tree has it; each step's wall and phase split
TURN_STEP_CODE = TURN_HEAD + TURN_KNN + (
    "import dataclasses, time\n"
    "mp = s.testing.poisson_ldu(s.GRID_1M)\n"
    "bp = np.random.default_rng(0).normal(size=mp.n).astype(np.float32)\n"
    "base = {'solver': 'GKOCG', 'executor': 'cuda', 'tolerance': s.TOL, 'relTol': 0}\n"
    "def nud(mm, k, blocks):\n"
    "    f = np.float32(1.0 + 1e-7 * k)\n"
    "    return dataclasses.replace(mm, **{n: np.asarray(getattr(mm, n)) * f for n in blocks})\n"
    "for sysname, mm, bb, fmt in (('poisson Dia', mp, bp, 'Dia'), ('kNN Csr', mk, bk, 'Csr')):\n"
    "    for up in ('default', 'bfloat16'):\n"
    "        ctl = {**base, 'matrixFormat': fmt, 'uploadPrecision': up}\n"
    "        field = 'st' + fmt + up\n"
    "        try:\n"
    "            s.foam.solve(field, mm, bb, ctl)\n"
    "        except NotImplementedError as e:\n"
    "            print(f'  step_turn {sysname} {up}: not in this tree ({e})')\n"
    "            continue\n"
    "        slv = s.registry.global_registry.get(field + '_solver')\n"
    "        for kind, blocks, k0 in (('diag-only', ('diag',), 0), ('all-block', ('diag', 'upper'), 10)):\n"
    "            for k in range(1, 4):\n"
    "                bkk = (bb * np.float32(1.0 + 1e-7 * (k + k0))).astype(np.float32)\n"
    "                mkk = nud(mm, k + k0, blocks)\n"
    "                torch.cuda.synchronize()\n"
    "                t0 = time.perf_counter()\n"
    "                _, perf = s.foam.solve(field, mkk, bkk, ctl)\n"
    "                torch.cuda.synchronize()\n"
    "                wall = time.perf_counter() - t0\n"
    "                split = ', '.join(f'{a} {v * 1e3:.3f}' for a, v in sorted(slv.last_timings.items()))\n"
    "                print(f'  step_turn {sysname} {up} {kind} {k}: wall {wall * 1e3:.3f} ms = {split} ms; '\n"
    "                      f'{perf.n_iterations} iterations; uploaded {slv.last_blocks_uploaded}, '\n"
    "                      f'{slv.last_upload_bytes} bytes')\n"
    "        s.registry.global_registry.clear()\n")

TURN_LINES = ("step_turn", "dia_spmv ", "cg_k2 ", "cg_k2i ", "cg_k2n ", "gdia_k1 ", "gdia_spmv ", "cg_loop",
              "cg_ka", "cg_kb_pipe", "cg_pipe", "bicgstab", "amg_", "gen_solve", "xell_",
              "gather_solve", "ell_spmv", "hybrid_spmv", "csr_spmv", "sell_spmv", "torch CSR",
              "arnoldi_step", "combine_turn", "gmres_solve", "tri_turn", "tri_solve")


def turns(trees, code=TURN_CODE) -> int:
    """Phase 3's kernel checks and the rest of `code` (TURN_CODE, or
    TURN_GATHER_CODE for `--turns-gather`, TURN_GMRES_CODE for
    `--turns-gmres`, TURN_TRI_CODE for `--turns-tri`) from each checkout of `trees` in
    order, one process each, run from that checkout (so with its own
    kernels): give an earlier commit unpacked with `git archive` and this
    one, as `--turns PARENT . . PARENT`, to time both on one card in turns.
    Each turn's whole output is printed, then every turn's kernel lines
    again as a summary."""
    print(card_line())
    summary, rc = [], 0
    for i, tree in enumerate(trees, 1):
        res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        print(f"== turn {i} ({tree}) rc={res.returncode}\n{res.stdout}{res.stderr}")
        summary.append(f"turn {i} ({tree}) rc={res.returncode}")
        summary += [line[:240] for line in res.stdout.splitlines()
                    if line.lstrip().startswith(TURN_LINES)]
        rc = res.returncode
        if rc != 0:
            break
    print("\n".join(summary))
    return rc


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--turns"]:
        return turns(sys.argv[2:])
    if sys.argv[1:2] == ["--turns-gather"]:
        return turns(sys.argv[2:], TURN_GATHER_CODE)
    if sys.argv[1:2] == ["--turns-gmres"]:
        return turns(sys.argv[2:], TURN_GMRES_CODE)
    if sys.argv[1:2] == ["--turns-tri"]:
        return turns(sys.argv[2:], TURN_TRI_CODE)
    if sys.argv[1:2] == ["--turns-amg"]:
        return turns(sys.argv[2:], TURN_AMG_CODE)
    if sys.argv[1:2] == ["--turns-step"]:
        return turns(sys.argv[2:], TURN_STEP_CODE)
    return run(torch.device("cuda"), GRID_1M, GRID_8M, KNN_1M)


def run(device, grid_main, grid_big, knn_n) -> int:
    t_ph = time.perf_counter()
    print("== phase 1: device")
    print(card_line())
    cc = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"sm_{cc[0]}{cc[1]} count {torch.cuda.device_count()}")
    if cc != (9, 0):
        raise RuntimeError(f"compute capability {cc}: the kernels are built for sm_90a")

    t_ph = phase_done("phase 1", t_ph)
    print("== phase 2: build")
    info = _build.build_info()
    print(f"built={info['built']} in {info['seconds']:.2f} s -> {info['path']}")
    nvcc_s = sorted(((float(sec), name) for name, sec in (
        line.split()[2:4] for line in info["log"].splitlines()
        if line.startswith("nvcc seconds: "))), reverse=True)
    print("nvcc wall seconds per source (all started together), slowest first: "
          + ", ".join(f"{name} {sec:.1f}" for sec, name in nvcc_s))
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probe = CgKernels(1, (0,), device)
    for variant, what in LOOP_VARIANTS.items():
        blocks = probe.loop_blocks(variant)
        print(f"cg_loop grid, {what} (cg_loop_kernel<{variant}>): {blocks} co-resident blocks "
              f"of {LOOP_THREADS} threads ({blocks // sms} per SM on {sms} SMs); ptxas: "
              + "; ".join(loop_ptxas(info["log"], variant)))
    probe_x = xell.XellCgKernels(xell.XellPlan(1, 1, 1, 0, xell.spill_csr([], [], 1, device)))
    for variant, what in XELL_LOOP_VARIANTS.items():
        blocks = probe_x.loop_blocks(variant)
        print(f"xell_cg_loop grid, {what} (xell_cg_loop_kernel<{variant}>): {blocks} co-resident "
              f"blocks of {LOOP_THREADS} threads with the 59,392-byte ring ({blocks // sms} per "
              f"SM on {sms} SMs); ptxas: "
              + "; ".join(loop_ptxas(info["log"], variant, "xell_cg_loop_kernel")))
    for variant, what in PIPE_LOOP_VARIANTS.items():
        blocks = probe.pipe_loop_blocks(variant)
        print(f"cg_pipe_loop grid, {what} (cg_pipe_loop_kernel<{variant}>): {blocks} co-resident "
              f"blocks of {LOOP_THREADS} threads ({blocks // sms} per SM on {sms} SMs); ptxas: "
              + "; ".join(loop_ptxas(info["log"], variant, "cg_pipe_loop_kernel")))
    blocks = probe.bicgstab_loop_blocks()
    print(f"bicgstab_loop grid (bicgstab_loop_kernel): {blocks} co-resident blocks of "
          f"{LOOP_THREADS} threads ({blocks // sms} per SM on {sms} SMs); ptxas: "
          + "; ".join(loop_ptxas(info["log"], None, "bicgstab_loop_kernel")))
    for variant, what in GEN_LOOP_VARIANTS.items():
        blocks = probe.gen_loop_blocks(variant)
        print(f"bicgstab_gen_loop grid, {what} (bicgstab_gen_loop_kernel<{variant}>): {blocks} "
              f"co-resident blocks of {LOOP_THREADS} threads ({blocks // sms} per SM on {sms} "
              "SMs); ptxas: " + "; ".join(loop_ptxas(info["log"], variant,
                                                     "bicgstab_gen_loop_kernel")))
    for variant, what in AMG_LOOP_VARIANTS.items():
        blocks = amg_loop.loop_blocks(variant, device)
        print(f"amg_loop grid, {what} (amg_loop_kernel<{variant}>): {blocks} co-resident blocks "
              f"of {LOOP_THREADS} threads ({blocks // sms} per SM on {sms} SMs); ptxas: "
              + "; ".join(loop_ptxas(info["log"], variant, "amg_loop_kernel")))

    t_ph = phase_done("phase 2", t_ph)
    print("== phase 3: kernels vs plain versions "
          f"(vector tol {VEC_RTOL:.0e}*max(1,max|plain|), sum rtol {SUM_RTOL:.0e})")
    report: dict = {}
    for dims in (grid_main, grid_big):
        check_kernels(dims, device, report)
    data, offsets = poisson_dia(LOOP_FIXED_GRID, device)
    check_dia_loops(data, offsets, "x".join(map(str, LOOP_FIXED_GRID)), report)
    del data
    print("the AMG loop kernel vs its plain twins (x after "
          f"{AMG_LOOP_CHECK} iterations within {AMG_LOOP_RTOL:.0e}*max(1,max|plain|)):")
    check_amg_loops(grid_main, device, report)
    check_amg_loops(LOOP_FIXED_GRID, device, report, dtypes=(torch.bfloat16,))
    check_gdia((grid_main, grid_big), device, report)

    t_ph = phase_done("phase 3", t_ph)
    print("== phase 4: slice 1's path, foam.solve at "
          f"{'x'.join(map(str, grid_main))} = {int(np.prod(grid_main))} cells")
    t0 = time.perf_counter()
    m = testing.poisson_ldu(grid_main)
    b = np.random.default_rng(0).normal(size=m.n).astype(np.float32)
    print(f"LDU system built on the host in {time.perf_counter() - t0:.2f} s")
    ctl = {"solver": "GKOCG", "executor": "cuda", "tolerance": TOL, "relTol": 0,
           "verbose": 1}
    pcs = {"p": "none", "pBJ": {"preconditioner": "BJ"}}
    registry.global_registry.clear()
    kernels.reset_launches()
    solves = {}
    for field, pc in pcs.items():
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x, perf = foam.solve(field, m, b, {**ctl, "preconditioner": pc})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf.print()
        print(f"{field}: first solve wall {wall:.3f} s")
        check_loop_solve_launches(field, before)
        solves[field] = (x, perf)

    t_ph = phase_done("phase 4 (solves)", t_ph)
    print("== phase 5: steady-state steps (diag x1.01, new b) on field p")
    steps = []
    m_k, b_k = m, b
    for k in (2, 3):  # step 2 also builds the value map once; step 3 is steady
        m_k = dataclasses.replace(m_k, diag=np.asarray(m_k.diag) * 1.01)
        b_k = (b_k * 1.01 + 0.1).astype(np.float32)
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        x_k, perf_k = foam.solve("p", m_k, b_k, {**ctl, "preconditioner": "none"})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        perf_k.print()
        check_loop_solve_launches(f"p step {k}", before)
        slv = registry.global_registry.get("p_solver")
        lt = slv.last_timings
        print(f"p step {k}: wall {wall * 1e3:.3f} ms, of which update "
              f"{lt.get('update_device_values', 0.0) * 1e3:.3f} ms and solve "
              f"{lt.get('solve', 0.0) * 1e3:.3f} ms; blocks uploaded "
              f"{slv.last_blocks_uploaded}, {slv.last_upload_bytes} bytes, rhs uploaded "
              f"{slv.last_rhs_uploaded}")
        if slv.last_blocks_uploaded != (1, 2) or not slv.last_rhs_uploaded:
            raise RuntimeError(f"step {k} uploaded more than the diag block + RHS")
        steps.append((f"p step {k}", x_k, perf_k, torch.tensor(b_k, device=device),
                      slv.matrix.data.clone()))
    launches = {k: kernels.launches[k] for k in SLICE1_KERNELS}
    print(f"launch counts over slice 1's path: {dict(kernels.launches)}")

    # ---- checks of the main path --------------------------------------
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"slice 1's path never launched {missing}")
    offsets = slv.matrix.offsets
    data_ref, offs_ref = poisson_dia(grid_main, device)
    if offsets != offs_ref or not torch.equal(
            registry.global_registry.get("pBJ_solver").matrix.data, data_ref):
        raise RuntimeError("the Dia data of the LDU path differs from the analytic stencil")
    b_dev = torch.tensor(b, device=device)
    checks = [("p", solves["p"][0], solves["p"][1], b_dev, data_ref, None),
              ("pBJ", solves["pBJ"][0], solves["pBJ"][1], b_dev, data_ref,
               1.0 / data_ref[offsets.index(0)]),
              *((name, x, perf, bb, dd, None) for name, x, perf, bb, dd in steps)]
    params = stopping.StoppingParams(tolerance=TOL, rel_tol=0.0, min_iter=0,
                                     max_iter=1000, frequency=1)
    for name, x, perf, bb, dd, invd in checks:
        if not (perf.converged and perf.final_residual < TOL):
            raise RuntimeError(f"{name}: did not converge: {perf}")
        if x.shape != (m.n,) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{name}: solution not finite of shape ({m.n},)")
        tr = true_residual(dd, offsets, x, bb)
        line = (f"{name}: iterations {perf.n_iterations}, final residual "
                f"{perf.final_residual:.3e}, true float64 residual {tr:.3e} "
                f"(limit {TRUE_RESIDUAL_MARGIN:g} x {TOL:g})")
        if not name.startswith("p step"):  # steps run adapted (minIter/frequency)
            plain = cg_fused(PlainCgKernels(m.n, offsets, device), dd, bb,
                             torch.zeros_like(bb), params, invd=invd)
            line += f"; plain-kernel merged CG on the card: {plain.iters} iterations"
            if abs(plain.iters - perf.n_iterations) > 1:
                raise RuntimeError(f"{name}: {perf.n_iterations} iterations vs "
                                   f"{plain.iters} with the plain kernels")
        if name == "p" and abs(perf.n_iterations - P_ITERS) > 1:
            raise RuntimeError(f"p: {perf.n_iterations} iterations, not {P_ITERS} +- 1")
        print(line)
        if tr > TRUE_RESIDUAL_MARGIN * TOL:
            raise RuntimeError(f"{name}: true residual {tr:.3e} above the limit")

    t_ph = phase_done("phase 5 and phase 4's checks", t_ph)
    print("== phase 6: where the time goes (torch.profiler over one more step)")
    m_k = dataclasses.replace(m_k, diag=np.asarray(m_k.diag) * 1.01)
    b_k = (b_k * 1.01 + 0.1).astype(np.float32)
    profile_step(lambda: foam.solve("p", m_k, b_k, {**ctl, "preconditioner": "none"}))

    t_ph = phase_done("phase 6", t_ph)
    launches_amg = amg_path(m, b, device, {**ctl, "verbose": 0})
    t_ph = phase_done("phase 7", t_ph)
    launches_un, report_un, knn_system = unstructured_path(device, knn_n, grid_main, grid_big,
                                                           ctl)
    report.update(report_un)
    t_ph = phase_done("phase 8", t_ph)
    launches_4 = slice4_path(m, b, grid_main, device, ctl,
                             {k: v[1].n_iterations for k, v in solves.items()})
    t_ph = phase_done("phase 9", t_ph)
    launches_5, peaks = bench_path(device, grid_main, grid_big, report)
    t_ph = phase_done("phase 10", t_ph)
    launches_14, report_14 = gather_path(device, *knn_system, m, b, grid_main, grid_big, ctl)
    report.update(report_14)
    t_ph = phase_done("phase 11", t_ph)
    launches_17, report_17, knn_small = slice17_path(device, *knn_system, m, b, grid_main,
                                                     grid_big, ctl)
    report.update(report_17)
    t_ph = phase_done("phase 12", t_ph)
    launches_20, report_20 = slice20_path(device, *knn_small, m, b, grid_main, grid_big, ctl)
    report.update(report_20)
    t_ph = phase_done("phase 13", t_ph)
    launches_22, report_22 = slice22_path(device, *knn_system, knn_small, grid_main, ctl)
    report.update(report_22)
    t_ph = phase_done("phase 14", t_ph)
    launches_24, report_24 = slice24_path(device, m, b, *knn_system, grid_main, grid_big, ctl)
    report.update(report_24)
    phase_done("phase 15", t_ph)

    rows = []
    paths = (launches, launches_amg, launches_un, launches_4, launches_5, launches_14,
             launches_17, launches_20, launches_22, launches_24)
    labels = {None: "x".join(map(str, grid_main)), "big": "x".join(map(str, grid_big))}
    for name, (route, source, replaces, case, label) in KERNELS.items():
        r = report[case][labels.get(label, label)]
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     "launches": sum(path.get(name, 0) for path in paths),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                     "read_peak_share": r["gbps"] / peaks["read_gbps"],
                     **({"stored_bytes_per_row": r["stored_bytes_per_row"]}
                        if "stored_bytes_per_row" in r else {}),
                     "cases": {k: v for k, v in report.items()
                               if k == name or k.startswith(name + "[")}})
    print(json.dumps({"kernels": rows, "read_peak_gbps": {
        "events": peaks["read_gbps"], "device": peaks["read_device_gbps"]}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

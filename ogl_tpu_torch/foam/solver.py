"""The OpenFOAM-facing solver layer of the port: one persistent FoamSolver
per field, orchestrated like the reference's lduLduBase.

Counterpart: ogl_tpu/foam/solver.py.

  first solve:   LDU sparsity (→ RCM renumbering under `reorder rcm`) →
                 the matrix format on the device (raw LDU blocks left
                 resident) → preconditioner → merged-kernel CG (Dia, Gdia,
                 Xell) or the general loop over the format's SpMV
  steady state:  per-block change detection → only the changed blocks
                 cross to the device (full width, or under `uploadPrecision
                 bfloat16` as an error-feedback bfloat16 delta) → one launch
                 of the value-update kernel (kernels/value_update.py): a
                 partial change writes only its blocks' entries through
                 their plans (core/formats.py `block_update_plans`; the LDU
                 diag onto the Dia main plane is one contiguous run), any
                 other change every block's → preconditioner regeneration
                 gated on a changed operator and the TTL → merged-kernel CG

Slices implemented: GKOCG, GKOBiCGStab and GKOGMRES with preconditioner
`none`, `BJ` (scalar, or blocked up to maxBlockSize 32), `ISAI`, `GISAI`,
`ILU`, `ILUT`, `IRILU`, `IC`, `ICT` or `Multigrid` (AMG), and GKOMultigrid
(Richardson around one AMG cycle or another preconditioner); float32, one
device.  Without an explicit matrixFormat the
matrix takes the reference's format ladder (kernels/spmv.py `pack_fast`):
Dia, else Gdia, else Xell, else Ell (under 32,768 rows; above, the
reference's error); an explicit matrixFormat (Coo, Csr, Ell, Sell, Dia,
Gdia, Hybrid, Xell) is honoured.  AMG (Multigrid, GKOMultigrid) runs on
any format, over a hierarchy of Dia, Gdia and Ell levels picked as the
reference picks them.  Every control outside the slices raises
NotImplementedError naming its ROADMAP.md item; none is silently ignored.

Routing follows the reference's `_make_solve_fn`.  "Scalar BJ" below is
`BJ` with maxBlockSize 1; a blocked BJ applies through the block-Jacobi
kernel (in GKOBiCGStab's loop kernel, through its block-Jacobi phases),
ISAI/GISAI through the SpMV kernels of M (and Mᵀ), on a host loop:
  GKOCG                merged two-kernel CG on Dia, Gdia and Xell for
                       `none`, scalar `BJ` or Multigrid (CgKernels,
                       GdiaCgKernels, XellCgKernels; `none` or scalar `BJ`
                       on the card: one launch of the format's loop kernel);
                       every other format or preconditioner, or `fusedCG
                       false` → the general CG (solve/cg.py) over the
                       format's SpMV kernel, which on Ell, Hybrid, Coo, Csr
                       and Sell with `none` or scalar `BJ` on the card is
                       one launch of the CG loop kernel's variant of the
                       format (EllCgKernels, CsrCgKernels — Coo too —,
                       SellCgKernels; a Csr of 16 or more entries per row
                       on mean keeps the host loop)
  GKOCG pipelinedCG    Dia with `none`/scalar `BJ` → the merged pipelined CG
                       (KA + KB_pipe, solve/cg_pipe_fused.py; on the card
                       one launch of its loop kernel); Gdia, Xell, another
                       preconditioner or `fusedCG false` → the general
                       pipelined CG (solve/cg_pipe.py); so do Coo, Csr,
                       Ell, Sell and Hybrid
  GKOBiCGStab          the general BiCGStab (solve/bicgstab.py): with
                       `none`, scalar `BJ` or blocked `BJ` (the state's
                       inverses passed as inv_t) one launch of its loop
                       kernel on the card (on every format, bar a Csr of 16
                       or more entries per row on mean), else (ISAI, GISAI,
                       the ILU family, Multigrid) the host loop over the
                       format's SpMV kernel; `fusedBiCGStab true` with `none` on Dia
                       → the merged BiCGStab (K1B, K1B, KB_update;
                       solve/bicgstab_fused.py; on the card one launch of
                       its loop kernel)
  GKOGMRES             restarted GMRES (solve/gmres.py): a host loop, each
                       Arnoldi step the format's SpMV over M⁻¹ v, one launch
                       of the Arnoldi kernel and one read of h; `krylovDim`,
                       `basisPrecision bfloat16`
  GKOMultigrid         Richardson around one AMG cycle (solve/ir.py
                       `ir_fused` on the plan of Dia, Gdia, Ell, Hybrid,
                       Csr or Coo; on Xell and Sell `ir` over the format's
                       SpMV kernel)
GKOCG + Multigrid (merged on Dia and Gdia, the general CG on Ell, Hybrid,
Csr and Coo) and GKOMultigrid on those formats run their whole solve,
V-cycle included, as one launch of the AMG loop kernel on the card when
the hierarchy qualifies (kernels/amg_loop.py: cycle v, Dia, Gdia and Ell
levels, grid or natural transfers, a dense coarse inverse); otherwise the
host launches the cycle — on Xell inside the merged CG (the format's K1,
K2n), on Sell inside the general CG, and on every format for pgm, cycle w
or f and a coarse CG.
The reference's TPU-only route gates (Pallas usability, the 32k-row floor
of the merged kernels, the f32-frame test, the working-set gate of the
z-free variant, the frame geometry its framed AMG must share) are not
carried over: every solve takes its route on either device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ogl_tpu_torch import __version__ as _version
from ogl_tpu_torch import common, device_for, precond, registry
from ogl_tpu_torch.config import SolverConfig, parse_controls
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.core.reorder import rcm_permutation
from ogl_tpu_torch.kernels import amg_loop, spmv
from ogl_tpu_torch.kernels.block_jacobi import MAX_BLOCK
from ogl_tpu_torch.kernels.ell import EllCgKernels
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels, SellCgKernels
from ogl_tpu_torch.kernels.fused import CgKernels, GdiaCgKernels
from ogl_tpu_torch.kernels.gdia import Gdia, gdia_from_coo
from ogl_tpu_torch.kernels.value_update import Write, value_update
from ogl_tpu_torch.kernels.xell import Xell, XellCgKernels, xell_from_coo
from ogl_tpu_torch.solve import stopping
from ogl_tpu_torch.solve.bicgstab import bicgstab
from ogl_tpu_torch.solve.bicgstab import why_not as bicgstab_why_not
from ogl_tpu_torch.solve.bicgstab_fused import bicgstab_fused
from ogl_tpu_torch.solve.cg import cg
from ogl_tpu_torch.solve.cg import gather_why_not
from ogl_tpu_torch.solve.cg import why_not as cg_why_not
from ogl_tpu_torch.solve.cg_fused import cg_fused
from ogl_tpu_torch.solve.cg_pipe import cg_pipelined
from ogl_tpu_torch.solve.cg_pipe_fused import cg_pipelined_fused
from ogl_tpu_torch.solve.gmres import gmres
from ogl_tpu_torch.solve.ir import ir, ir_fused
from ogl_tpu_torch.solve.krylov import single_device_ops

__all__ = ["SolverPerformance", "FoamSolver", "solve", "unsupported"]

# the explicit matrixFormat converters (the reference's _FORMAT_CONVERTERS)
_CONVERTERS = {"Coo": formats.coo_to_device, "Csr": formats.coo_to_csr,
               "Ell": formats.coo_to_ell, "Dia": formats.coo_to_dia,
               "Sell": formats.coo_to_sell, "Gdia": gdia_from_coo,
               "Hybrid": formats.coo_to_hybrid, "Xell": xell_from_coo}
# the gather formats' loop plans (a DeviceCoo is a Csr by its storage)
_GATHER_PLANS = {formats.Ell: EllCgKernels, formats.Hybrid: EllCgKernels,
                 formats.Csr: CsrCgKernels, formats.DeviceCoo: CsrCgKernels,
                 formats.Sell: SellCgKernels}
# the formats of the merged routes, each with its merged-CG plan
_MERGED_FORMATS = (formats.Dia, Gdia, Xell)


class SolverPerformance(NamedTuple):
    """What OpenFOAM's solverPerformance reports back into the log."""

    solver_name: str
    field_name: str
    initial_residual: float
    final_residual: float
    n_iterations: int
    converged: bool

    def print(self):  # OpenFOAM log line format
        print(
            f"{self.solver_name}:  Solving for {self.field_name}, "
            f"Initial residual = {self.initial_residual:g}, "
            f"Final residual = {self.final_residual:g}, "
            f"No Iterations {self.n_iterations}"
        )


def unsupported(cfg: SolverConfig) -> str | None:
    """Why the port cannot run `cfg` yet (naming the ROADMAP.md item that
    ports it), or None when the slice covers it."""
    pc = cfg.precond
    if cfg.solver not in ("GKOCG", "GKOBiCGStab", "GKOGMRES", "GKOMultigrid"):
        return f"solver {cfg.solver} (ROADMAP.md A9)"
    if pc.name == "BJ" and pc.max_block_size > MAX_BLOCK:
        return (f"BJ maxBlockSize {pc.max_block_size} (the block-Jacobi kernel takes at most "
                f"{MAX_BLOCK}; ROADMAP.md A10)")
    if pc.name != "none" and pc.value_precision == "bfloat16":
        return "preconditioner precision bfloat16 (ROADMAP.md A10)"
    if cfg.dtype != "float32":
        return f"dtype {cfg.dtype} (ROADMAP.md A14)"
    if cfg.export or cfg.debug:
        return "export/debug (ROADMAP.md A15)"
    return None


def _mesh_xell(coo: formats.Coo, device, ladder):
    """The field's Xell, with the packing (`xell_layout`, seconds at 1M)
    another field on the same sparsity took: the fields of one mesh share
    it.  The registry keeps one entry per (n, nnz): the sparsity, its
    layout and whether the format ladder chose Xell for it; a hit needs the
    rows and columns equal entry by entry.  `ladder` (None: an explicit
    Xell) returns the ladder's format, Xell or another, which a hit from
    the ladder skips, since the ladder's pick is a function of the sparsity
    alone."""
    store = registry.global_registry.get_or_init("xell_layouts", dict)
    key = (coo.shape[0], len(coo.rows))
    hit = store.get(key)
    if hit is not None and not (np.array_equal(hit[0], coo.rows)
                                and np.array_equal(hit[1], coo.cols)):
        hit = None
    if hit is not None and (ladder is None or hit[3]):
        return xell_from_coo(coo, device=device, layout=hit[2])
    mat = xell_from_coo(coo, device=device) if ladder is None else ladder()
    if isinstance(mat, Xell):
        store[key] = (coo.rows, coo.cols, mat.layout, ladder is not None)
    return mat


def _diag_pc(cfg: SolverConfig) -> bool:
    """`none` or scalar Jacobi: the preconditioners the merged kernels and
    the loop kernels apply themselves (the reference's `diag_pc`)."""
    pc = cfg.precond
    return pc.name == "none" or (pc.name == "BJ" and pc.max_block_size == 1)


def _route(cfg: SolverConfig, matrix) -> str:
    """The solve route of `cfg` on `matrix` (the reference's
    `_make_solve_fn`, foam/solver.py:624-748, without its TPU-only gates):
    "cg_fused", "cg", "cg_pipe_fused", "cg_pipe", "bicgstab_fused",
    "bicgstab", "gmres" or "ir".  Only Dia, Gdia and Xell take a merged
    route, and only with `none`, scalar `BJ` or Multigrid (foam/solver.py:
    651-678 there: `diag_pc or amg_framed`)."""
    diag_pc = _diag_pc(cfg)
    dia = isinstance(matrix, formats.Dia)
    if cfg.solver == "GKOMultigrid":
        return "ir"
    if cfg.solver == "GKOGMRES":
        return "gmres"
    if cfg.solver == "GKOBiCGStab":
        fused = cfg.fused_bicgstab and cfg.precond.name == "none" and dia
        return "bicgstab_fused" if fused else "bicgstab"
    if cfg.pipelined_cg:
        return "cg_pipe_fused" if cfg.fused_cg and diag_pc and dia else "cg_pipe"
    merged = isinstance(matrix, _MERGED_FORMATS) and (diag_pc or cfg.precond.name == "Multigrid")
    return "cg_fused" if cfg.fused_cg and merged else "cg"


def _res_eval_seconds(mv, x, b, device: torch.device, k: int = 8) -> float:
    """Seconds per residual-norm evaluation ‖b − A x‖₁ — the criterion's
    per-check cost that adaptMinIter weighs (lduLduBase.H:287-293).  On
    CUDA the k chained evaluations are timed with CUDA events around the
    format's SpMV kernel; on the host with the wall clock.  Measured on every
    solve, as OGL does (the JAX reference measures once per solver)."""
    def f():
        return torch.sum(torch.abs(b - mv(x)))

    f()  # warm
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            f()
        end.record()
        end.synchronize()
        return max(start.elapsed_time(end) * 1e-3, 1e-12) / k
    t0 = time.perf_counter()
    for _ in range(k):
        f()
    return max(time.perf_counter() - t0, 1e-12) / k


class FoamSolver:
    """Per-field persistent solver (stored in the registry by field name)."""

    def __init__(self, field_name: str, controls: dict | SolverConfig):
        self.field = field_name
        self.cfg = controls if isinstance(controls, SolverConfig) else parse_controls(controls)
        why = unsupported(self.cfg)
        if why is not None:
            raise NotImplementedError(f"{field_name}: {why} is not ported to ogl_tpu_torch yet")
        self.device = device_for(self.cfg.executor)
        self.dtype = torch.float32
        self.np_dtype = np.float32
        self.sparsity: ldu.LduSparsity | None = None
        self.matrix = None  # the container of the format the first solve took
        self.kern: CgKernels | XellCgKernels | None = None  # the merged routes' plan
        self.route = ""  # _route() of the matrix the first solve converted
        self._n = 0
        self._coeff_epoch = 0
        self._reorder = None  # (perm, inv, rows, cols, entry_order) under rcm
        self._inv_dev = None
        self._value_map = None
        self._block_plans = None  # per-block plans (None: slots take several entries)
        self._acc_plan = None  # the whole update's slot-sorted plan where plans are None
        self._coo_host_cache = None
        self._blocks_host = None  # raw LDU source blocks of the last update
        self._blocks_prev = None  # private copies backing the delta compare
        self._blocks_dev = None  # device-resident per-block uploads
        self._blocks_stale = None  # device copy out of date vs host values
        self._blocks_mirror = None  # uploadPrecision bfloat16: the device values on the host
        self._b_prev = None
        self._b_dev = None
        self._b_mirror = None
        self._precond_op = None
        self._pc_built_epoch = None
        self._res_eval_time = 0.0
        self._redispatch = None  # the last solve's route over its resident state
        self.last_blocks_changed = (0, 0)
        self.last_blocks_uploaded = (0, 0)
        self.last_blocks_bf16 = (0, 0)  # of the uploaded blocks, those sent as bf16 deltas
        self.last_upload_bytes = 0
        self.last_rhs_uploaded = False
        self.last_rhs_bf16 = False
        self.last_timings: dict = {}
        self.props = registry.global_registry.properties(field_name)
        self.timings = common.Timings()

    def _timed(self, name: str):
        return common.timed(name, self.cfg.verbose, self.field, self.timings,
                            self.device)

    # -- matrix ---------------------------------------------------------
    def _convert(self, coo: formats.Coo):
        """First-solve conversion.  An explicit matrixFormat is honoured;
        otherwise the reference's ladder picks the format (Dia → Gdia →
        Xell → Ell).  A matrix of at least 32,768 rows that lands on Ell
        raises the reference's error; under that it solves on Ell."""
        fmt = self.cfg.matrix_format
        n = coo.shape[0]
        if self.cfg.matrix_format_explicit:
            if fmt == "Xell":
                return _mesh_xell(coo, self.device, None)
            return _CONVERTERS[fmt](coo, device=self.device)
        mat = _mesh_xell(coo, self.device, lambda: spmv.pack_fast(
            coo.rows, coo.cols, coo.vals, n, presorted=True, device=self.device))
        eff = formats.format_name(mat)
        if eff == "Ell" and n >= spmv.XELL_MIN_ROWS:
            raise RuntimeError(
                f"{self.field}: no fast-path format covers this {n}-row matrix "
                "(Dia/Gdia/Xell all rejected it); the reference refuses its gather "
                "Ell tier at this size.  Renumber the mesh (reorder: rcm) to reduce "
                "bandwidth, or set matrixFormat Ell explicitly to solve on Ell.")
        if eff != fmt:
            common.log(self.cfg.verbose, 0,
                       f"{self.field}: matrixFormat auto-routed {fmt} -> {eff} "
                       "(fast path; set matrixFormat explicitly to override)")
        return mat

    def _kernel_plan(self):
        """The merged-CG plan of the format the matrix took (Dia, Gdia or
        Xell; no other format has one)."""
        m = self.matrix
        if isinstance(m, Gdia):
            return GdiaCgKernels(self._n, m.plane_offsets, self.device)
        if isinstance(m, Xell):
            return XellCgKernels.for_matrix(m)
        if isinstance(m, formats.Dia):
            return CgKernels(self._n, m.offsets, self.device)
        raise TypeError(f"no merged-CG plan for the {formats.format_name(m)} format")

    def _amg_outer_plan(self, merged: bool):
        """The plan the AMG loop kernel takes as its outer operator
        (kernels/amg_loop.py OUTER_PLANS: Dia and Gdia where `merged` —
        GKOMultigrid; the general GKOCG + Multigrid on them is `fusedCG
        false`, which keeps its host loop —, Ell and Hybrid, Csr and Coo), or
        None (Xell, Sell, a Csr whose SpMV takes more than one lane per
        row)."""
        m = self.matrix
        if isinstance(m, (formats.Dia, Gdia)):
            return self._kernel_plan() if merged else None
        plan = _GATHER_PLANS.get(type(m))
        if plan in amg_loop.OUTER_PLANS and gather_why_not(m) is None:
            return plan.for_matrix(m)
        return None

    def _init_reorder(self) -> None:
        """`reorder rcm`: the RCM permutation of the sparsity and the
        renumbered row-major structure (the reference's renumberMesh
        analogue, ogl_tpu/foam/solver.py:258-278).  b and the initial guess
        are permuted in on entry, x out on exit."""
        sp = self.sparsity
        n = sp.n
        perm = rcm_permutation(formats.Coo(rows=sp.rows, cols=sp.cols,
                                           vals=np.zeros(sp.nnz, np.float32), shape=(n, n)))
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        rp = inv[sp.rows]
        cp = inv[sp.cols]
        entry_order = np.lexsort((cp, rp))
        self._reorder = (perm, inv, rp[entry_order].astype(np.int32),
                         cp[entry_order].astype(np.int32), entry_order)
        self._inv_dev = torch.tensor(inv, device=self.device)

    def _update_matrix(self, m: ldu.LduMatrix):
        cfg = self.cfg
        first = self.sparsity is None
        if first:
            with self._timed("init_host_sparsity"):
                self.sparsity = ldu.build_local_sparsity(m)
            if cfg.reorder == "rcm":
                with self._timed("reorder"):
                    self._init_reorder()
            elif cfg.reorder != "none":
                raise ValueError(f"unknown reorder {cfg.reorder!r}; use none|rcm")
        if not (first or cfg.update_sys_matrix):
            return
        with self._timed("update_local_matrix"):
            self._blocks_host = ldu.host_blocks(self.sparsity, m, self.np_dtype)
            self._coo_host_cache = None
            self._n = m.n
        nb = len(self._blocks_host)
        if first or self.matrix is None or cfg.regenerate:
            self._coeff_epoch += 1
            self._blocks_prev = [np.array(blk) for blk in self._blocks_host]
            self._blocks_dev = [None] * nb
            self._blocks_stale = [False] * nb
            self._blocks_mirror = [None] * nb
            self.last_blocks_changed = (nb, nb)
            with self._timed("convert_format"):
                self.matrix = self._convert(self.coo_host())
                if not cfg.regenerate:
                    # leave the raw blocks resident: later steps upload
                    # only the blocks whose values change.  No bfloat16
                    # mirror yet: the reference stages its blocks at the
                    # first steady step, so that step sends its changed
                    # blocks at full width, exact, and so does this one
                    self._stage_blocks(range(nb))
                    self._blocks_mirror = [None] * nb
            self.route = _route(cfg, self.matrix)
            # "ir" (GKOMultigrid) keeps the plan of the AMG loop's outer
            # formats for its device loop, and so does "cg" with Multigrid;
            # "bicgstab" and "cg" where their loop kernel takes the solve
            # (why_not None)
            why_not = {"bicgstab": bicgstab_why_not, "cg": cg_why_not}.get(self.route)
            amg_outer = self.route == "ir" or (self.route == "cg"
                                               and cfg.precond.name == "Multigrid")
            if self.route in ("cg_fused", "cg_pipe_fused", "bicgstab_fused"):
                self.kern = self._kernel_plan()
            elif amg_outer:
                self.kern = self._amg_outer_plan(self.route == "ir")
            elif why_not is not None and why_not(self.matrix, cfg.precond.name,
                                                 cfg.precond.max_block_size) is None:
                # the general loops' plan: a gather format's own, else the merged one
                plan = _GATHER_PLANS.get(type(self.matrix))
                self.kern = (plan.for_matrix(self.matrix) if plan is not None
                             else self._kernel_plan())
            else:
                self.kern = None
            return
        # steady state (the reference's ogl_tpu/foam/solver.py:306-354):
        # upload the changed raw blocks, then one launch of the value-update
        # kernel writes their entries into a fresh copy of the container's
        # values (the solve's plans take the values from the container at
        # each call, so the new container is all they need)
        if self._value_map is None:
            self._init_update_plans()
        with self._timed("update_device_values"):
            changed = self._detect_changed_blocks()
            if changed:
                partial = self._block_plans is not None and len(changed) < nb
                self.matrix = self._apply_block_updates(changed if partial else range(nb),
                                                        partial)
            else:  # no block changed: the container's values are current
                self.last_blocks_uploaded = (0, nb)
                self.last_blocks_bf16 = (0, nb)
                self.last_upload_bytes = 0
        if changed:
            self._coeff_epoch += 1

    def _init_update_plans(self) -> None:
        """The first steady step's set-up: the value map of the container,
        and from it the per-block plans (or, where slots take several
        entries, the slot-sorted plan of the whole update), over the entry
        -> source-position map the reference's full path applies
        (sparsity.permute composed with the renumbering's entry order)."""
        c = self.coo_host()
        self._value_map = formats.value_map(self.matrix, c.rows, c.cols)
        if isinstance(self.matrix, (Gdia, Xell)):
            # the value map holds what the host layout was kept for
            self.matrix = dataclasses.replace(self.matrix, layout=None)
        perm2 = self.sparsity.permute.astype(np.int64)
        if self._reorder is not None:
            perm2 = perm2[self._reorder[4]]
        self._block_plans = formats.block_update_plans(
            self._value_map, perm2, [blk.size for blk in self._blocks_host], self.device)
        if self._block_plans is None:
            self._acc_plan = formats.accumulate_plan(self._value_map, perm2, self.device)

    def _apply_block_updates(self, indices, partial: bool):
        """Stage the blocks `indices` and write their entries (the
        reference's `_apply_block_updates`, and its full path where
        `partial` is false) in one launch of the value-update kernel: a
        partial change into a copy of the current values, the blocks' plans
        (an affine plan is one contiguous run, a symmetric upper block's
        plan reads its positions twice); every block into zeros, each by its
        plan, or, where slots take several entries, all entries by the
        slot-sorted plan, each slot summed in entry order."""
        staged = self._stage_blocks(indices)
        sources = [staged[i] for i in indices]
        vm = self._value_map
        if partial:
            flat = formats.fresh_values(self.matrix)
        else:
            flat = torch.zeros(int(np.prod(vm.out_shape)), dtype=self.dtype,
                               device=self.device)
        value_update(flat, sources, self.update_writes(indices))
        for i, (_, _, out) in zip(indices, sources):
            if out is not None:  # the decoded copy is the block's resident copy now
                self._blocks_dev[i] = out
        return formats.with_values(self.matrix, flat.view(vm.out_shape))

    def update_writes(self, indices) -> list:
        """The value-update writes of the blocks `indices` (in that order, as
        the kernel's sources): each block's plan, or the slot-sorted plan's
        one write over all blocks where the map has no per-block plans."""
        scale = float(self.cfg.scaling)
        if self._block_plans is None:
            return [self._acc_plan.write(block=-1, scale=scale)]
        return [self._block_plans[i].write(block=k, scale=scale)
                for k, i in enumerate(indices)]

    def _delta_tol(self) -> float:
        """uploadDeltaTol, or by default 1e-5 capped at tolerance/10 and
        relTol/10: the solve converges against the compressed operands, so a
        looser delta would let finalResidual overstate the accuracy."""
        tol = self.cfg.upload_delta_tol
        if tol is None:
            tol = 1e-5
            st = self.cfg.stopping
            if st.tolerance > 0.0:
                tol = min(tol, st.tolerance / 10.0)
            if st.rel_tol > 0.0:
                tol = min(tol, st.rel_tol / 10.0)
        return tol

    def _bf16_delta(self, new_f32: np.ndarray, mirror):
        """Error-feedback bfloat16 delta encoding (uploadPrecision bfloat16;
        the reference's `_bf16_delta`, ogl_tpu/foam/solver.py:369-405):
        quantise new − mirror to bfloat16, rounding to nearest even, and
        advance the mirror by the same quantised value the device adds, so
        the host mirror and the device copy stay bit-equal and the
        quantisation error never accumulates.  Returns (delta as a bfloat16
        CPU tensor, new mirror), or None when the remaining error would
        exceed the delta tolerance of the block's magnitude (a full-width
        upload instead)."""
        if mirror is None or mirror.shape != new_f32.shape:
            return None
        if not new_f32.size:
            return torch.zeros(0, dtype=torch.bfloat16), mirror.copy()
        # torch's CPU ops, on all cores, with three buffers: the same float32
        # roundings as the reference's numpy, a few times faster at 1M+
        new, old = torch.from_numpy(new_f32), torch.from_numpy(mirror)
        delta = new - old
        dbf = delta.to(torch.bfloat16)
        mirror2 = dbf.float().add_(old)
        lo, hi = torch.aminmax(new)
        ref = max(float(hi), -float(lo))
        lo, hi = torch.aminmax(torch.sub(new, mirror2, out=delta))
        err = max(float(hi), -float(lo))
        if ref > 0.0 and err > self._delta_tol() * ref:
            return None
        return dbf, mirror2.numpy()

    def _detect_changed_blocks(self) -> list:
        """Host-side per-block change detection against the previous step's
        values; marks changed blocks' device copies stale and returns their
        indices (np.array_equal stops at the first difference)."""
        changed = []
        for i, blk in enumerate(self._blocks_host):
            prev = self._blocks_prev[i]
            if prev.shape == blk.shape and np.array_equal(prev, blk):
                continue
            changed.append(i)
            self._blocks_stale[i] = True
            # private copy: a caller mutating its LDU arrays in place must
            # not alias the compare baseline (into the old one's buffer)
            if prev.shape == blk.shape:
                np.copyto(prev, blk)
            else:
                self._blocks_prev[i] = np.array(blk)
        self.last_blocks_changed = (len(changed), len(self._blocks_host))
        return changed

    def _stage_blocks(self, indices) -> dict:
        """Upload each requested block whose device copy is missing or stale;
        resident-and-current blocks never cross to the device, and blocks
        not requested stay as they are.  Under uploadPrecision bfloat16 a
        changed resident block crosses as a bfloat16 delta (_bf16_delta),
        which the value-update kernel decodes.  Returns {index: (resident
        copy, delta or None, buffer for the decoded copy or None)}, the
        value-update kernel's sources."""
        compress = self.cfg.upload_precision == "bfloat16"
        staged = {}
        uploaded = bf16 = nbytes = 0
        for i in indices:
            blk = self._blocks_host[i]
            dev = self._blocks_dev[i]
            if dev is not None and not self._blocks_stale[i]:
                staged[i] = (dev, None, None)
                continue
            enc = (self._bf16_delta(np.asarray(blk, np.float32), self._blocks_mirror[i])
                   if compress and dev is not None else None)
            if enc is not None:
                dbf, self._blocks_mirror[i] = enc
                staged[i] = (dev, dbf.to(self.device), torch.empty_like(dev))
                bf16 += 1
                nbytes += dbf.numel() * dbf.element_size()
            else:
                dev = self._blocks_dev[i] = torch.tensor(blk, device=self.device)
                if compress:
                    self._blocks_mirror[i] = np.array(blk, np.float32)
                staged[i] = (dev, None, None)
                nbytes += blk.nbytes
            self._blocks_stale[i] = False
            uploaded += 1
        nb = len(self._blocks_host)
        self.last_blocks_uploaded = (uploaded, nb)
        self.last_blocks_bf16 = (bf16, nb)
        self.last_upload_bytes = nbytes
        return staged

    def coo_host(self) -> formats.Coo:
        """Host-side COO of the CURRENT coefficients (lazy row-major
        gather, for format conversion and preconditioner setup)."""
        if self._coo_host_cache is None:
            blocks = self._blocks_host
            src = np.concatenate(blocks) if len(blocks) > 1 else blocks[0]
            vals = src[self.sparsity.permute]
            if self.cfg.scaling != 1.0:
                vals = vals * np.asarray(self.cfg.scaling, vals.dtype)
            if self._reorder is not None:
                _, _, rows, cols, entry_order = self._reorder
                vals = vals[entry_order]
            else:
                rows, cols = self.sparsity.rows, self.sparsity.cols
            self._coo_host_cache = formats.Coo(rows=rows, cols=cols, vals=vals,
                                               shape=(self._n, self._n))
        return self._coo_host_cache

    # -- preconditioner (TTL caching, Preconditioner.H:353-431) ---------
    def _update_precond(self):
        pc = self.cfg.precond
        amg_solver = self.cfg.solver == "GKOMultigrid" and pc.name == "none"
        if pc.name == "none" and not amg_solver:
            self._precond_op = None
            return
        if self._precond_op is not None and self._pc_built_epoch == self._coeff_epoch:
            # operator coefficients unchanged since the last build: the
            # rebuild would be identical, so skip it (TTL frozen too)
            return
        if self._precond_op is not None and self.props.precond_caching_left > 0:
            self.props.precond_caching_left -= 1
            return
        with self._timed("generate_preconditioner"):
            if amg_solver:  # AMG as the solver: Richardson around its cycle
                self._precond_op = precond.amg_of(pc, self.coo_host(), self.device)
            else:
                self._precond_op = precond.build(pc, self.coo_host(), self.device,
                                                 verbose=self.cfg.verbose)
        self._pc_built_epoch = self._coeff_epoch
        self.props.precond_caching_left = pc.caching

    # -- right-hand side --------------------------------------------------
    def _update_rhs(self, b) -> torch.Tensor:
        if not self.cfg.update_rhs and self._b_dev is not None:
            self.last_rhs_uploaded = False
            return self._b_dev
        b_host = np.asarray(b)
        if self._reorder is not None:
            b_host = b_host[self._reorder[0]]
        if self.cfg.scaling != 1.0:
            # the RHS scales with the matrix (lduLduBase.H:244-252), so the
            # solution is invariant under `scaling`
            b_host = b_host * np.asarray(self.cfg.scaling, self.np_dtype)
        b_host = np.asarray(b_host, self.np_dtype)
        if (self._b_prev is not None and self._b_prev.shape == b_host.shape
                and np.array_equal(self._b_prev, b_host)):
            self.last_rhs_uploaded = False  # unchanged RHS stays resident
            return self._b_dev
        compress = self.cfg.upload_precision == "bfloat16"
        enc = (self._bf16_delta(b_host, self._b_mirror)
               if compress and self._b_dev is not None else None)
        if enc is not None:
            # the delta decoded by the value-update kernel: an identity plan
            # from the resident b (read with the delta) into a new b
            dbf, self._b_mirror = enc
            old = self._b_dev
            self._b_dev = torch.empty_like(old)
            value_update(self._b_dev, [(old, dbf.to(self.device), None)],
                         [Write(block=0, src=None, dest=None, seg=None, start=0,
                                items=old.numel(), scale=1.0)])
        else:
            self._b_dev = torch.tensor(b_host, device=self.device)
            if compress:
                self._b_mirror = np.array(b_host)
        self.last_rhs_bf16 = enc is not None
        self._b_prev = np.array(b_host)
        self.last_rhs_uploaded = True
        return self._b_dev

    # -- solve ----------------------------------------------------------
    def _route_call(self, n: int, b_dev, x0, params, apply_pc):
        """The solve of this solver's route over its resident matrix,
        preconditioner, b and x0, as a closure: no upload, no host set-up."""
        route, mat, kern = self.route, self.matrix, self.kern
        # invd for scalar Jacobi; a blocked BJ's state is its transposed
        # inverses, inv_t, which only the general BiCGStab's loop kernel takes
        bj = self.cfg.precond.name == "BJ"
        scalar_bj = bj and _diag_pc(self.cfg)
        invd = self._precond_op.state if scalar_bj else None
        inv_t = self._precond_op.state if bj and not scalar_bj else None
        general = {"cg": cg, "cg_pipe": cg_pipelined, "bicgstab": bicgstab}
        multigrid = self.cfg.precond.name == "Multigrid"
        basis = torch.bfloat16 if self.cfg.basis_precision == "bfloat16" else None

        def run():
            if route == "ir" and kern is None:  # GKOMultigrid off Dia
                return ir(single_device_ops(spmv.matvec(mat), n, precond=apply_pc), b_dev, x0,
                          params)
            if route == "gmres":
                ops = single_device_ops(spmv.matvec(mat), n, precond=apply_pc)
                return gmres(ops, b_dev, x0, params, self.cfg.krylov_dim, basis)
            if route in general:
                ops = single_device_ops(spmv.matvec(mat), n, precond=apply_pc)
                if kern is not None:  # "bicgstab" or "cg" with its loop kernel's plan
                    data = kern.pack_values(mat)
                    if route == "bicgstab":
                        return bicgstab(ops, b_dev, x0, params, kern, data, invd, inv_t)
                    if route == "cg" and multigrid:  # the AMG loop's outer plan
                        return cg(ops, b_dev, x0, params, kern, data, precond=apply_pc)
                    return general[route](ops, b_dev, x0, params, kern, data, invd)
                return general[route](ops, b_dev, x0, params)
            data = kern.pack_values(mat)
            if route == "cg_fused":
                return cg_fused(kern, data, b_dev, x0, params, invd=invd,
                                precond=apply_pc if invd is None else None)
            if route == "cg_pipe_fused":
                return cg_pipelined_fused(kern, data, b_dev, x0, params, invd=invd)
            if route == "ir":
                return ir_fused(kern, data, b_dev, x0, params, apply_pc)
            return bicgstab_fused(kern, data, b_dev, x0, params)
        return run

    def time_device_solve(self, reps: int = 3) -> float:
        """Wall seconds of ONE re-run of the last solve on its resident
        device state — the same route, matrix, preconditioner, b, x0 and
        stopping parameters, with no coefficient or RHS upload and no host
        set-up — ended by torch.cuda.synchronize() on the card; the best of
        `reps`.  The 'solve' term of a step's split with the uploads taken
        out (the reference's pure solver->apply timing, lduLduBase.H:267-276;
        ogl_tpu/foam/solver.py:809-835)."""
        if self._redispatch is None:
            raise RuntimeError("no solve has run yet")

        def run():
            self._redispatch()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        run()  # settle any queued work
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return best

    def solve(self, m: ldu.LduMatrix, b, psi=None, time_value: str | None = None
              ) -> tuple[Any, SolverPerformance]:
        """One solve: returns (x, SolverPerformance), x a tensor on the
        solver's device.  `psi` is the initial guess (used when
        updateInitGuess).  `time_value` is accepted for interface parity
        (it only names export directories, which are not ported)."""
        cfg = self.cfg
        first = self.sparsity is None
        self._update_matrix(m)
        if cfg.verbose > 0 and first:  # names the format the matrix took
            print(f"OGL-TPU (PyTorch port {_version})\n"
                  f"  torch:         {torch.__version__}\n"
                  f"  device:        {self._device_name()}\n"
                  f"  matrix format: {formats.format_name(self.matrix)}\n"
                  f"  dtype:         {cfg.dtype}\n"
                  f"  executor:      {cfg.executor}")
        self._update_precond()
        b_dev = self._update_rhs(b)
        if psi is not None and cfg.update_init_guess:
            psi_host = np.asarray(psi, self.np_dtype)
            if self._reorder is not None:
                psi_host = psi_host[self._reorder[0]]
            x0 = torch.tensor(psi_host, device=self.device)
        else:
            x0 = torch.zeros_like(b_dev)

        stopping_cfg = cfg.stopping.adapted(
            self.props.prev_solve_iters, self.props.prev_rel_res_cost, cfg.export)
        if cfg.verbose > 0 and stopping_cfg is not cfg.stopping:
            common.log(cfg.verbose, 0,
                       f"stopping criterion minIter {stopping_cfg.min_iter} "
                       f"frequency {stopping_cfg.frequency}")
        params = stopping.StoppingParams.of(stopping_cfg)
        # the op itself (callable as r -> z): the AMG routes read its
        # hierarchy and settings for the device V-cycle
        apply_pc = self._precond_op

        self._redispatch = self._route_call(m.n, b_dev, x0, params, apply_pc)
        with self._timed("solve"):
            res = self._redispatch()
            # one batched fetch of the stats, inside the timed region
            init_rn, final_rn, conv = torch.stack([
                res.init_res_norm.double(), res.final_res_norm.double(),
                res.converged.double()]).tolist()
        solve_t = self.timings["solve"]
        self.last_timings = dict(self.timings)
        self.timings.clear()
        iters = res.iters

        # the criterion's per-check cost, measured on every solve as OGL
        # does; the measurement's own wall time shows in the step's split
        t0 = time.perf_counter()
        self._res_eval_time = _res_eval_seconds(
            spmv.matvec(self.matrix), res.x, b_dev, self.device)
        self.last_timings["res_eval"] = time.perf_counter() - t0
        time_per_iter = solve_t / max(iters, 1)
        self.props.prev_rel_res_cost = time_per_iter / self._res_eval_time
        self.props.prev_solve_iters = iters
        self.props.init_residual = init_rn
        self.props.final_residual = final_rn

        if cfg.verbose > 0:
            # copy-back bandwidth (reference times dist_x.copy_back(),
            # lduLduBase.H:277-281)
            t0 = time.perf_counter()
            res.x.cpu()
            copy_t = max(time.perf_counter() - t0, 1e-9)
            print(
                "\nStatistics:\n"
                f"\tTime per iteration: {time_per_iter * 1e6:.3f} [mu s]\n"
                f"\tTime per residual norm calculation: {self._res_eval_time * 1e6:.3f} [mu s]\n"
                f"\tTime per iteration and DOF: {time_per_iter * 1e9 / m.n:.3f} [ns]\n"
                f"\tRetrieve results bandwidth "
                f"{4 * m.n / copy_t / 1e9:.3g} [GByte/s]"
            )

        perf = SolverPerformance(
            solver_name=f"{cfg.solver}_{formats.format_name(self.matrix)}",
            field_name=self.field,
            initial_residual=init_rn,
            final_residual=final_rn,
            n_iterations=iters,
            converged=bool(conv),
        )
        if self._reorder is not None:  # back to the caller's numbering
            return res.x[self._inv_dev], perf
        return res.x, perf

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"


def solve(field_name: str, m: ldu.LduMatrix, b, controls: dict | SolverConfig, psi=None):
    """Functional entry: get-or-create the per-field FoamSolver from the
    registry (the objectRegistry pattern) and run one solve."""
    solver = registry.global_registry.get_or_init(
        f"{field_name}_solver", lambda: FoamSolver(field_name, controls))
    return solver.solve(m, b, psi=psi)

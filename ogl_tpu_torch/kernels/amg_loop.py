"""The AMG solves with the V-cycle on the device: GKOCG + Multigrid and
GKOMultigrid as ONE persistent cooperative CUDA kernel per solve
(`csrc/amg_loop.cuh`, built from `amg_loop.cu` and
`amg_loop_{gdia,ell,csr}_{cg,ir}.cu`), its level table, and its plain
twins.

Counterpart: ogl_tpu/solve/cg_fused.py with `precond_framed` (the merged
PCG whose `jax.lax.while_loop` body runs the cycle, :94-123), ogl_tpu/solve/
cg.py (:93, the general CG's loop with the same cycle), ogl_tpu/solve/ir.py
(the Richardson loop, :50-64) and the cycle of ogl_tpu/precond/amg.py
(:471-545).  The reference runs each as one device program; the port's
host loops (solve/cg_fused.py, solve/cg.py, solve/ir.py over precond/amg.py
`cycle_op`) launch some fifty kernels per iteration, which this loop
replaces.

  amg_cg_loop   the merged CG of solve/cg_fused.py with z = M r: K1, K2n,
                the check, the V-cycle and ρ = Σ r·z per iteration
  amg_ir_loop   the Richardson loop of solve/ir.py: the check, the V-cycle
                with x += z in its last sweep, r' = r − A z and ‖r'‖₁

The outer operator is the plan's: Dia (`CgKernels`), Gdia
(`GdiaCgKernels`), Ell and Hybrid (`EllCgKernels`), Csr and the device Coo
(`CsrCgKernels`) — OUTER_PLANS, the exact types (a subclass that overrides
a step keeps the host loop); the Dia outer's variants take hierarchies of
Dia levels only, as a structured grid coarsens.  A hierarchy `qualifies`
when its cycle is
`v` with at least one smoother sweep, it has two to MAX_LEVELS levels,
every smoothing level is Dia (≤ 64 offsets), Gdia (≤ 64 planes) or Ell,
its transfers are `grid` or `natural` (no `pgm` aggregate table), the
coarsest level has a dense inverse (`coarseSolver direct`) and every
smoothing level packs its coefficients in one of SMOOTHER_DTYPES.  The
others — `aggregation pgm`, `cycle w`/`f`, `coarseSolver cg`,
`smootherSweeps 0`, a one-level hierarchy — the outer plans of other
formats (Xell, Sell) and a Dia outer over Gdia or Ell levels keep the
host-launched cycle, chosen by that predicate (`why_not`), never by
catching an error.

The level table (`LevelTable`) is built once per hierarchy, at the first
loop solve, and kept on the AmgOp (`op.loop_table`): per level its
pointers (smoother coefficients, offsets or plane offsets, 1/diag, two x
buffers, one b buffer, the dense inverse, Gdia lanes or Ell columns and
warp slots), sizes, format, an Ell level's staging (`ell_stage_slots`),
transfer kind and grid dims, as FIELDS int64 words on the device, and the
dynamic shared memory its staged Ell levels need (`smem`).  Its scratch
buffers are allocated with it.  A changed operator under `caching 0`
rebuilds the hierarchy, hence a new op and a new table: no table outlives
the tensors it points to.

Dispatch, as every wrapper of the port: tensors on the CPU run the plain
twin; CUDA tensors launch the kernel or raise (wrong device, dtype, shape,
a hierarchy or plan that does not qualify, a refused cooperative launch —
whose error is cleared); there is no fallback.  Each launch counts in
`ogl_tpu_torch.kernels.launches` ("amg_cg_loop", "amg_ir_loop").
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Dia, Ell
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import (MAX_DIAGS, check_scalar, dia_spmv_plain, on_cpu,
                                            require_cuda, stream_of)
from ogl_tpu_torch.kernels.ell import EllCgKernels
from ogl_tpu_torch.kernels.fused import (LOOP_THREADS, SMOOTHER_DTYPES, CgKernels,
                                         GdiaCgKernels, _read_record, k2n_plain)
from ogl_tpu_torch.kernels.gather_loop import CsrCgKernels
from ogl_tpu_torch.kernels.gdia import Gdia
from ogl_tpu_torch.precond.amg import AmgOp, _prolong, _resid, _restrict, _sweep

__all__ = ["qualifies", "why_not", "takes_loop", "LevelTable", "table_of", "loop_blocks",
           "vcycle_plain", "amg_cg_loop_plain", "amg_ir_loop_plain", "amg_cg_loop",
           "amg_ir_loop", "outer_words", "ell_stage_slots", "MAX_LEVELS", "FIELDS", "VARIANT_BF16",
           "VARIANT_IR", "OUTER_PLANS", "OUTER_BITS"]

MAX_LEVELS = 12  # csrc/amg_loop.cuh kMaxLevels
FIELDS = 24  # int64 words per level in the table (csrc/amg_loop.cuh kFields)
VARIANT_BF16, VARIANT_IR = 1, 2  # the kernel's variant bits
KIND_GRID, KIND_NATURAL, KIND_COARSE = 0, 1, 2  # a level's transfer to the next
FMT_DIA, FMT_GDIA, FMT_ELL = 0, 1, 2  # a level's format
# the outer plans the loop takes, by exact type, and their variant bits
OUTER_BITS = {CgKernels: 0, GdiaCgKernels: 4, EllCgKernels: 8, CsrCgKernels: 16}
OUTER_PLANS = tuple(OUTER_BITS)
# the staged Ell body (csrc/amg_stage.cuh): at most STAGE_SLOTS slots a chunk
# (kEllSlots), two buffers a warp within WARP_STAGE_BYTES, 48 KB a block of
# LOOP_THREADS; twice that (16 slots) ran slower, its shared memory taking
# L1 from the other phases (PERF.md rows 27-28)
STAGE_SLOTS = 8
WARP_STAGE_BYTES = 3072


def ell_stage_slots(n: int, width: int, dtype: torch.dtype) -> int:
    """Slots per staged chunk of an Ell level of n rows, K = width, values
    of `dtype`: at most K and STAGE_SLOTS, the warp's two buffers of that
    many slots (32 rows of a column and a value each) within
    WARP_STAGE_BYTES; 0 (the register body) where a group's copies would not
    be whole multiples of 16 bytes (n % 4, in bfloat16 n % 8)."""
    vb = torch.empty((), dtype=dtype).element_size()
    if width < 1 or n % (16 // vb):
        return 0
    return min(width, STAGE_SLOTS, WARP_STAGE_BYTES // (2 * 32 * (4 + vb)))

_grids: dict = {}  # (device index, variant, smem) -> co-resident blocks


def why_not(op, kern=None) -> str | None:
    """Why the device loop does not take the preconditioner `op` (which
    then keeps the host-launched cycle) — with `kern`, also on that outer
    plan — or None when it qualifies."""
    if not isinstance(op, AmgOp):
        return "not an AMG cycle"
    if op.cycle != "v":
        return f"cycle {op.cycle}"
    if op.smooth_iters < 1:
        return "smootherSweeps 0"
    levels = op.state
    if len(levels) < 2:
        return "a one-level hierarchy"
    if len(levels) > MAX_LEVELS:
        return f"{len(levels)} levels (more than {MAX_LEVELS})"
    if levels[-1].coarse_inv is None:
        return "coarseSolver cg (no dense coarse inverse)"
    dtypes = {lv.data_s.dtype for lv in levels[:-1]}
    if len(dtypes) != 1 or not dtypes <= set(SMOOTHER_DTYPES):
        return f"smoother coefficients of types {sorted(map(str, dtypes))}"
    for i, lv in enumerate(levels):
        if lv.n >= 1 << 31:
            return f"level {i} has {lv.n} rows"
        if lv is levels[-1]:
            continue
        if lv.grid is None and not lv.natural:
            return "aggregation pgm (an aggregate table, not a grid or natural transfer)"
        m = lv.mat
        if isinstance(m, Dia) and len(m.offsets) > MAX_DIAGS:
            return f"level {i} is a Dia operator of more than {MAX_DIAGS} diagonals"
        if isinstance(m, Gdia) and len(m.plane_offsets) > MAX_DIAGS:
            return f"level {i} is a Gdia operator of more than {MAX_DIAGS} planes"
        if not isinstance(m, (Dia, Gdia, Ell)):
            return f"level {i} is a {type(m).__name__} operator"
    if kern is not None and type(kern) not in OUTER_PLANS:
        return (f"the outer plan {type(kern).__name__}: the loop has no K1 phase for its "
                "format (Dia, Gdia, Ell and Hybrid, Csr and Coo only)")
    if type(kern) is CgKernels and not all(isinstance(lv.mat, Dia) for lv in levels[:-1]):
        return ("a Dia outer over Gdia or Ell levels (the Dia outer's variants hold Dia "
                "levels only)")
    return None


def qualifies(op, kern=None) -> bool:
    """True when the device loop takes the preconditioner `op` (on the
    outer plan `kern`, when given)."""
    return why_not(op, kern) is None


def takes_loop(kern, op, t: torch.Tensor) -> bool:
    """The routes' predicate: an outer plan of OUTER_PLANS itself (not a
    subclass that overrides a step), a CUDA tensor and a hierarchy that
    qualifies."""
    return (op is not None and type(kern) in OUTER_PLANS and t.device.type == "cuda"
            and why_not(op, kern) is None)


def _aligned(t: torch.Tensor | None, nbytes: int = 16) -> bool:
    return t is None or t.data_ptr() % nbytes == 0


class LevelTable:
    """The device loop's view of one hierarchy: `table`, an (levels,
    FIELDS) int64 tensor on the levels' device (csrc/amg_loop.cuh `Level`:
    coefficients, offsets — Dia diagonals or Gdia plane offsets —, nd — Dia
    diagonals, Gdia planes or Ell slots K —, n, 1/diag, x buffers a and b,
    b, the dense inverse, transfer kind, natural width, the grid dims of the
    level and of the next, whether a Dia level's rows go by quads (on the
    coarsest level: whether the dense product takes float4 loads), format,
    Gdia lanes or Ell columns, Ell warp slots, Gdia block rows, and an Ell
    level's slots per staged chunk, 0 for the register body), the scratch
    buffers it points to, and `smem`, the dynamic shared memory the staged
    Ell levels need (the largest).  The smoothing levels' coefficients, offsets, lanes, columns and 1/diag are
    the levels' own tensors, kept alive by the AmgOp that holds the table."""

    def __init__(self, levels):
        self.device = levels[0].inv_diag.device
        self.n_levels = len(levels)
        bf16 = levels[0].data_s is not None and levels[0].data_s.dtype == torch.bfloat16
        self.variant = VARIANT_BF16 if bf16 else 0
        self.scratch = []
        self.smem = 0
        rows = []
        for i, lv in enumerate(levels):
            last = i == len(levels) - 1
            empty = functools.partial(torch.empty, lv.n, dtype=torch.float32, device=self.device)
            xa, xb = (None, None) if last else (empty(), empty())
            b = empty() if i > 0 else None
            self.scratch += [t for t in (xa, xb, b) if t is not None]
            if last:
                kind, width, dims = KIND_COARSE, 0, (0,) * 6
            elif lv.grid is not None:
                kind, width, dims = KIND_GRID, 0, lv.grid
            else:
                kind, width, dims = KIND_NATURAL, lv.width, (0,) * 6
            coef = None if last else lv.data_s
            if last:  # the coarse product's float4 loads of inv and b
                vec = lv.n % 4 == 0 and _aligned(lv.coarse_inv) and _aligned(b)
            else:
                vec = (lv.n % 4 == 0 and _aligned(coef, coef.element_size() * 4)
                       and all(_aligned(t) for t in (lv.inv_diag, xa, xb, b)))
            fmt, offs, nd, aux, ws, rws, slots = self._format(lv, last)
            ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
            rows.append([ptr(coef), ptr(offs), nd, lv.n, lv.inv_diag.data_ptr(), ptr(xa),
                         ptr(xb), ptr(b), ptr(lv.coarse_inv), kind, width,
                         *(int(d) for d in dims), int(vec), fmt, ptr(aux), ptr(ws), rws, slots,
                         0])
        self.table = torch.tensor(rows, dtype=torch.int64, device=self.device)

    def _format(self, lv, last):
        """(format, offsets, nd, lanes or columns, warp slots, Gdia block rows,
        Ell slots per staged chunk) of level lv; a staged level's stages raise
        `smem`."""
        m = lv.mat
        if isinstance(m, Dia):
            return FMT_DIA, None if last else lv.kern.plan.offsets_dev, len(m.offsets), None, \
                None, 0, 0
        if isinstance(m, Gdia):
            if last:
                return FMT_GDIA, None, len(m.plane_offsets), None, None, 0, 0
            return (FMT_GDIA, lv.kern.gplan.offsets_dev, len(m.plane_offsets), m.lidx, None,
                    lv.kern.gplan.r, 0)
        if last:
            return FMT_ELL, None, m.row_width, None, None, 0, 0
        slots = 0
        if _aligned(m.cols) and _aligned(lv.data_s):
            slots = ell_stage_slots(lv.n, m.row_width, lv.data_s.dtype)
        vb = lv.data_s.element_size()
        self.smem = max(self.smem, (LOOP_THREADS // 32) * 2 * slots * 32 * (4 + vb))
        return FMT_ELL, None, m.row_width, m.cols, m.warp_slots, 0, slots


def table_of(op: AmgOp) -> LevelTable:
    """The level table of `op`'s hierarchy, built at the first call and
    kept on the op."""
    if op.loop_table is None:
        op.loop_table = LevelTable(op.state)
    return op.loop_table


def loop_blocks(variant: int, device: torch.device, smem: int = 0) -> int:
    """The co-resident blocks of LOOP_THREADS of the loop kernel's
    `variant` with `smem` bytes of dynamic shared memory on `device`
    (occupancy × SMs), queried once per variant, size and card; raises on a
    card without cooperative launch."""
    key = (device.index, variant, smem)
    if key not in _grids:
        blocks = ctypes.c_int64()
        with torch.cuda.device(device):
            _build.check(_build.library().ogl_amg_loop_grid(variant, LOOP_THREADS, smem,
                                                            ctypes.byref(blocks)),
                         "amg_loop (occupancy query)")
        _grids[key] = blocks.value
    return _grids[key]


# ---- plain PyTorch twins (CPU path, and the reference on the card) ------


def vcycle_plain(levels, r, relax: float, sweeps: int):
    """One V-cycle from a zero guess on b₀ = r over each level format's
    plain twins (precond/amg.py `_sweep`, `_resid` with `plain`): the
    zero-guess sweep, sweeps − 1 more, the residual restricted, the coarser
    level, the prolongation added, `sweeps` sweeps; the coarsest level
    coarse_inv @ b."""
    def level(i, b):
        lv = levels[i]
        if i == len(levels) - 1:
            return lv.coarse_inv @ b
        x = relax * lv.inv_diag * b
        for _ in range(sweeps - 1):
            x = _sweep(lv, x, b, relax, plain=True)
        x = x + _prolong(lv, level(i + 1, _restrict(lv, _resid(lv, x, b, plain=True))))
        for _ in range(sweeps):
            x = _sweep(lv, x, b, relax, plain=True)
        return x

    return level(0, r)


def amg_cg_loop_plain(k1, x, r, absr, nf, cfg, cycle):
    """The CG loop kernel's function: the merged CG of solve/cg_fused.py
    with a rich preconditioner, over the plan's K1 — `k1(z, p, β) -> (p',
    q, δ)` — k2n_plain and `cycle` (r -> z), from the set-up's x, r = b −
    A x, ‖r‖₁ and norm factor nf, with the criterion of solve/stopping.py
    (cfg: StoppingParams) read on the host at each check.  The cycle runs
    after the check that would stop (the kernel's order): a converged pass
    leaves before it, with the host loop's iterate and count.  x and r are
    updated in place; returns (iterations, final and initial normalised
    residual, converged) — an int and three 0-d tensors."""
    from ogl_tpu_torch.solve import stopping  # not at the top: solve imports this module

    st = stopping.init_state(x.dtype, x.device).replace(norm_factor=nf)
    p, rho_old, zero = torch.zeros_like(x), torch.ones_like(nf), torch.zeros_like(nf)
    z = rho = None
    while st.iter < cfg.max_iter + cfg.frequency:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        if z is None:
            z = cycle(r)
            rho = torch.sum(r * z)
        beta = zero if st.iter == 0 else rho / rho_old
        p, q, delta = k1(z, p, beta)
        alpha, rho_old = rho / delta, rho
        absr = k2n_plain(alpha, x, r, p, q)
        z = None
        st = st.replace(iter=st.iter + 1)
    return st.iter, st.res_norm, st.init_res_norm, stopping.satisfied(cfg, st)


def amg_ir_loop_plain(apply, x, r, absr, nf, cfg, cycle):
    """The Richardson loop kernel's function: solve/ir.py over `cycle` (r ->
    z) and the float32 fine operator `apply` (v -> A v), from the set-up's
    x, r = b − A x, ‖r‖₁ and norm factor nf: per iteration the check, z =
    cycle(r), x += z, r −= A z.  x and r are updated in place; returns
    (iterations, final and initial normalised residual, converged)."""
    from ogl_tpu_torch.solve import stopping  # not at the top: solve imports this module

    st = stopping.init_state(x.dtype, x.device).replace(norm_factor=nf)
    while st.iter < cfg.max_iter + cfg.frequency:
        st = stopping.check_from_norm(cfg, st, absr)
        if st.converged:
            break
        z = cycle(r)
        x += z
        torch.sub(r, apply(z), out=r)
        absr = torch.sum(torch.abs(r))
        st = st.replace(iter=st.iter + 1)
    return st.iter, st.res_norm, st.init_res_norm, stopping.satisfied(cfg, st)


# ---- the wrappers -----------------------------------------------------------


def _plain_cycle(op: AmgOp):
    return functools.partial(vcycle_plain, op.state, relax=op.relax, sweeps=op.smooth_iters)


def _require(op, kern, what: str) -> None:
    why = why_not(op, kern)
    if why is not None:
        raise ValueError(f"{what}: the device loop does not take this preconditioner ({why}); "
                         "it keeps the host-launched cycle")


def _fine_apply(kern, data):
    """v -> A v on the outer operator by its plain twin (CPU tensors): the
    Dia SpMV's, or the plan's SpMV (the format's twin on the CPU)."""
    if type(kern) is CgKernels:
        return functools.partial(dia_spmv_plain, data, kern.offsets)
    return functools.partial(kern.spmv, data)


def amg_cg_loop(kern, data, op: AmgOp, x, r, absr, nf, cfg):
    """GKOCG + Multigrid from the set-up's state (solve/cg_fused.py,
    solve/cg.py): x and r = b − A x on kern's operator (a plan of
    OUTER_PLANS, data its pack_values), updated in place; ‖r‖₁ and the norm
    factor as 0-d tensors; op the qualifying AmgOp; cfg the StoppingParams.
    One cooperative launch on the card (the set-up's z = M r₀ inside it),
    then one host read of its record; returns (iterations, final and initial
    normalised residual, converged) — an int and three 0-d CPU tensors."""
    _require(op, kern, "amg_cg_loop")
    if on_cpu(*_tensors(data), x, r, absr, nf):
        return amg_cg_loop_plain(functools.partial(kern.k1, data), x, r, absr, nf, cfg,
                                 _plain_cycle(op))
    return _launch("amg_cg_loop", kern, data, op, x, r, absr, nf, cfg)


def amg_ir_loop(kern, data, op: AmgOp, x, r, absr, nf, cfg):
    """GKOMultigrid from the set-up's state (solve/ir.py), as amg_cg_loop:
    Richardson around the V-cycle."""
    _require(op, kern, "amg_ir_loop")
    if on_cpu(*_tensors(data), x, r, absr, nf):
        return amg_ir_loop_plain(_fine_apply(kern, data), x, r, absr, nf, cfg, _plain_cycle(op))
    return _launch("amg_ir_loop", kern, data, op, x, r, absr, nf, cfg)


def _tensors(data) -> tuple:
    """The tensors of a plan's packed values (a tensor, or a tuple holding
    tensors and None)."""
    items = data if isinstance(data, tuple) else (data,)
    return tuple(t for t in items if t is not None)


def outer_words(kern, data, vectors) -> tuple[int, list[int]]:
    """(outer variant bits, the 8 int64 words of the outer operator) of a
    launch on plan `kern` with packed values `data`, after checking both and
    `vectors` against the plan (csrc/amg_loop.cu `ogl_amg_loop`'s `outer`)."""
    bits = OUTER_BITS[type(kern)]
    if type(kern) in (CgKernels, GdiaCgKernels):
        _, (coef, lidx, offsets, nd, rows) = kern._loop_apply(data, vectors)
        return bits, [coef, lidx or 0, offsets, nd, rows, 0, 0, 0]
    ptrs = [p or 0 for p in kern._operands(type(kern).__name__, data, vectors)]
    if type(kern) is EllCgKernels:  # cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals
        cols, vals, ws, tp, tc, tv = ptrs
        return bits, [vals, cols, ws, 0, 0, tp, tc, tv]
    row_ptr, cols, vals = ptrs
    return bits, [vals, cols, row_ptr, 0, 0, 0, 0, 0]


def _launch(name, kern, data, op, x, r, absr, nf, cfg, lib=None):
    """One launch of the loop kernel through `lib` (the package's library
    when None); returns the record read."""
    require_cuda(name, x)
    bits, words = outer_words(kern, data, (x, r))
    for what, sc in (("absr", absr), ("nf", nf)):
        check_scalar(what, sc, kern.device)
    tab = table_of(op)
    if tab.device != kern.device:
        raise ValueError(f"{name}: the hierarchy is on {tab.device}, the plan on {kern.device}")
    ir = name == "amg_ir_loop"
    variant = tab.variant | (VARIANT_IR if ir else 0) | bits
    if lib is None:
        blocks = loop_blocks(variant, kern.device, tab.smem)
    else:
        grid = ctypes.c_int64()
        _build.check(lib.ogl_amg_loop_grid(variant, LOOP_THREADS, tab.smem, ctypes.byref(grid)),
                     f"{name} (occupancy query)")
        blocks = grid.value
    blocks = min(blocks, -(-kern.n // LOOP_THREADS))
    z = torch.empty_like(x)
    p, pn, q = ((None,) * 3 if ir else
                (torch.zeros_like(x), torch.empty_like(x), torch.empty_like(x)))
    partials = torch.empty(3 * blocks, dtype=torch.float32, device=kern.device)
    record = torch.empty(4, dtype=torch.float32, device=kern.device)
    vec = int(kern.n % 4 == 0 and words[0] % 16 == 0
              and all(_aligned(t) for t in (x, r, z, p, pn, q)))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    outer = (ctypes.c_int64 * 8)(*words)
    _build.check((lib or _build.library()).ogl_amg_loop(
        variant, tab.table.data_ptr(), tab.n_levels, outer, x.data_ptr(), r.data_ptr(),
        z.data_ptr(), ptr(p), ptr(pn), ptr(q), absr.data_ptr(), nf.data_ptr(),
        partials.data_ptr(), record.data_ptr(), kern.n, vec, op.relax, op.smooth_iters,
        cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter, cfg.frequency, LOOP_THREADS,
        blocks, tab.smem, stream_of(x)), name)
    if lib is None:
        kernels.launches[name] += 1
    return _read_record(record)

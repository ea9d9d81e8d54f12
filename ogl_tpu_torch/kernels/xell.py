"""Xell — crossed-gather ELL for fully unstructured sparsity: the
container, its host packing, the CUDA C++ kernels `csrc/xell.cu` (SpMV and
merged-CG K1, both with the spill tail in-kernel, over the band body
`csrc/xell_band.cuh`) and their plain PyTorch twins, and the merged-CG plan
`XellCgKernels`, whose whole CG loop with identity or scalar Jacobi
preconditioning is one launch of `csrc/xell_cg_loop.cu` on the card, and
whose general-BiCGStab loop one launch of `csrc/bicgstab_gen_loop.cu`'s Xell
variants.

Counterpart: ogl_tpu/kernels/xell.py (`Xell`, `XellLayout`,
`xell_layout`, `xell_from_coo`, `xell_to_coo`, `spmv_xell`, `xell_matvec`,
`XellCgKernels`, and the Pallas `_xell_kernel`, `_spill_corr`,
`_k1x_kernel`).  The numpy packing is the reference's, carried over
unchanged.

Layout.  Vectors viewed as (R, 128): block a = row // 128, residue
b = row % 128.  Destinations are cut into tiles of 128 block rows.  Per
tile and slot k:
  vals[tile, k, t, l]  float32 value for destination row (tile·128 + t)·128 + l
  ll[tile, k, t, l]    int8 source residue b
  bbT[tile, k, b, t]   int16 source block, window-relative, stored in the
                       transposed (residue, t) order and indexed by the
                       SOURCE residue b = ll, not by l
so the source column is (tile·128 + bbT[tile, k, ll, t] − c_left·128)·128
+ ll.  Entries beyond the slot cap go to a COO spill tail, stored after the
main slots in input order (the value map writes them there).  Unused slots
hold value 0 and indices 0; the TPU gathers them from a zero-padded window,
the port masks any source outside [0, n).

The spill is applied inside the kernels from a per-destination-row CSR
(`SpillCsr`: row_ptr, cols, and a gather index into spill.vals), built once
per container sparsity in `xell_from_coo` — never per apply — and carried
over by every value update, which replaces only spill.vals: the new
coefficients flow through the gather index.  It takes the place of the
reference's per-tile `SpillTables` and one-hot MXU matmuls, which are TPU
mechanics; the MXU transposes of the crossed gather are too: the GPU
gathers x[col] directly.

Both kernels, and the loop's K1 phase, walk bands of BAND_ROWS destination
rows (16 consecutive block rows t of one tile): the standalone kernels one
block per band (`band_grid`), the loop kernel bands block, block + blocks,
... on its co-resident grid (`band_walk`).

Dispatch, as for every wrapper of the port: CPU tensors run the plain
version; CUDA tensors launch the kernel or raise.  Each launch counts in
`ogl_tpu_torch.kernels.launches` (`xell_spmv`, `xell_k1`, `xell_cg_loop`,
`bicgstab_gen_loop`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Coo
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import check_scalar, on_cpu, require_cuda, stream_of
from ogl_tpu_torch.kernels.fused import (LOOP_JACOBI, LOOP_THREADS, LOOP_XELL, CgKernels, _ptr,
                                         _read_record, bicgstab_gen_loop_plain, cg_loop_plain,
                                         gen_loop_precond, gen_loop_preconditioner)

LANES = 128
TB = 128  # block rows per destination tile
BAND_ROWS = 16 * LANES  # destination rows of a band (csrc/xell_band.cuh kBandRows)

__all__ = ["Xell", "XellLayout", "SpillCsr", "XellPlan", "XellCgKernels",
           "xell_layout", "xell_from_coo", "xell_to_coo", "spill_csr",
           "xell_spmv_plain", "xell_k1_plain", "xell_spmv", "xell_k1",
           "xell_matvec", "spmv_xell", "band_grid", "band_origin", "band_walk"]


@dataclasses.dataclass(frozen=True)
class XellLayout:
    """Deterministic packing of a sparsity pattern (pure function of
    rows/cols/n — shared by `xell_from_coo` and the value map, so the
    steady-state value update cannot drift from the container)."""

    n_slots: int
    c_chunks: int
    c_left: int
    n_tiles: int
    dest: np.ndarray        # per entry (input order): flat slot in the
    #                         concat(vals.ravel(), spill_vals) value space
    spill_sel: np.ndarray   # bool per entry: landed in the COO spill
    bb_pos: np.ndarray      # main entries: flat position in bbT
    bb_val: np.ndarray      # main entries: int16 window-relative block
    ll_val: np.ndarray      # main entries: int8 source lane


@dataclasses.dataclass(frozen=True)
class SpillCsr:
    """The spill tail per destination row, on the container's device:
    entries of row i are s in [row_ptr[i], row_ptr[i+1]), with source
    column cols[s] and value spill.vals[gidx[s]]; rows[s] is the same row
    index expanded (for the plain version).  All int32."""

    row_ptr: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    gidx: torch.Tensor

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])


@dataclasses.dataclass(frozen=True)
class Xell:
    """vals/ll: (nt, K, 128, 128) float32 / int8; bbT: (nt, K, 128, 128)
    int16 in (residue, t) order; spill: Coo tail whose fields are tensors
    on the same device; spill_csr: its per-row CSR.  `layout` keeps the
    host packing of the first conversion so that the value map need not
    recompute it (host numpy; not part of the matrix's identity)."""

    vals: torch.Tensor
    ll: torch.Tensor
    bbT: torch.Tensor
    spill: Coo
    spill_csr: SpillCsr
    c_left: int
    c_chunks: int
    shape: tuple[int, int]
    layout: XellLayout | None = dataclasses.field(default=None, compare=False,
                                                  repr=False)

    @property
    def n_slots(self) -> int:
        return int(self.vals.shape[1])


def xell_layout(rows, cols, n: int, k_max: int = 32,
                spill_frac: float = 0.002, c_max: int = 6,
                force_slots: int | None = None,
                force_c_left: int | None = None,
                force_c_chunks: int | None = None) -> XellLayout:
    """First-fit greedy slot assignment (a bipartite edge colouring), fully
    vectorised: one pre-sort by destination row, then one O(nnz) pass per
    slot.  Raises when the window span exceeds `c_max` chunks (renumber
    with core.reorder.rcm_permutation) or when more than 20% of entries
    would spill.  force_* pin the data-dependent statics to externally
    agreed values (>= this pattern's own needs)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    nnz = len(rows)
    nb = max(math.ceil(n / LANES), 1)
    nt = max(math.ceil(nb / TB), 1)

    a_d, l_d = rows // LANES, rows % LANES
    a_s, b_s = cols // LANES, cols % LANES
    tile, t_in = a_d // TB, a_d % TB
    wrel = a_s - tile * TB
    c_left = int(max(0, math.ceil(-min(wrel.min(), 0) / 128))) if nnz else 0
    if force_c_left is not None:
        if force_c_left < c_left:
            raise ValueError(
                f"force_c_left={force_c_left} < required {c_left}")
        c_left = force_c_left
    right_span = int(wrel.max()) + 1 if nnz else 1
    c_chunks = c_left + max(math.ceil(right_span / 128), 1)
    if force_c_chunks is not None:
        if force_c_chunks < c_chunks:
            raise ValueError(
                f"force_c_chunks={force_c_chunks} < required {c_chunks}")
        c_chunks = force_c_chunks
    if c_chunks > c_max:
        raise ValueError(
            f"Xell window needs {c_chunks} chunks (> {c_max}): matrix "
            f"bandwidth too large — renumber (core.reorder.rcm_permutation) "
            "or raise c_max")
    wloc = (wrel + c_left * 128).astype(np.int16)

    # greedy rounds: per round take the first unassigned entry of every
    # destination row, then keep only one source block per (t, residue)
    slot = np.full(nnz, -1, np.int32)
    if nnz:
        po = np.argsort(rows, kind="stable")       # group by dest row
        pk = rows[po]
        new_grp = np.r_[True, pk[1:] != pk[:-1]]
        starts = np.flatnonzero(new_grp)
        inv_po = np.empty(nnz, np.int64)
        inv_po[po] = np.arange(nnz)
        tb_key = a_d * LANES + b_s                  # (tile, t, residue)
        alive = np.ones(nnz, bool)                  # po-order
        idx = np.arange(nnz)
        big = nnz
        target = max(int(spill_frac * nnz), 0)
        remaining = nnz
        for k in range(k_max):
            if remaining <= target:
                break
            first = np.minimum.reduceat(np.where(alive, idx, big), starts)
            first = first[first < big]
            cand = po[first]
            # among this round's candidates, one source block per
            # (t, residue) group — the leader's block wins; same-block
            # followers ride along (they occupy different dest rows)
            o2 = np.argsort(tb_key[cand], kind="stable")
            cs = cand[o2]
            tks = tb_key[cs]
            lead = np.r_[True, tks[1:] != tks[:-1]]
            grp = np.cumsum(lead) - 1
            lead_blk = a_s[cs[lead]][grp]
            chosen = cs[lead | (a_s[cs] == lead_blk)]
            slot[chosen] = k
            alive[inv_po[chosen]] = False
            remaining -= len(chosen)
        if remaining > max(target, int(0.2 * nnz)):
            raise ValueError(
                f"Xell packing left {remaining}/{nnz} entries after "
                f"{k_max} slots: sparsity too irregular for the TPU fast "
                "path (raise k_max or renumber)")

    k_used = int(slot.max()) + 1 if nnz else 0
    k_used = max(k_used, 1)
    if force_slots is not None:
        if force_slots < k_used:
            raise ValueError(f"force_slots={force_slots} < required {k_used}")
        k_used = force_slots
    main = slot >= 0
    main_size = nt * k_used * TB * LANES
    dest = np.empty(nnz, np.int64)
    dest[main] = (((tile[main] * k_used + slot[main]) * TB + t_in[main])
                  * LANES + l_d[main])
    n_spill = int((~main).sum())
    dest[~main] = main_size + np.arange(n_spill)
    bb_pos = (((tile[main] * k_used + slot[main]) * LANES + b_s[main])
              * TB + t_in[main])
    return XellLayout(
        n_slots=k_used, c_chunks=c_chunks, c_left=c_left, n_tiles=nt,
        dest=dest, spill_sel=~main, bb_pos=bb_pos, bb_val=wloc[main],
        ll_val=b_s[main].astype(np.int8))


def spill_csr(rows, cols, n: int, device) -> SpillCsr:
    """Per-destination-row CSR of the spill entries (rows/cols in spill
    order, the order of spill.vals): entries sorted by row, stably, with
    gidx pointing back into spill order."""
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])

    def t32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    return SpillCsr(row_ptr=t32(row_ptr), rows=t32(rows[order]),
                    cols=t32(np.asarray(cols, np.int64)[order]), gidx=t32(order))


def xell_from_coo(coo: Coo, k_max: int = 32, spill_frac: float = 0.002,
                  c_max: int = 6, device: torch.device | str = "cpu",
                  layout: XellLayout | None = None) -> Xell:
    """Host packing, uploaded to `device`.  `layout` reuses a packing of
    the same sparsity already computed (xell_layout is seconds at 1M)."""
    n = coo.shape[0]
    rows = np.asarray(coo.rows).astype(np.int64)
    cols = np.asarray(coo.cols).astype(np.int64)
    vals = np.asarray(coo.vals)
    lay = layout if layout is not None else xell_layout(
        rows, cols, n, k_max=k_max, spill_frac=spill_frac, c_max=c_max)
    nt, k = lay.n_tiles, lay.n_slots
    main_size = nt * k * TB * LANES
    v = np.zeros(main_size, vals.dtype)
    llv = np.zeros(main_size, np.int8)
    bbv = np.zeros(nt * k * LANES * TB, np.int16)
    main = ~lay.spill_sel
    v[lay.dest[main]] = vals[main]
    llv[lay.dest[main]] = lay.ll_val
    bbv[lay.bb_pos] = lay.bb_val
    sp = lay.spill_sel

    def up(a):
        return torch.tensor(a, device=device)

    spill = Coo(rows=up(rows[sp].astype(np.int32)), cols=up(cols[sp].astype(np.int32)),
                vals=up(vals[sp]), shape=tuple(coo.shape))
    return Xell(vals=up(v.reshape(nt, k, TB, LANES)), ll=up(llv.reshape(nt, k, TB, LANES)),
                bbT=up(bbv.reshape(nt, k, LANES, TB)), spill=spill,
                spill_csr=spill_csr(rows[sp], cols[sp], n, device),
                c_left=lay.c_left, c_chunks=lay.c_chunks, shape=tuple(coo.shape),
                layout=lay)


def xell_to_coo(m: Xell) -> Coo:
    """Host-side structural inverse (tests/export): occupancy is recovered
    as (val != 0) | (source lane != 0), so a stored entry whose
    coefficient is exactly 0.0 with source lane 0 reads as padding."""
    nt, k = int(m.vals.shape[0]), int(m.vals.shape[1])
    vals = m.vals.cpu().numpy()
    ll = m.ll.cpu().numpy().astype(np.int64)
    bbT = m.bbT.cpu().numpy().astype(np.int64)
    occupied = (vals != 0) | (ll != 0)
    sl, t, l = np.nonzero(occupied.reshape(nt * k, TB, LANES))
    tile = sl // k
    rows = (tile * TB + t) * LANES + l
    b = ll.reshape(nt * k, TB, LANES)[sl, t, l]
    wblk = bbT.reshape(nt * k, LANES, TB)[sl, b, t]
    cols = (tile * TB + wblk - m.c_left * 128) * LANES + b
    out_v = vals.reshape(nt * k, TB, LANES)[sl, t, l]
    rows = np.concatenate([rows, m.spill.rows.cpu().numpy().astype(np.int64)])
    cols = np.concatenate([cols, m.spill.cols.cpu().numpy().astype(np.int64)])
    out_v = np.concatenate([out_v, m.spill.vals.cpu().numpy()])
    order = np.lexsort((cols, rows))
    return Coo(rows=rows[order].astype(np.int32), cols=cols[order].astype(np.int32),
               vals=out_v[order], shape=m.shape)


class XellPlan:
    """Static structure of an Xell matrix on one device: n, the tile and
    slot counts, c_left, and the spill CSR (index tables only — the spill
    values travel with the coefficients)."""

    def __init__(self, n: int, n_tiles: int, n_slots: int, c_left: int,
                 spill: SpillCsr):
        self.n = int(n)
        self.n_tiles = int(n_tiles)
        self.n_slots = int(n_slots)
        self.c_left = int(c_left)
        self.spill = spill
        self.device = spill.row_ptr.device

    @classmethod
    def of(cls, m: Xell) -> "XellPlan":
        return cls(m.shape[0], m.vals.shape[0], m.n_slots, m.c_left, m.spill_csr)

    @property
    def n_spill(self) -> int:
        return self.spill.nnz


# ---- plain PyTorch twins (CPU path, and the reference on the card) ------


def xell_spmv_plain(plan: XellPlan, vals, ll, bbT, spill_vals, x):
    """y = A x: slot by slot over the main storage (sources outside [0, n)
    read 0), then the spill tail added per destination row."""
    n = plan.n
    nt, k = vals.shape[:2]
    dev = x.device
    tile = torch.arange(nt, device=dev).view(nt, 1, 1)
    b_all = ll.long()
    bb_nat = bbT.transpose(2, 3)  # (nt, K, t, residue)
    acc = torch.zeros((nt, TB, LANES), dtype=x.dtype, device=dev)
    for s in range(k):
        b = b_all[:, s]
        blk = torch.gather(bb_nat[:, s], 2, b).long()
        j = (tile * TB + blk - plan.c_left * 128) * LANES + b
        inb = (j >= 0) & (j < n)
        g = torch.where(inb, x[j.clamp(0, max(n - 1, 0))], torch.zeros((), dtype=x.dtype,
                                                                      device=dev))
        acc = acc + vals[:, s].to(x.dtype) * g
    y = acc.reshape(-1)[:n]
    sp = plan.spill
    if sp.nnz:
        prod = spill_vals.to(x.dtype)[sp.gidx.long()] * x[sp.cols.long()]
        y = y.index_add(0, sp.rows.long(), prod)
    return y


def xell_k1_plain(plan: XellPlan, vals, ll, bbT, spill_vals, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p' (spill included), δ = Σ p'·q."""
    pw = z + beta * p
    q = xell_spmv_plain(plan, vals, ll, bbT, spill_vals, pw)
    return pw, q, torch.sum(pw * q)


def spmv_xell(m: Xell, x):
    """Plain y = A x for an Xell container."""
    return xell_spmv_plain(XellPlan.of(m), m.vals, m.ll, m.bbT, m.spill.vals, x)


# ---- wrappers -------------------------------------------------------------


def _check(plan: XellPlan, vals, ll, bbT, spill_vals, *vectors) -> None:
    main = (plan.n_tiles, plan.n_slots, TB, LANES)
    checks = [("vals", vals, main, torch.float32), ("ll", ll, main, torch.int8),
              ("bbT", bbT, main, torch.int16),
              ("spill vals", spill_vals, (plan.n_spill,), torch.float32)]
    checks += [(f"vector {i}", v, (plan.n,), torch.float32) for i, v in enumerate(vectors)]
    for name, t, want, dtype in checks:
        if t.device != plan.device:
            raise ValueError(f"{name} is on {t.device}, the plan on {plan.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernels take {dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _spill_args(plan: XellPlan, spill_vals) -> tuple:
    """The spill pointers of a launch; NULL row_ptr tells the kernel there
    is no spill."""
    sp = plan.spill
    if not sp.nnz:
        return (None, None, None, None)
    return (sp.row_ptr.data_ptr(), sp.cols.data_ptr(), sp.gidx.data_ptr(),
            spill_vals.data_ptr())


def band_grid(n: int) -> int:
    """Bands of an n-row matrix, and blocks of the standalone SpMV and K1:
    one per band of BAND_ROWS destination rows (16 consecutive block rows t
    of one tile), the last one ragged."""
    return -(-n // BAND_ROWS)


def band_origin(band: int) -> tuple[int, int]:
    """(tile, first block row t0 within it) of `band`, as the band body
    decodes it (csrc/xell_band.cuh `band_apply`); its rows are
    (tile·TB + t0)·LANES + [0, BAND_ROWS) = band·BAND_ROWS + [0, BAND_ROWS)."""
    return band >> 3, (band & 7) * (BAND_ROWS // LANES)


def band_walk(block: int, blocks: int, n: int) -> range:
    """The bands block `block` of a grid of `blocks` walks in the loop
    kernel's K1 phase (csrc/xell_cg_loop.cu), in order."""
    return range(block, band_grid(n), blocks)


def xell_spmv(plan: XellPlan, vals, ll, bbT, spill_vals, x):
    """y = A x for the Xell matrix (plan, vals, ll, bbT, spill_vals)."""
    if on_cpu(vals, ll, bbT, spill_vals, x):
        return xell_spmv_plain(plan, vals, ll, bbT, spill_vals, x)
    require_cuda("xell_spmv", x)
    _check(plan, vals, ll, bbT, spill_vals, x)
    lib = _build.library()
    y = torch.empty_like(x)
    _build.check(lib.ogl_xell_spmv(
        vals.data_ptr(), ll.data_ptr(), bbT.data_ptr(), plan.n_slots, plan.c_left,
        *_spill_args(plan, spill_vals), x.data_ptr(), y.data_ptr(), plan.n,
        band_grid(plan.n), stream_of(x)), "xell_spmv")
    kernels.launches["xell_spmv"] += 1
    return y


def xell_k1(plan: XellPlan, vals, ll, bbT, spill_vals, z, p, beta):
    """Merged-CG K1 on an Xell matrix, spill in-kernel: (p', q, δ), p' and
    q in new buffers, δ a 0-d tensor."""
    if on_cpu(vals, ll, bbT, spill_vals, z, p, beta):
        return xell_k1_plain(plan, vals, ll, bbT, spill_vals, z, p, beta)
    require_cuda("xell_k1", z)
    _check(plan, vals, ll, bbT, spill_vals, z, p)
    check_scalar("beta", beta, plan.device)
    lib = _build.library()
    pout = torch.empty_like(p)
    q = torch.empty_like(p)
    bands = band_grid(plan.n)
    partials = torch.empty(bands, dtype=torch.float32, device=plan.device)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (z, p, pout, q)))
    _build.check(lib.ogl_xell_k1(
        vals.data_ptr(), ll.data_ptr(), bbT.data_ptr(), plan.n_slots, plan.c_left,
        *_spill_args(plan, spill_vals), z.data_ptr(), p.data_ptr(), beta.data_ptr(),
        pout.data_ptr(), q.data_ptr(), partials.data_ptr(), plan.n, vec, bands,
        stream_of(z)), "xell_k1")
    kernels.launches["xell_k1"] += 1
    return pout, q, torch.sum(partials)


def xell_matvec(m: Xell):
    """`x -> A @ x`: the Xell SpMV kernel (spill in-kernel) for CUDA
    tensors, the plain version for CPU tensors."""
    plan = XellPlan.of(m)
    vals, ll, bbT, sv = m.vals, m.ll, m.bbT, m.spill.vals
    return lambda x: xell_spmv(plan, vals, ll, bbT, sv, x)


class XellCgKernels:
    """Merged-CG steps for one Xell sparsity on one device: K1 is the Xell
    kernel with the spill in-kernel (so q and δ include it); K2, K2i and
    K2n are the structure-free kernels of a CgKernels delegate, as
    the reference delegates them; the whole CG loop with identity or
    scalar Jacobi preconditioning is one launch of `csrc/xell_cg_loop.cu`
    (`cg_loop`), the general BiCGStab's one launch of
    `csrc/bicgstab_gen_loop.cu` (`bicgstab_gen_loop`).  Vectors are flat
    (n,): the reference's `frame`/`unframe` are dropped."""

    def __init__(self, plan: XellPlan):
        self.plan = plan
        self.n = plan.n
        self.device = plan.device
        self.dtype = torch.float32
        self.offsets = ()  # no stencil
        self._d = CgKernels(plan.n, (), plan.device)
        self._zero = torch.zeros((), dtype=self.dtype, device=self.device)
        self._loop_blocks: dict = {}
        self._gen_loop_blocks: dict = {}

    @classmethod
    def for_matrix(cls, mat: Xell) -> "XellCgKernels":
        return cls(XellPlan.of(mat))

    def pack_values(self, mat: Xell) -> tuple:
        """(vals, ll, bbT, spill vals) as the kernels take them."""
        if (tuple(mat.vals.shape[:2]), mat.c_left) != (
                (self.plan.n_tiles, self.plan.n_slots), self.plan.c_left):
            raise ValueError("matrix packing does not match this plan")
        return (mat.vals.contiguous(), mat.ll, mat.bbT, mat.spill.vals.contiguous())

    def k1(self, data, z, p, beta):
        return xell_k1(self.plan, *data, z, p, beta)

    def spmv(self, data, x):
        return xell_spmv(self.plan, *data, x)

    def apply(self, data, x):
        """Plain y = A x through K1 (z = p = x, β = 0)."""
        _, q, _ = self.k1(data, x, x, self._zero)
        return q

    def k2(self, alpha, x, r, p, q, invd, z):
        return self._d.k2(alpha, x, r, p, q, invd, z)

    def k2i(self, alpha, x, r, p, q):
        return self._d.k2i(alpha, x, r, p, q)

    def k2n(self, alpha, x, r, p, q):
        return self._d.k2n(alpha, x, r, p, q)

    # ---- the whole merged CG loop (CUDA C++) -----------------------------
    def loop_blocks(self, variant: int = 0) -> int:
        """The co-resident blocks of LOOP_THREADS of the Xell loop kernel's
        `variant` (0 or LOOP_JACOBI) with its shared-memory ring on this
        plan's card (occupancy × SMs), queried once per variant; raises on
        a card without cooperative launch."""
        return self._d._coop_blocks("xell_cg_loop", self._loop_blocks, variant)

    def cg_loop(self, data, x, r, rho, absr, nf, cfg, invd=None, z=None):
        """The merged CG loop from the set-up's state (solve/cg_fused.py), as
        CgKernels.cg_loop: x and r (and, with Jacobi, z = invd ⊙ r), updated
        in place; ρ = Σ r·z (Σ r·r with identity: invd and z None), ‖r‖₁ and
        the norm factor as 0-d tensors; cfg the StoppingParams.  One
        cooperative launch on the card (csrc/xell_cg_loop.cu), then one host
        read of its record; CPU tensors run the twin `cg_loop_plain` over
        this plan's K1.  Returns (iterations, final and initial normalised
        residual, converged) — an int and three 0-d tensors (CPU tensors
        from the card's record)."""
        if (invd is None) != (z is None):
            raise ValueError("cg_loop: invd and z come together (Jacobi) or not at all")
        if on_cpu(*data, x, r, rho, absr, nf, invd, z):
            return cg_loop_plain(functools.partial(self.k1, data), x, r, rho, absr, nf, cfg,
                                 invd, z)
        require_cuda("xell_cg_loop", x)
        jacobi = invd is not None
        vectors = (x, r, z, invd) if jacobi else (x, r)
        vals, ll, bbT, spill_vals = data
        _check(self.plan, vals, ll, bbT, spill_vals, *vectors)
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        variant = LOOP_JACOBI if jacobi else 0
        blocks = min(self.loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, pn, q = torch.zeros_like(x), torch.empty_like(x), torch.empty_like(x)
        partials = torch.empty(3 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(self.n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                          for t in (*vectors, p, pn, q)))
        _build.check(_build.library().ogl_xell_cg_loop(
            variant, vals.data_ptr(), ll.data_ptr(), bbT.data_ptr(), self.plan.n_slots,
            self.plan.c_left, *_spill_args(self.plan, spill_vals), x.data_ptr(), r.data_ptr(),
            z.data_ptr() if jacobi else None, invd.data_ptr() if jacobi else None,
            p.data_ptr(), pn.data_ptr(), q.data_ptr(), rho.data_ptr(), absr.data_ptr(),
            nf.data_ptr(), partials.data_ptr(), record.data_ptr(), self.n, cfg.tolerance,
            cfg.rel_tol, cfg.min_iter, cfg.max_iter, cfg.frequency, vec, LOOP_THREADS, blocks,
            stream_of(x)), "xell_cg_loop")
        kernels.launches["xell_cg_loop"] += 1
        return _read_record(record)

    # ---- the general BiCGStab: the whole loop (CUDA C++) ------------------
    def gen_loop_blocks(self, variant: int = LOOP_XELL) -> int:
        """loop_blocks for the general-BiCGStab loop kernel's Xell variants
        (LOOP_XELL, with LOOP_JACOBI, LOOP_BLOCK_JACOBI or neither)."""
        return self._d._coop_blocks("bicgstab_gen_loop", self._gen_loop_blocks, variant)

    def bicgstab_gen_loop(self, data, x, r, rhat, rho, absr, nf, cfg, invd=None, inv_t=None):
        """The general BiCGStab loop of solve/bicgstab.py, as
        CgKernels.bicgstab_gen_loop: one cooperative launch of the loop
        kernel's Xell variant on the card (its two SpMV phases the band body
        over this plan; with inv_t its block-Jacobi phases), then one host
        read of its record; CPU tensors run the twin
        `bicgstab_gen_loop_plain` over this plan's SpMV."""
        pc = gen_loop_precond(x, invd, inv_t)
        if on_cpu(*data, x, r, rhat, rho, absr, nf, invd, inv_t):
            from ogl_tpu_torch.solve.krylov import single_device_ops  # solve imports this module
            ops = single_device_ops(functools.partial(self.spmv, data), self.n, precond=pc)
            return bicgstab_gen_loop_plain(ops, x, r, rhat, rho, absr, nf, cfg)
        require_cuda("bicgstab_gen_loop", x)
        vectors = (x, r, rhat) if invd is None else (x, r, rhat, invd)
        vals, ll, bbT, spill_vals = data
        _check(self.plan, vals, ll, bbT, spill_vals, *vectors)
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        bits, pc_ptr, bs, y, z = gen_loop_preconditioner(x, invd, inv_t)
        variant = LOOP_XELL | bits
        blocks = min(self.gen_loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, v = torch.zeros_like(x), torch.zeros_like(x)
        pn, vn, s, t = (torch.empty_like(x) for _ in range(4))
        partials = torch.empty(5 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(all(u.data_ptr() % 16 == 0 for u in (*vectors, p, pn, v, vn, s, t, y, z)
                      if u is not None))
        _build.check(_build.library().ogl_bicgstab_gen_loop_xell(
            variant, vals.data_ptr(), ll.data_ptr(), bbT.data_ptr(), self.plan.n_slots,
            self.plan.c_left, *_spill_args(self.plan, spill_vals),
            pc_ptr, bs, rhat.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(), pn.data_ptr(),
            v.data_ptr(), vn.data_ptr(), s.data_ptr(), t.data_ptr(), _ptr(y), _ptr(z),
            rho.data_ptr(), absr.data_ptr(), nf.data_ptr(), partials.data_ptr(),
            record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter,
            cfg.frequency, vec, LOOP_THREADS, blocks, stream_of(x)), "bicgstab_gen_loop")
        kernels.launches["bicgstab_gen_loop"] += 1
        return _read_record(record)
